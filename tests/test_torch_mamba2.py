"""The port's Mamba-2 SSD block (``repro_torch.models.mamba2``) on the CPU
against the JAX package's ``repro.models.mamba2``.

Bitwise: the depthwise causal conv in bf16 (four products summed in
order, then the bias, each step rounded to bf16, as the reference's
Python ``sum``), with and without a carried cache.

Within tolerance, in f32: ``segsum_exp`` and ``ssd_chunked`` to 1e-5 of
the largest magnitude (the port spells out the order of the reference's
three-operand einsums, so sums of up to 128 products fold in another
order), with a ragged tail, a sequence shorter than a chunk and a carried
initial state; ``softplus`` (the reference's ``logaddexp(x, 0)``, also
above 20, where ``F.softplus`` turns linear) to 1e-6 relative.

The whole block in bf16 (``mamba_apply``'s chunked prefill, then the
recurrent steps from its cache) with the reference's ``init_mamba``
parameters: outputs within 2^-5 of their largest magnitude (a few bf16
ulps: the projections and the gate norm round in bf16 on both sides), the
carried f32 state to 1e-4 of its largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import smoke_config as j_smoke_config
from repro.models import mamba2 as jm
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.models import mamba2

torch.set_num_threads(1)


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("l", [1, 5, 33])
@pytest.mark.parametrize("with_cache", [False, True])
def test_causal_conv_bitwise(rng, l, with_cache):
    x = rng.normal(size=(2, l, 40)).astype(np.float32)
    w = rng.normal(size=(4, 40)).astype(np.float32) * 0.5
    b = rng.normal(size=(40,)).astype(np.float32)
    c = rng.normal(size=(2, 3, 40)).astype(np.float32) if with_cache else None
    bf = jnp.bfloat16
    want, want_c = jm._causal_conv(jnp.asarray(x, bf), jnp.asarray(w, bf),
                                   jnp.asarray(b, bf),
                                   None if c is None else jnp.asarray(c, bf))
    t = lambda a: torch.from_numpy(a).bfloat16()  # noqa: E731
    got, got_c = mamba2.causal_conv(t(x), t(w), t(b), None if c is None else t(c))
    for g, wnt in ((got, want), (got_c, want_c)):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(wnt.astype(jnp.float32)))


def test_softplus_is_logaddexp(rng):
    x = np.concatenate([rng.normal(size=200) * 8, [-90.0, -30.0, 0.0, 19.9, 20.1,
                                                   35.0, 90.0]]).astype(np.float32)
    got = mamba2.softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-30)


@pytest.mark.parametrize("q,h", [(8, 3), (128, 4)])
def test_segsum_exp(rng, q, h):
    a = -np.abs(rng.normal(size=(2, 3, q, h))).astype(np.float32) * 0.2
    got = mamba2.segsum_exp(torch.from_numpy(a)).numpy()
    want = np.asarray(jm._segsum_exp(jnp.asarray(a)))
    assert got.shape == (2, 3, h, q, q)
    _close(got, want, 1e-5)
    assert (got[..., np.triu_indices(q, 1)[0], np.triu_indices(q, 1)[1]] == 0).all()


def _ssd_inputs(rng, b, l, h, p, n):
    x = rng.normal(size=(b, l, h, p)).astype(np.float32)
    a = -np.abs(rng.normal(size=(b, l, h))).astype(np.float32) * 0.1
    B = rng.normal(size=(b, l, n)).astype(np.float32)
    C = rng.normal(size=(b, l, n)).astype(np.float32)
    return x, a, B, C


@pytest.mark.parametrize("l,chunk", [(64, 16), (45, 16), (10, 16), (300, 128)])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked(rng, l, chunk, with_state):
    """Whole chunks, a ragged tail (45 = 2·16 + 13, 300 = 2·128 + 44), a
    sequence shorter than one chunk, with and without an initial state."""
    b, h, p, n = 2, 3, 4, 5
    x, a, B, C = _ssd_inputs(rng, b, l, h, p, n)
    s0 = rng.normal(size=(b, h, p, n)).astype(np.float32) if with_state else None
    want_y, want_s = jm.ssd_chunked(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(B), jnp.asarray(C),
        init_state=None if s0 is None else jnp.asarray(s0), chunk=chunk)
    y, s = mamba2.ssd_chunked(
        torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(B),
        torch.from_numpy(C), init_state=None if s0 is None else torch.from_numpy(s0),
        chunk=chunk)
    assert y.dtype == s.dtype == torch.float32
    _close(y.numpy(), want_y, 1e-5)
    _close(s.numpy(), want_s, 1e-5)


def test_ssd_chunked_equals_the_recurrence(rng):
    """The chunked scan against the token-by-token recurrence it stands
    for (s ← s·exp(a) + B ⊗ x, y = C · s), in f64 on the port alone."""
    b, l, h, p, n = 1, 37, 2, 3, 4
    x, a, B, C = (torch.from_numpy(v).double() for v in _ssd_inputs(rng, b, l, h, p, n))
    y, s_end = mamba2.ssd_chunked(x, a, B, C, chunk=8)
    s = torch.zeros((b, h, p, n), dtype=torch.float64)
    ys = []
    for t in range(l):
        s = s * torch.exp(a[:, t])[..., None, None] + x[:, t, :, :, None] * B[:, t, None, None, :]
        ys.append(torch.einsum("bn,bhpn->bhp", C[:, t], s))
    np.testing.assert_allclose(y.numpy(), torch.stack(ys, 1).float().numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s_end.numpy(), s.float().numpy(), rtol=1e-5, atol=1e-5)


def _block(arch="mamba2-370m", seed=0):
    jcfg, cfg = j_smoke_config(J_ARCHS[arch]), smoke_config(ARCHS[arch])
    params = jm.init_mamba(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    # non-trivial decay, skip, bias and gate-norm weights
    _, h, _, _ = jm._dims(jcfg)
    params = dict(params, A_log=jnp.asarray(rng.normal(size=h) * 0.5, jnp.float32),
                  D=jnp.asarray(rng.normal(size=h), jnp.float32),
                  dt_bias=jnp.asarray(rng.normal(size=h) - 1, jnp.float32),
                  conv_b=jnp.asarray(rng.normal(size=params["conv_b"].shape) * 0.1,
                                     jnp.float32),
                  norm=jnp.asarray(rng.normal(size=params["norm"].shape) * 0.1,
                                   jnp.float32))
    blk = mamba2.Mamba(cfg, device="cpu")
    with torch.no_grad():
        for name, v in params.items():
            w = getattr(blk, name)
            w.copy_(torch.from_numpy(np.array(v)).to(w.dtype))
    return jcfg, cfg, params, blk


@pytest.mark.parametrize("arch", ["mamba2-370m", "jamba-v0.1-52b"])
@pytest.mark.parametrize("s", [7, 40])
def test_mamba_apply_prefill_and_decode(rng, arch, s):
    """The block's chunked prefill from a zero cache, then 4 recurrent
    steps, against the reference (outputs and both cache entries); the
    stand-alone call (no cache) gives the prefill's output."""
    jcfg, cfg, params, blk = _block(arch)
    b, d = 2, cfg.d_model
    u = (rng.normal(size=(b, s + 4, d)) * 0.5).astype(np.float32)
    jc = jm.init_mamba_cache(jcfg, b, jnp.bfloat16)
    tc = mamba2.init_mamba_cache(cfg, b, device="cpu")
    for name in ("ssm", "conv"):
        assert tuple(tc[name].shape) == jc[name].shape
        assert str(tc[name].dtype).split(".")[-1] == str(jc[name].dtype)
    ub = jnp.asarray(u, jnp.bfloat16)
    tu = torch.from_numpy(u).bfloat16()
    with torch.no_grad():
        want, jc = jm.mamba_apply(params, ub[:, :s], jcfg, cache=jc)
        got, tc = mamba2.mamba_apply(blk, tu[:, :s], cfg, cache=tc)
        _close(got.float().numpy(), want.astype(jnp.float32), 2.0 ** -5)
        alone, none = mamba2.mamba_apply(blk, tu[:, :s], cfg)
        assert none is None
        np.testing.assert_array_equal(alone.float().numpy(), got.float().numpy())
        for i in range(s, s + 4):
            want, jc = jm.mamba_apply(params, ub[:, i:i + 1], jcfg, cache=jc)
            got, tc = mamba2.mamba_apply(blk, tu[:, i:i + 1], cfg, cache=tc)
            _close(got.float().numpy(), want.astype(jnp.float32), 2.0 ** -5)
    _close(tc["ssm"].numpy(), jc["ssm"], 1e-4)
    np.testing.assert_array_equal(tc["conv"].float().numpy(),
                                  np.asarray(jc["conv"].astype(jnp.float32)))


def test_decode_steps_continue_the_chunked_scan(rng):
    """The port alone: a chunked prefill of s tokens followed by recurrent
    steps gives the outputs of one chunked call over all of them (the
    state a chunked call leaves is the recurrence's)."""
    cfg = smoke_config(ARCHS["mamba2-370m"])
    _, _, _, blk = _block()
    u = torch.from_numpy((rng.normal(size=(2, 20, cfg.d_model)) * 0.5)
                         .astype(np.float32)).bfloat16()
    with torch.no_grad():
        full, _ = mamba2.mamba_apply(blk, u, cfg)
        c = mamba2.init_mamba_cache(cfg, 2, device="cpu")
        outs = []
        first, c = mamba2.mamba_apply(blk, u[:, :12], cfg, cache=c)
        outs.append(first)
        for i in range(12, 20):
            o, c = mamba2.mamba_apply(blk, u[:, i:i + 1], cfg, cache=c)
            outs.append(o)
    _close(torch.cat(outs, 1).float().numpy(), full.float().numpy(), 2.0 ** -5)
