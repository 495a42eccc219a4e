"""The port's attention (K5 and the chunked path) on the CPU against the
JAX package's.

On the CPU ``repro_torch.kernels.ops.flash_attention`` runs K5's plain
version (the wrapper was handed a CPU tensor). It is held against the
Pallas kernel in interpret mode (``repro.kernels.ops.flash_attention(
impl="pallas")``, as ``tests/test_kernels.py`` runs it) and against the
reference's dense oracle, on the same numpy inputs: f32, all three fold
in f32, so they agree to 1e-5. The chunked path (the reference's
``impl="xla"``) rounds its PV product to bf16, so it is held to its own
reference at 1e-5 and to the f32 oracle at 1e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch import kernels as tkernels
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.models import attention as tattn

torch.set_num_threads(1)

# f32 inputs, f32 folds on both sides: a few ulps of O(1) outputs
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(rng, b, hq, hkv, lq, lk, dh, bias, masked_head=0):
    q = rng.normal(size=(b, hq, lq, dh)).astype(np.float32)
    k = rng.normal(size=(b, hkv, lk, dh)).astype(np.float32)
    v = rng.normal(size=(b, hkv, lk, dh)).astype(np.float32)
    kb = None
    if bias:
        kb = rng.normal(size=(b, hkv, lk)).astype(np.float32)
        kb[..., :masked_head] = -1e30  # masked prototypes / unwritten slots
    return q, k, v, kb


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


CASES = [
    # b, hq, hkv, lq, lk, dh, causal, bias, softcap
    (2, 4, 2, 5, 9, 16, True, True, 50.0),      # GQA, causal with lq < lk
    (1, 8, 4, 1, 37, 256, False, True, 50.0),   # decode shape, head_dim 256
    (2, 4, 4, 8, 8, 16, True, False, 0.0),      # MHA, square causal
    (1, 4, 1, 130, 200, 64, True, True, 50.0),  # one kv head, ragged tiles
    (1, 2, 1, 1, 129, 16, False, False, 30.0),  # decode without bias
    (1, 8, 4, 33, 33, 256, True, False, 50.0),  # prefill, head_dim 256
]


@pytest.mark.parametrize("b,hq,hkv,lq,lk,dh,causal,bias,cap", CASES)
def test_k5_plain_matches_pallas_and_reference(rng, b, hq, hkv, lq, lk, dh,
                                               causal, bias, cap):
    q, k, v, kb = _inputs(rng, b, hq, hkv, lq, lk, dh, bias, masked_head=3)
    kw = dict(causal=causal, scale=1.0 / 16, logit_softcap=cap)
    pallas = np.asarray(jops.flash_attention(_j(q), _j(k), _j(v), kv_bias=_j(kb),
                                             impl="pallas", **kw))
    oracle = np.asarray(jops.flash_attention(_j(q), _j(k), _j(v), kv_bias=_j(kb),
                                             impl="ref", **kw))
    got = ops.flash_attention(_t(q), _t(k), _t(v), kv_bias=_t(kb), **kw).numpy()
    assert got.shape == q.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)


def test_k5_bias_per_query_head_and_default_scale(rng):
    """A bias with hq heads is used per query head; the scale defaults to
    1/sqrt(dh)."""
    b, hq, hkv, lq, lk, dh = 1, 4, 2, 3, 11, 16
    q, k, v, _ = _inputs(rng, b, hq, hkv, lq, lk, dh, False)
    kb = rng.normal(size=(b, hq, lk)).astype(np.float32)
    want = np.asarray(jops.flash_attention(_j(q), _j(k), _j(v), kv_bias=_j(kb),
                                           impl="pallas"))
    got = flash_attention(_t(q), _t(k), _t(v), _t(kb)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_k5_masked_first_tile_is_finite(rng):
    """Every key of the first 40 masked by a −1e30 bias (more than one kv
    tile of the kernel): the later real keys wipe what the masked ones
    added, with no NaN."""
    q, k, v, kb = _inputs(rng, 1, 2, 1, 1, 90, 16, True, masked_head=40)
    got = flash_attention_plain(_t(q), _t(k), _t(v), _t(kb), causal=False)
    want = flash_attention_plain(_t(q), _t(k)[:, :, 40:], _t(v)[:, :, 40:],
                                 _t(kb)[:, :, 40:], causal=False)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_k5_bf16_returns_bf16(rng):
    q, k, v, kb = _inputs(rng, 1, 4, 2, 6, 10, 16, True)
    got = ops.flash_attention(_t(q).bfloat16(), _t(k).bfloat16(), _t(v).bfloat16(),
                              kv_bias=_t(kb), causal=True)
    assert got.dtype == torch.bfloat16
    want = ops.flash_attention(_t(q).bfloat16().float(), _t(k).bfloat16().float(),
                               _t(v).bfloat16().float(), kv_bias=_t(kb), causal=True)
    # one bf16 rounding of an O(1) output
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), rtol=8e-3, atol=8e-3)


def test_k5_cpu_tensor_runs_plain_and_counts_nothing(rng):
    q, k, v, kb = _inputs(rng, 1, 2, 2, 4, 4, 16, True)
    tkernels.reset_launch_counts()
    flash_attention(_t(q), _t(k), _t(v), _t(kb))
    ops.flash_attention(_t(q), _t(k), _t(v), kv_bias=_t(kb), impl="cuda")
    assert tkernels.launch_counts()["K5"] == 0


@pytest.mark.parametrize("shapes", [
    ((1, 3, 4, 16), (1, 2, 4, 16), None),          # kv heads do not divide
    ((1, 4, 4, 16), (1, 2, 4, 8), None),           # head_dim differs
    ((1, 4, 4, 16), (1, 2, 4, 16), (1, 3, 4)),     # bias heads neither
    ((1, 2, 5, 16), (1, 2, 4, 16), None),          # causal, lq > lk
])
def test_k5_rejects_bad_shapes(shapes):
    qs, ks, bs = shapes
    with pytest.raises(ValueError):
        flash_attention(torch.zeros(qs), torch.zeros(ks), torch.zeros(ks),
                        None if bs is None else torch.zeros(bs))


@pytest.mark.parametrize("lq,lk,window,causal,bias,chunk", [
    (6, 6, 0, True, False, 4),     # prefill, chunks of 4 with a ragged tail
    (10, 10, 3, True, False, 4),   # local window: skipped chunks
    (1, 13, 0, False, True, 13),   # decode over the buffer with a bias
])
def test_chunked_attention_matches_reference(rng, lq, lk, window, causal, bias,
                                             chunk):
    q, k, v, kb = _inputs(rng, 2, 4, 2, lq, lk, 16, bias, masked_head=2)
    kw = dict(causal=causal, window=window, softcap=50.0, scale=0.25, chunk=chunk)
    want = np.asarray(jattn.chunked_attention(_j(q), _j(k), _j(v), kv_bias=_j(kb),
                                              **kw))
    got = tattn.chunked_attention(_t(q), _t(k), _t(v), kv_bias=_t(kb), **kw)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if window == 0:
        # the bf16 PV product keeps about three decimal digits
        oracle = np.asarray(jref.flash_attention(
            _j(q), jnp.repeat(_j(k), 2, axis=1), jnp.repeat(_j(v), 2, axis=1),
            causal=causal, scale=0.25, logit_softcap=50.0,
            kv_bias=None if kb is None else jnp.repeat(_j(kb), 2, axis=1)))
        np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("impl,window,flash", [
    ("auto", 0, True), ("cuda", 0, True), ("fused", 0, True),
    ("ref", 0, False), ("auto", 4, False),
])
def test_attend_routes_like_the_reference(rng, monkeypatch, impl, window, flash):
    """"auto"/"cuda" take K5 on windowless calls (the reference's
    impl="pallas"); "ref" and windowed prefill take the chunked path."""
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(tattn.ops, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    q, k, v, _ = _inputs(rng, 1, 2, 1, 5, 5, 16, False)
    tattn.attend(_t(q), _t(k), _t(v), causal=True, window=window, impl=impl)
    assert bool(calls) == flash
