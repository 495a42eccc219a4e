"""The port's MoE layer (``repro_torch.models.moe``) on the CPU against the
JAX package's ``repro.models.moe``.

Bitwise: the slot ranks of ``dispatch_indices`` (integers; invalid ids −1
and E, capacities that overflow, several groups), the top-k on
probabilities with exact ties (lowest index first, as ``lax.top_k``) and
the set of slots dropped for capacity.

Within tolerance: ``moe_apply``'s output and aux loss, with inputs and
router on a dyadic grid, so the router logits are exact in f32 and the
top-k is the same on both sides (exact ties break toward the lowest index
on both). The expert products run in bf16 on both sides and round in
other places: the output is held to 2^-6 of its largest magnitude (a few
bf16 ulps of the large entries). The aux loss (integer counts over T·k
times f32 mean probabilities) to 1e-6 relative.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import smoke_config as j_smoke_config
from repro.models import moe as jmoe
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.models import moe

sys.path.append(str(Path(__file__).resolve().parent.parent))
from chip_smoke import RoutingPin, _moe_drops  # noqa: E402

torch.set_num_threads(1)

MOE_ARCHS = ["deepseek-moe-16b", "llama4-scout-17b-a16e", "jamba-v0.1-52b"]


def _j_dispatch(ids: np.ndarray, e: int, c: int):
    flat, ok = jax.vmap(lambda x: jmoe._dispatch_indices(x, e, c))(jnp.asarray(ids))
    return np.asarray(flat), np.asarray(ok)


@pytest.mark.parametrize("groups,tk,e,cap", [
    (1, 48, 4, 6), (1, 48, 4, 100), (3, 40, 8, 2), (2, 7, 5, 1), (4, 64, 16, 3)])
def test_dispatch_indices_bitwise(rng, groups, tk, e, cap):
    """Ranks within each expert queue, ids −1 and E included (both point
    at the sink row E·C), capacities that drop slots and ones that do not."""
    ids = rng.integers(-1, e + 1, size=(groups, tk)).astype(np.int32)
    want_flat, want_ok = _j_dispatch(ids, e, cap)
    flat, ok = moe.dispatch_indices(torch.from_numpy(ids), e, cap)
    np.testing.assert_array_equal(flat.numpy(), want_flat)
    np.testing.assert_array_equal(ok.numpy(), want_ok)
    assert (flat.numpy()[~ok.numpy()] == e * cap).all()


@pytest.mark.parametrize("k", [1, 2, 6])
def test_top_k_breaks_ties_toward_the_lowest_index(rng, k):
    """Probabilities with exact ties: values and indices as lax.top_k."""
    probs = (rng.integers(0, 4, size=(64, 16)) / 8.0).astype(np.float32)
    probs[0] = 0.25  # every expert tied
    probs[1, ::2] = 0.5
    vals, idx = moe.top_k(torch.from_numpy(probs), k)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), k)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))


def _layer(arch, seed=0, **replace):
    import dataclasses

    jcfg = dataclasses.replace(j_smoke_config(J_ARCHS[arch]), **replace)
    cfg = dataclasses.replace(smoke_config(ARCHS[arch]), **replace)
    params = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    # a dyadic router (multiples of 1/8 in [-1, 1]): exact router logits
    params["router"] = jnp.asarray(
        rng.integers(-8, 9, size=params["router"].shape) / 8.0, jnp.float32)
    layer = moe.MoE(cfg, device="cpu")
    with torch.no_grad():
        for name in ("router", "gate", "up", "down"):
            w = getattr(layer, name)
            w.copy_(torch.from_numpy(np.array(params[name])).to(w.dtype))
        if cfg.n_shared_experts:
            for name, v in params["shared"].items():
                w = getattr(layer.shared, name)
                w.copy_(torch.from_numpy(np.array(v)).to(w.dtype))
    return jcfg, cfg, params, layer


def _dyadic_x(rng, shape):
    return (rng.integers(-8, 9, size=shape) / 8.0).astype(np.float32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("cf,groups", [(None, 1), (0.5, 1), (0.5, 2), (1.0, 4)])
def test_moe_apply_matches_reference(rng, arch, cf, groups):
    """Output and aux of one MoE layer (shared experts where the config
    has them), at the config's capacity factor and at ones that drop
    slots, with one dispatch group or several."""
    jcfg, cfg, params, layer = _layer(arch, moe_groups=groups)
    x = _dyadic_x(rng, (2, 24, cfg.d_model))
    kw = {} if cf is None else {"capacity_factor": cf}
    want, want_aux = jmoe.moe_apply(params, jnp.asarray(x, jnp.bfloat16), jcfg, **kw)
    with torch.no_grad():
        got, aux = moe.moe_apply(layer, torch.from_numpy(x).bfloat16(), cfg, **kw)
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape == (2, 24, cfg.d_model)
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -6 * np.abs(want).max())
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("tokens,cf,groups", [
    (48, 0.5, 1), (48, 0.25, 2), (4, 1.25, 1), (96, 1.0, 3)])
def test_dropped_slots_are_the_reference_s(rng, arch, tokens, cf, groups):
    """The set of token slots dropped for capacity, bitwise: the port's
    top-k, capacity and dispatch on the layer's router probabilities
    against the reference's (the capacity floor keeps a 4-token decode
    step free of drops)."""
    import dataclasses

    jcfg, cfg, params, layer = _layer(arch, moe_groups=groups)
    x = _dyadic_x(rng, (tokens, cfg.d_model))
    probs = jax.nn.softmax(jnp.asarray(x) @ params["router"], axis=-1)
    k, e = cfg.n_experts_per_tok, cfg.n_experts
    ng, cap = moe.capacity_of(cfg, tokens, cf)
    # the reference's own grouping and capacity, as its moe_apply derives them
    jng = jcfg.moe_groups if tokens % jcfg.moe_groups == 0 else 1
    tg = tokens // jng
    assert (ng, cap) == (jng, max(int(k * tg * cf / e), min(tg * k, 8)))
    _, jtopi = jax.lax.top_k(probs, k)
    want_flat, want_ok = _j_dispatch(np.asarray(jtopi).reshape(ng, -1), e, cap)
    _, topi = moe.top_k(torch.from_numpy(np.array(probs)), k)
    flat, ok = moe.dispatch_indices(topi.reshape(ng, -1), e, cap)
    np.testing.assert_array_equal(ok.numpy(), want_ok)
    np.testing.assert_array_equal(flat.numpy(), want_flat)
    # the layer drops them, as the smoke's counter reads its dispatch
    cfg_cf = dataclasses.replace(cfg, moe_capacity_factor=cf)
    with torch.no_grad(), _moe_drops() as drops:
        moe.moe_apply(layer, torch.from_numpy(x[None]).bfloat16(), cfg_cf)
    assert [int(d) for d in drops] == [int((~want_ok).sum())]
    if tokens == 4:
        assert int(drops[0]) == 0


def test_pinned_routing_pins_only_near_ties():
    """A recorded choice is taken where the run's own differs from it only
    at a near-tie of its probabilities, and refused (counted far) where
    it does not."""
    probs = torch.tensor([[0.40, 0.30, 0.2995, 0.0005],
                          [0.50, 0.30, 0.15, 0.05],
                          [0.25, 0.25, 0.25, 0.25]])
    pin = RoutingPin()
    pin.calls = [np.array([[0, 2], [0, 3], [3, 1]])]
    with pin.replay():
        vals, idx = moe.top_k(probs, 2)
    np.testing.assert_array_equal(idx.numpy(), [[0, 2], [0, 1], [3, 1]])
    np.testing.assert_array_equal(vals.numpy()[0], probs.numpy()[0, [0, 2]])
    assert (pin.pinned, pin.far) == (2, 1)
    assert pin.worst_gap <= pin.BAND
    # outside the block the plain top-k is back
    np.testing.assert_array_equal(moe.top_k(probs, 2)[1].numpy()[1], [0, 1])


def test_pinned_routing_pins_far_choices_when_asked():
    """With ``pin_far`` every differing token takes the recorded choice,
    and the counts still tell the near-ties from the choices beyond the
    band (the card's comparison reports both)."""
    probs = torch.tensor([[0.40, 0.30, 0.2995, 0.0005],
                          [0.50, 0.30, 0.15, 0.05],
                          [0.25, 0.25, 0.25, 0.25]])
    pin = RoutingPin(pin_far=True)
    pin.calls = [np.array([[0, 2], [0, 3], [3, 1]])]
    with pin.replay():
        vals, idx = moe.top_k(probs, 2)
    np.testing.assert_array_equal(idx.numpy(), [[0, 2], [0, 3], [3, 1]])
    np.testing.assert_array_equal(vals.numpy()[1], probs.numpy()[1, [0, 3]])
    assert (pin.pinned, pin.near, pin.far) == (3, 2, 1)
    # the far token's expert 3 lies (0.225 - 0.05) / 0.225 from the boundary
    assert abs(pin.worst_gap - 0.175 / 0.225) < 1e-6
    assert pin.summary()["far"] == 1
