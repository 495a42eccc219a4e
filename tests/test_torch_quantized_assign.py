"""The port's quantized assign path against the JAX package's: int8 key
quantization, K1's plain fold over int8 and bf16 keys, the exact rescore,
and ``ClusterIndex.assign(impl="fused_bf16" | "fused_int8")``.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: on dyadic grids (every value a small multiple of a power of
two, so every distance and partial sum is exact in f32) the two must
agree bit for bit, ties included; on continuous data quantization and
labels are still exact (``quantize_keys`` bitwise, zero label
disagreement), and distances of the plain fold agree to 1e-5 relative
(they may round the cross term in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import gmm_sample

import repro
from repro.core.index import ClusterIndex as JIndex
from repro.kernels import fused_assign as jfa
from repro_torch import runtime
from repro_torch.core.index import ClusterIndex
from repro_torch.kernels import fused_assign as tfa
from repro_torch.kernels import ops

torch.set_num_threads(1)

FIELDS = ("protos", "proto_mass", "proto_valid", "proto_labels", "n_prototypes")
PACKED = ("protos_bf16", "protos_q8", "q8_scale", "q8_zero")


def dyadic(rng, shape, scale=0.25, lim=16):
    return (rng.integers(-lim, lim + 1, size=shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def bf16_np(a):
    """A jax bf16 array's bits as a torch bf16 tensor."""
    return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(torch.bfloat16)


@pytest.mark.parametrize("p,d,masked", [(50, 3, False), (37, 6, True),
                                        (9, 1, True), (64, 130, True)])
def test_quantize_keys_bitwise(p, d, masked):
    rng = np.random.default_rng(p + d)
    keys = (rng.normal(size=(p, d)) * rng.uniform(0.1, 5, size=d)).astype(np.float32)
    keys[:, 0] = 1.5  # a constant feature takes the floor scale
    valid = rng.random(p) > 0.3 if masked else None
    if masked:
        keys[~valid] = 1e6  # invalid rows must not widen the range
    jv = None if valid is None else jnp.asarray(valid)
    want = jfa.quantize_keys(jnp.asarray(keys), jv)
    got = tfa.quantize_keys(t(keys), None if valid is None else t(valid))
    assert got[0].dtype == torch.int8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_quantize_keys_no_valid_rows():
    keys = np.ones((5, 3), np.float32)
    valid = np.zeros(5, bool)
    want = jfa.quantize_keys(jnp.asarray(keys), jnp.asarray(valid))
    got = tfa.quantize_keys(t(keys), t(valid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


CASES = [  # nq, p, d, k, block_k
    (7, 33, 1, 1, 8), (33, 17, 5, 3, 16), (9, 9, 2, 9, 8), (20, 70, 6, 8, 32),
]


@pytest.mark.parametrize("nq,p,d,k,bk", CASES)
def test_plain_int8_fold_matches_pallas_and_xla_dyadic(nq, p, d, k, bk):
    """int8 keys with dyadic per-feature scale and zero: every dequantized
    value and distance is exact, so the plain fold, the Pallas kernel in
    interpret mode and the XLA fold agree bit for bit."""
    rng = np.random.default_rng(nq * p)
    q = dyadic(rng, (nq, d))
    q8 = rng.integers(-127, 128, size=(p, d)).astype(np.int8)
    scale = (2.0 ** -rng.integers(3, 7, size=d)).astype(np.float32)
    zero = dyadic(rng, (d,))
    valid = rng.random(p) > 0.3
    gidx = rng.integers(0, 2 * p, size=nq).astype(np.int32)
    kw = dict(keys_scale=jnp.asarray(scale), keys_zero=jnp.asarray(zero))
    wd, wi = jfa.fused_topk(jnp.asarray(q), jnp.asarray(q8), k,
                            jnp.asarray(valid), q_gidx=jnp.asarray(gidx),
                            block_q=8, block_k=bk, interpret=True, **kw)
    xd, xi = jfa.fused_topk_xla(jnp.asarray(q), jnp.asarray(q8), k,
                                jnp.asarray(valid), q_gidx=jnp.asarray(gidx),
                                block_k=bk, **kw)
    gd, gi = tfa.fused_topk(t(q), t(q8), k, t(valid), q_gidx=t(gidx),
                            keys_scale=t(scale), keys_zero=t(zero), block_k=bk)
    for want_d, want_i in ((wd, wi), (xd, xi)):
        np.testing.assert_array_equal(gd.numpy(), np.asarray(want_d))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("nq,p,d,k,bk", CASES)
def test_plain_bf16_fold_matches_pallas_and_xla_dyadic(nq, p, d, k, bk):
    """bf16 queries and keys on a dyadic grid (exact in bf16): widened to
    f32, the same bits on all three folds."""
    rng = np.random.default_rng(nq + p)
    q = jnp.asarray(dyadic(rng, (nq, d)), jnp.bfloat16)
    keys = jnp.asarray(dyadic(rng, (p, d)), jnp.bfloat16)
    valid = rng.random(p) > 0.3
    wd, wi = jfa.fused_topk(q, keys, k, jnp.asarray(valid), block_q=16,
                            block_k=bk, interpret=True)
    xd, xi = jfa.fused_topk_xla(q, keys, k, jnp.asarray(valid), block_k=bk)
    gd, gi = tfa.fused_topk(bf16_np(q), bf16_np(keys), k, t(valid), block_k=bk)
    for want_d, want_i in ((wd, wi), (xd, xi)):
        np.testing.assert_array_equal(gd.numpy(), np.asarray(want_d))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(want_i))


def test_plain_int8_fold_continuous_quantized_keys():
    """Keys quantized by ``quantize_keys`` on continuous data: the
    dequantized values are no longer dyadic, and the reference may fuse
    its multiply-add, so distances agree to 1e-5 relative and indices
    wherever the best distances are not within that tolerance."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(64, 6)).astype(np.float32)
    keys = rng.normal(size=(300, 6)).astype(np.float32)
    q8, scale, zero = jfa.quantize_keys(jnp.asarray(keys))
    wd, wi = jfa.fused_topk_xla(jnp.asarray(q), q8, 8, keys_scale=scale,
                                keys_zero=zero)
    gd, gi = tfa.fused_topk(t(q), t(q8), 8, keys_scale=t(scale),
                            keys_zero=t(zero))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-5, atol=1e-5)
    assert (gi.numpy() == np.asarray(wi)).mean() >= 0.99


def test_plain_dequant_is_multiply_then_add():
    """The FMA case: q8 = 127, scale = 1 + 2^-23, zero = -127. A multiply
    rounded, then an add, gives 2^-16; one fused multiply-add would give
    127·2^-23. The plain fold (the CUDA kernel's oracle) must give the
    former, so a query at 0 sees every key at d·2^-32 — all tied, the
    lowest valid indices first."""
    d, p = 6, 10
    q8 = np.full((p, d), 127, np.int8)
    scale = np.full(d, 1 + 2.0 ** -23, np.float32)
    zero = np.full(d, -127.0, np.float32)
    valid = np.array([False, True] * 5)
    gd, gi = tfa.fused_topk(torch.zeros((3, d)), t(q8), 4, t(valid),
                            keys_scale=t(scale), keys_zero=t(zero))
    np.testing.assert_array_equal(gd.numpy(), np.full((3, 4), d * 2.0 ** -32,
                                                      np.float32))
    np.testing.assert_array_equal(gi.numpy(), np.tile([1, 3, 5, 7], (3, 1)))


def test_rescore_top1_matches_reference():
    rng = np.random.default_rng(4)
    q = dyadic(rng, (40, 3))
    keys = dyadic(rng, (25, 3))
    valid = rng.random(25) > 0.2
    cand = rng.integers(-1, 25, size=(40, 8)).astype(np.int32)
    cand[0] = -1  # a shortlist with no candidate
    wd, wi = jfa.rescore_top1(jnp.asarray(q), jnp.asarray(keys),
                              jnp.asarray(valid), jnp.asarray(cand))
    gd, gi = tfa.rescore_top1(t(q), t(keys), t(valid), t(cand))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert gi[0] == -1 and gi.dtype == torch.int32


@pytest.fixture(scope="module")
def gmm_index():
    x, _ = gmm_sample(2000, np.random.default_rng(0))
    res = repro.fit(jnp.asarray(x), 2, 3, "kmeans", k=3)
    return JIndex.build(res), x


def carried(jindex):
    arrays = {f: np.asarray(getattr(jindex, f)) for f in FIELDS + PACKED
              if getattr(jindex, f) is not None}
    return ClusterIndex.from_numpy(arrays, device="cpu")


def test_build_packs_like_the_reference(gmm_index):
    jidx, _ = gmm_index
    mine = ClusterIndex.build(carried(jidx._replace(
        protos_bf16=None, protos_q8=None, q8_scale=None, q8_zero=None)))
    for f in PACKED:
        np.testing.assert_array_equal(
            getattr(mine, f).view(torch.int16).numpy() if f == "protos_bf16"
            else getattr(mine, f).numpy(),
            np.asarray(getattr(jidx, f)).view(np.int16) if f == "protos_bf16"
            else np.asarray(getattr(jidx, f)))
    unpacked = ClusterIndex.build(carried(jidx), pack=False)
    assert unpacked.protos_q8 is not None  # an index is re-packed, not stripped
    assert ClusterIndex.build(carried(jidx)).protos_bf16.dtype == torch.bfloat16


@pytest.mark.parametrize("impl", ["fused_bf16", "fused_int8"])
def test_quantized_assign_matches_jax_dyadic(gmm_index, impl):
    jidx, _ = gmm_index
    rng = np.random.default_rng(7)
    snapped = JIndex.build(JIndex(
        protos=jnp.round(jidx.protos * 4) / 4, proto_mass=jidx.proto_mass,
        proto_valid=jidx.proto_valid, proto_labels=jidx.proto_labels,
        n_prototypes=jidx.n_prototypes))
    q = dyadic(rng, (300, 2))
    want = np.asarray(snapped.assign(jnp.asarray(q), impl=impl))
    idx = carried(snapped)
    got = idx.assign(q, impl=impl)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # an unpacked index packs on the fly: the same labels
    bare = ClusterIndex.build(idx, pack=False)._replace(
        protos_bf16=None, protos_q8=None, q8_scale=None, q8_zero=None)
    np.testing.assert_array_equal(bare.assign(q, impl=impl).numpy(), want)


@pytest.mark.parametrize("impl", ["fused_bf16", "fused_int8"])
def test_quantized_assign_matches_jax_continuous(gmm_index, impl):
    """Continuous queries near the data: zero label disagreement with the
    reference's quantized assign and with the exact f32 assign."""
    jidx, x = gmm_index
    rng = np.random.default_rng(8)
    q = (x[:1500] + rng.normal(size=(1500, 2)) * 0.1).astype(np.float32)
    want = np.asarray(jidx.assign(jnp.asarray(q), impl=impl))
    idx = carried(jidx)
    got = idx.assign(q, impl=impl).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, idx.assign(q, impl="fused").numpy())


def test_precision_bfloat16_serves_from_the_packed_buffer(gmm_index):
    from repro import runtime as jruntime

    jidx, x = gmm_index
    q = (x[:500] + np.random.default_rng(9).normal(size=(500, 2)) * 0.1
         ).astype(np.float32)
    with jruntime.configure(precision="bfloat16"):
        want = np.asarray(jidx.assign(jnp.asarray(q)))
    idx = carried(jidx)
    with runtime.configure(precision="bfloat16"):
        got = idx.assign(q).numpy()
        # a stale bf16 buffer is what is served: it is not recast per call
        zeroed = idx._replace(protos_bf16=torch.zeros_like(idx.protos_bf16))
        moved = zeroed.assign(q).numpy()
    np.testing.assert_array_equal(got, want)
    assert (moved != got).any()


def test_check_servable_mirrors_packed_buffers(gmm_index):
    jidx, _ = gmm_index
    idx = carried(jidx).check_servable()
    with pytest.raises(ValueError, match="protos_bf16"):
        idx._replace(protos_bf16=idx.protos_bf16[:-1]).check_servable()
    with pytest.raises(ValueError, match="protos_q8"):
        idx._replace(protos_q8=idx.protos_q8[:, :1]).check_servable()
    with pytest.raises(ValueError, match="q8_scale"):
        idx._replace(q8_scale=None).check_servable()


def test_bf16_keys_take_bf16_queries():
    # the kernel has a bf16 x bf16 instance only; the plain fold refuses
    # the same mix, so CPU and card accept the same calls
    x = torch.arange(18.0).reshape(6, 3)
    with pytest.raises(ValueError, match="bf16 keys take bf16 queries"):
        tfa.fused_topk(x, x.bfloat16(), 2)
    d, i = tfa.fused_topk(x.bfloat16(), x.bfloat16(), 2)
    assert d.dtype == torch.float32 and i[:, 0].tolist() == list(range(6))


def test_fused_family_resolution():
    cpu = torch.device("cpu")
    for impl in ("fused", "fused_bf16", "fused_int8"):
        assert ops.resolve(impl, cpu) == "ref"          # no fused path: auto
        assert ops.resolve(impl, cpu, fused=True) == impl
    with pytest.raises(ValueError, match="unknown impl"):
        ops.resolve("fused_fp8", cpu)
    with runtime.configure(impl="fused_int8"):
        assert ops.resolve(None, cpu, fused=True) == "fused_int8"
    # the stateless top-k runs int8 keys through the fused fold under any
    # fused impl, and the composed policies dequantize first
    rng = np.random.default_rng(2)
    q = dyadic(rng, (9, 3))
    q8 = rng.integers(-127, 128, size=(20, 3)).astype(np.int8)
    s, z = np.full(3, 0.125, np.float32), np.full(3, 0.5, np.float32)
    outs = [ops.nearest_topk(t(q), t(q8), 2, keys_scale=t(s), keys_zero=t(z),
                             impl=impl) for impl in ("fused_int8", "ref")]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_wrapper_rejects_inconsistent_quantized_arguments():
    q8 = torch.zeros((4, 3), dtype=torch.int8)
    with pytest.raises(ValueError, match="int8 keys need"):
        tfa.fused_topk(torch.zeros((2, 3)), q8, 1)
    with pytest.raises(ValueError, match="come together"):
        tfa.fused_topk(torch.zeros((2, 3)), q8, 1, keys_scale=torch.ones(3))
    with pytest.raises(ValueError, match="dequantize int8 keys"):
        tfa.fused_topk(torch.zeros((2, 3)), torch.zeros((4, 3)), 1,
                       keys_scale=torch.ones(3), keys_zero=torch.ones(3))
    with pytest.raises(ValueError, match="keys_scale has shape"):
        tfa.fused_topk(torch.zeros((2, 3)), q8, 1, keys_scale=torch.ones(2),
                       keys_zero=torch.ones(2))


def test_jax_key_types_roundtrip_through_from_numpy(gmm_index):
    """bf16 crosses as numpy's extension type or as its uint16 bits."""
    jidx, _ = gmm_index
    a = np.asarray(jidx.protos_bf16)
    via_ext = ClusterIndex.from_numpy({**{f: np.asarray(getattr(jidx, f))
                                          for f in FIELDS}, "protos_bf16": a},
                                      device="cpu")
    via_bits = ClusterIndex.from_numpy({**{f: np.asarray(getattr(jidx, f))
                                           for f in FIELDS},
                                        "protos_bf16": a.view(np.uint16)},
                                       device="cpu")
    for idx in (via_ext, via_bits):
        np.testing.assert_array_equal(idx.protos_bf16.view(torch.int16).numpy(),
                                      a.view(np.int16))
