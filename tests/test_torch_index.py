"""The port's ClusterIndex and ClusterService against the JAX package's.

A JAX-fitted index is carried across with ``ClusterIndex.from_numpy``;
the port's assign must then label queries as the JAX assign does: bit
for bit on dyadic queries, ≥ 0.999 agreement on continuous ones. Plus
the service's bucket ladder and chunking, and the device rule.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import gmm_sample

import repro
import repro_torch
from repro.core.index import ClusterIndex as JIndex
from repro_torch import runtime
from repro_torch.core.index import ClusterIndex
from repro_torch.serve import ClusterService

torch.set_num_threads(1)

FIELDS = ("protos", "proto_mass", "proto_valid", "proto_labels", "n_prototypes")


def dyadic(rng, shape, scale=0.25, lim=16):
    return (rng.integers(-lim, lim + 1, size=shape) * scale).astype(np.float32)


def carried(jindex):
    return ClusterIndex.from_numpy(
        {f: np.asarray(getattr(jindex, f)) for f in FIELDS}, device="cpu")


@pytest.fixture(scope="module")
def gmm_index():
    x, _ = gmm_sample(2000, np.random.default_rng(0))
    res = repro.fit(jnp.asarray(x), 2, 3, "kmeans", k=3)
    return JIndex.build(res), x


@pytest.mark.parametrize("impl", ["auto", "ref", "cuda", "fused"])
def test_carried_index_assigns_like_jax_dyadic(rng, gmm_index, impl):
    jidx, _ = gmm_index
    idx = carried(jidx).check_servable()
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(idx, f).numpy(),
                                      np.asarray(getattr(jidx, f)))
    # queries on the grid and prototypes snapped to it: every distance exact
    snapped = JIndex(protos=jnp.round(jidx.protos * 4) / 4,
                     proto_mass=jidx.proto_mass, proto_valid=jidx.proto_valid,
                     proto_labels=jidx.proto_labels,
                     n_prototypes=jidx.n_prototypes)
    q = dyadic(rng, (300, 2))
    want = np.asarray(snapped.assign(jnp.asarray(q), impl="ref"))
    got = carried(snapped).assign(q, impl=impl)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    got_blocked = carried(snapped).assign(q, impl="ref", block=17)
    np.testing.assert_array_equal(got_blocked.numpy(), want)


def test_carried_index_assigns_like_jax_continuous(rng, gmm_index):
    jidx, x = gmm_index
    q = (x[:1000] + rng.normal(size=(1000, 2)) * 0.1).astype(np.float32)
    want = np.asarray(jidx.assign(jnp.asarray(q)))
    for impl in ("auto", "fused"):
        got = carried(jidx).assign(q, impl=impl).numpy()
        assert (got == want).mean() >= 0.999


@pytest.mark.parametrize("impl", ["auto", "ref", "cuda", "fused"])
def test_carried_index_assigns_like_jax_bfloat16(gmm_index, impl):
    from repro import runtime as jruntime

    jidx, x = gmm_index
    rng = np.random.default_rng(5)
    q = (x[:1000] + rng.normal(size=(1000, 2)) * 0.1).astype(np.float32)
    with jruntime.configure(precision="bfloat16"):
        want = np.asarray(jidx.assign(jnp.asarray(q)))
    with runtime.configure(precision="bfloat16"):
        got = carried(jidx).assign(q, impl=impl).numpy()
    np.testing.assert_array_equal(got, want)
    # the cast is live: some labels move against the f32 assign
    assert (got != carried(jidx).assign(q, impl=impl).numpy()).any()


def test_assign_reproduces_training_labels(rng):
    x = dyadic(rng, (200, 2))
    res = repro_torch.fit(x, 2, 0, "kmeans", k=3, device="cpu")
    idx = ClusterIndex.build(res)
    np.testing.assert_array_equal(idx.assign(x).numpy(), res.labels.numpy())
    with pytest.raises(TypeError):
        ClusterIndex.build(res, t=2, m=1)
    assert ClusterIndex.build(idx, pack=False) is idx
    assert idx.protos_q8 is not None and idx.protos_bf16 is not None  # packed
    built = ClusterIndex.build(x, 2, 1, k=3, device="cpu")
    assert built.n_valid == int(built.n_prototypes)


def test_zero_valid_prototypes_label_minus_one(rng):
    idx = ClusterIndex.from_numpy(dict(
        protos=np.zeros((4, 2), np.float32), proto_mass=np.zeros(4, np.float32),
        proto_valid=np.zeros(4, bool), proto_labels=np.full(4, -1, np.int32),
        n_prototypes=np.int32(0)), device="cpu").check_servable()
    for impl in ("ref", "fused"):
        assert (idx.assign(rng.normal(size=(5, 2)), impl=impl) == -1).all()


def test_check_servable_rejects_inconsistent_index():
    good = dict(protos=np.zeros((4, 2), np.float32),
                proto_mass=np.ones(4, np.float32), proto_valid=np.ones(4, bool),
                proto_labels=np.zeros(4, np.int32), n_prototypes=np.int32(4))
    ClusterIndex.from_numpy(good, device="cpu").check_servable(expect_dim=2)
    with pytest.raises(ValueError, match="proto_mass"):
        ClusterIndex.from_numpy({**good, "proto_mass": np.ones(3, np.float32)},
                                device="cpu").check_servable()
    with pytest.raises(ValueError, match="n_prototypes"):
        ClusterIndex.from_numpy({**good, "n_prototypes": np.int32(5)},
                                device="cpu").check_servable()
    with pytest.raises(ValueError, match="expected dim"):
        ClusterIndex.from_numpy(good, device="cpu").check_servable(expect_dim=3)


def test_cluster_service_buckets_chunking_and_stats(rng, gmm_index):
    jidx, x = gmm_index
    idx = carried(jidx)
    svc = ClusterService(idx, buckets=(8, 32))
    svc.assign(x[:3])              # a probe before warmup is not traffic
    svc.warmup()
    assert svc.stats["requests"] == 0 and svc.stats["bucket_8"] == 0
    direct = idx.assign(x[:100]).numpy()
    np.testing.assert_array_equal(svc.assign(x[:32]).numpy(), direct[:32])  # exact top
    np.testing.assert_array_equal(svc.assign(x[:100]).numpy(), direct)      # chunked
    np.testing.assert_array_equal(svc.assign(x[:5]).numpy(), direct[:5])
    empty = svc.assign(np.zeros((0, 2), np.float32))
    assert empty.shape == (0,) and empty.dtype == torch.int32
    s = svc.stats_snapshot(reset=True)
    assert s["requests"] == 4 and s["points"] == 137
    # 32 → one top bucket; 100 → 32+32+32 and 4 (bucket 8); 5 → bucket 8
    assert s["bucket_32"] == 4 and s["bucket_8"] == 2 and s["chunks"] == 6
    assert svc.stats["requests"] == 0
    assert svc.bucket_for(33) == 32 and svc.bucket_for(1) == 8
    with pytest.raises(ValueError):
        ClusterService(idx, buckets=())
    with pytest.raises(ValueError):
        ClusterService(idx, buckets=(0, 8))


def test_default_device_is_cuda_and_raises_without_a_gpu(rng):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the rule under test is the "
                    "no-GPU refusal")
    assert runtime.RuntimeConfig().device == "cuda"
    x = dyadic(rng, (20, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.fit(x, 2, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClusterIndex.from_numpy(dict(
            protos=x, proto_mass=np.ones(20, np.float32),
            proto_valid=np.ones(20, bool), proto_labels=np.zeros(20, np.int32),
            n_prototypes=np.int32(20)))
    with runtime.configure(device="cpu"):
        assert repro_torch.fit(x, 2, 1, k=2).labels.device.type == "cpu"


def test_runtime_config_scopes_and_validation():
    base = runtime.active()
    with runtime.configure(impl="ref", knn_block=64) as cfg:
        assert runtime.active() is cfg and cfg.impl == "ref"
        with runtime.configure(n_blocks=2):
            assert runtime.active().knn_block == 64 and runtime.active().n_blocks == 2
    assert runtime.active() is base
    for bad in (dict(impl="pallas"), dict(knn_block=-1), dict(n_blocks=0),
                dict(precision="fp8")):
        with pytest.raises(ValueError):
            runtime.RuntimeConfig(**bad)
    env = {"REPRO_TORCH_IMPL": "fused", "REPRO_TORCH_KNN_BLOCK": "4096",
           "REPRO_TORCH_DEVICE": "cpu"}
    cfg = runtime.config_from_env(env)
    assert (cfg.impl, cfg.knn_block, cfg.device) == ("fused", 4096, "cpu")


def test_jax_key_carried_into_the_port():
    from repro_torch import prng

    k = jax.random.split(jax.random.PRNGKey(4))[1]
    np.testing.assert_array_equal(prng.key_to_numpy(prng.key_from_numpy(np.asarray(k))),
                                  np.asarray(k))
