"""The port's online lifecycle against the JAX package's: OnlineFitter
purity (a snapshot with no observe is the batch fit bit for bit,
snapshots repeat bit for bit, a snapshot survives later in-place folds),
observe slicing, the refresh policy, and the refresh loop under
virtual-clock traffic (``tests/serve_sim.py``) with zero failed requests.

Cross-package: on a dyadic grid under ``n_blocks=1`` the port's
zero-observe snapshot equals the reference's bit for bit.
"""
import jax
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro import runtime as jruntime
from repro.serve import OnlineFitter as JFitter
from repro_torch import prng, runtime
from repro_torch.core.index import ClusterIndex, nearest_valid_prototype
from repro_torch.serve import (
    AsyncClusterService,
    IndexStore,
    OnlineFitter,
    RefreshDriver,
    RefreshPolicy,
)

from serve_sim import SimExecutor, SimLoop, run_trace

torch.set_num_threads(1)


def _blobs(seed: int, n_per: int = 60, shift: float = 0.0,
           spread: float = 0.5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = np.array([[0.0, 0.0], [6.0, 0.0], [3.0, 6.0]]) + shift
    x = np.concatenate([c + rng.normal(scale=spread, size=(n_per, 2))
                        for c in centers])
    return x.astype(np.float32)


def dyadic(rng, shape, scale=0.25, lim=16):
    return (rng.integers(-lim, lim + 1, size=shape) * scale).astype(np.float32)


def fitter(source, t, m, **kw):
    return OnlineFitter(source, t, m, device="cpu", **kw)


def test_zero_observe_snapshot_matches_batch_fit():
    x = np.random.default_rng(0).normal(size=(600, 6)).astype(np.float32)
    chunks = [x[i:i + 200] for i in range(0, 600, 200)]
    batch = repro_torch.fit(iter(chunks), 4, 2, device="cpu")
    snap = fitter(iter(chunks), 4, 2).snapshot()
    np.testing.assert_array_equal(batch.protos.numpy(), snap.protos.numpy())
    np.testing.assert_array_equal(batch.proto_labels.numpy(),
                                  snap.proto_labels.numpy())
    np.testing.assert_array_equal(np.asarray(batch.labels),
                                  np.asarray(snap.labels))


def test_zero_observe_snapshot_matches_the_reference_dyadic():
    rng = np.random.default_rng(1)
    x = dyadic(rng, (400, 2))
    chunks = [x[i:i + 200] for i in range(0, 400, 200)]
    with jruntime.configure(n_blocks=1):
        want = JFitter(iter(chunks), 2, 2, k=3, reservoir_n=400,
                       key=jax.random.PRNGKey(2)).snapshot()
    got = fitter(iter(chunks), 2, 2, k=3, reservoir_n=400,
                 key=prng.PRNGKey(2), n_blocks=1).snapshot()
    np.testing.assert_array_equal(got.protos.numpy(), np.asarray(want.protos))
    np.testing.assert_array_equal(np.asarray(got.labels), np.asarray(want.labels))


def test_repeated_snapshots_bitwise_identical():
    x = np.random.default_rng(2).normal(size=(400, 4)).astype(np.float32)
    f = fitter(x, 3, 2, chunk_n=100)
    a, b = f.snapshot(), f.snapshot()
    np.testing.assert_array_equal(a.protos.numpy(), b.protos.numpy())
    np.testing.assert_array_equal(np.asarray(a.labels), np.asarray(b.labels))
    assert f.stats["n_snapshots"] == 2


@pytest.mark.parametrize("m", [1, 2])
def test_snapshot_survives_later_in_place_folds(m):
    """The reservoir is written in place: a snapshot must own its buffers
    (m = 1 serves the reservoir prefix itself, so it is cloned)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(300, 5)).astype(np.float32)
    f = fitter(x, 3, m, chunk_n=100)
    snap = f.snapshot()
    before = [t.clone() for t in (snap.protos, snap.proto_mass, snap.proto_valid)]
    for _ in range(4):  # enough folds to cascade and rewrite the reservoir
        f.observe(rng.normal(size=(250, 5)).astype(np.float32))
    assert f.n_cascades >= 1
    for a, b in zip(before, (snap.protos, snap.proto_mass, snap.proto_valid)):
        assert torch.equal(a, b)
    assert f.n_points == 300 + 4 * 250


def test_observe_slicing_matches_prechunked_stream():
    x = np.random.default_rng(4).normal(size=(800, 4)).astype(np.float32)
    chunks = [x[i:i + 200] for i in range(0, 800, 200)]
    a = fitter(iter(chunks), 3, 2)
    b = fitter(x[:200], 3, 2)
    b.observe(x[200:])  # 600 rows -> sliced into chunks 1..3
    assert a.n_chunks == b.n_chunks == 4
    sa, sb = a.snapshot(), b.snapshot()
    np.testing.assert_array_equal(sa.protos.numpy(), sb.protos.numpy())
    np.testing.assert_array_equal(sa.labels_for(0), sb.labels_for(0))


def test_observe_masked_pair_counts_and_refusals():
    rng = np.random.default_rng(5)
    f = fitter(rng.normal(size=(200, 3)).astype(np.float32), 3, 1)
    arr = rng.normal(size=(50, 3)).astype(np.float32)
    assert f.observe((arr, 20)) == 20
    assert f.observe(np.zeros((0, 3), np.float32)) == 0
    assert f.n_points == 220
    assert f.stats["executor"] == "streaming" and f.stats["n_snapshots"] == 0
    assert "OnlineFitter(" in repr(f)
    with pytest.raises(ValueError, match="chunk stream|streaming"):
        fitter(rng.normal(size=(100, 3)).astype(np.float32), 3, 1,
               executor="memory")


def test_refresh_policy_triggers_and_config():
    p = RefreshPolicy(max_points=100, max_cascades=2, drift_ratio=0.5)
    assert p.enabled
    no = dict(points_since=0, cascades_since=0, drift=None)
    assert p.should_refresh(**no) is None
    assert p.should_refresh(**{**no, "points_since": 100}) == "max_points"
    assert p.should_refresh(**{**no, "cascades_since": 2}) == "max_cascades"
    assert p.should_refresh(**{**no, "drift": 1.49}) is None
    assert p.should_refresh(**{**no, "drift": 1.5}) == "drift_ratio"
    assert not RefreshPolicy().enabled
    with runtime.configure(refresh_max_points=64, refresh_drift_ratio=0.25):
        assert RefreshPolicy.from_config() == RefreshPolicy(
            max_points=64, max_cascades=0, drift_ratio=0.25)
    with pytest.raises(ValueError, match="disables the trigger"):
        runtime.RuntimeConfig(refresh_max_points=-1)
    env = runtime.config_from_env({"REPRO_TORCH_REFRESH_MAX_POINTS": "9",
                                   "REPRO_TORCH_REFRESH_DRIFT_RATIO": "0.5",
                                   "REPRO_TORCH_SERVE_MAX_WAIT_MS": "2.5"})
    assert (env.refresh_max_points, env.refresh_drift_ratio,
            env.serve_max_wait_ms) == (9, 0.5, 2.5)


def _mean_dist(index, q):
    d, _ = nearest_valid_prototype(torch.from_numpy(q), index.protos,
                                   index.proto_valid)
    return float(torch.sqrt(torch.clamp_min(d, 0.0)).mean())


@pytest.mark.parametrize("impl", [None, "fused_int8"])
def test_lifecycle_refresh_under_traffic(tmp_path, impl):
    """fit → serve → observe drifted traffic → the policy fires →
    snapshot / save / hot-swap, while the virtual-clock scheduler keeps
    serving: zero failed requests, every response from exactly one
    version, the refreshed index much nearer the drifted traffic."""
    x0 = _blobs(0)
    drifted = _blobs(1, shift=8.0)
    f = fitter(x0, 2, 1, k=3)
    stale = f.build_index()
    batches = []
    loop = SimLoop()
    svc = AsyncClusterService(stale, loop=loop,
                              executor=SimExecutor(loop, service_time=1.0),
                              max_wait=2.0, observer=batches.append, impl=impl)
    store = IndexStore(tmp_path)
    driver = RefreshDriver(svc, f, store=store,
                           policy=RefreshPolicy(max_points=120))
    qrng = np.random.default_rng(3)
    arrivals = []
    for i in range(40):
        pool = x0 if i < 10 else drifted  # traffic drifts at t=10
        arrivals.append((float(i), None,
                         pool[qrng.integers(0, pool.shape[0], size=8)]))
    for t_obs in (12.0, 18.0, 24.0):
        chunk = drifted[qrng.integers(0, drifted.shape[0], size=60)]
        loop.call_later(t_obs, lambda c=chunk: driver.observe(c))
    records = run_trace(svc, loop, arrivals)

    for rec in records:
        assert rec.error is None and rec.future.done()
        assert rec.future.exception() is None
    assert [v for v, _ in driver.history] == [2]
    assert driver.history[0][1] == "max_points"
    assert store.list_versions() == [1] and svc.version() == 2
    sched = svc.stats_snapshot()["scheduler"]
    assert (sched["swaps"], sched["failed"], sched["rejected"]) == (1, 0, 0)
    seen = {}
    for b in batches:
        for rid, _rows, _t in b.segments:
            seen.setdefault(rid, set()).add(b.version)
    assert len(seen) == len(records)
    assert all(len(vs) == 1 for vs in seen.values())
    assert {v for vs in seen.values() for v in vs} == {1, 2}
    # the stored version is the installed one, bit for bit
    fresh = store.load(1, device="cpu")
    for name in ("protos", "protos_q8", "q8_scale", "proto_labels"):
        assert torch.equal(getattr(fresh, name),
                           getattr(svc.current_index(), name))
    assert _mean_dist(fresh, drifted) < 0.5 * _mean_dist(stale, drifted)
    assert driver.stats["refreshes"] == 1
    assert driver.stats["points_since_install"] == 60  # post-swap observe


def test_refresh_driver_drift_trigger():
    x0 = _blobs(0)
    drifted = _blobs(2, shift=9.0)
    f = fitter(x0, 2, 1, k=3)
    loop = SimLoop()
    svc = AsyncClusterService(f.build_index(), loop=loop,
                              executor=SimExecutor(loop))
    driver = RefreshDriver(svc, f, policy=RefreshPolicy(drift_ratio=1.0),
                           drift_alpha=1.0)
    assert driver.drift is None
    assert driver.observe(x0[:40]) is None          # baseline: ratio 1.0
    assert 0.99 < driver.drift < 1.01
    assert driver.observe(drifted[:40]) == 2        # far away: fires
    assert driver.history[0][1] == "drift_ratio"
    assert driver.drift is None                     # re-baselined
    with pytest.raises(ValueError, match="drift_alpha"):
        RefreshDriver(svc, f, drift_alpha=0.0)


def test_build_dispatches_on_source_type():
    x = _blobs(0)
    result = repro_torch.fit(x, 2, 1, k=3, device="cpu")
    from_result = ClusterIndex.build(result)
    from_raw = ClusterIndex.build(x, 2, 1, k=3, device="cpu")
    for name in ClusterIndex._fields:
        assert torch.equal(getattr(from_result, name), getattr(from_raw, name))
    assert ClusterIndex.build(result, pack=False).protos_bf16 is None
    from_stream = ClusterIndex.build(iter([x[:90], x[90:]]), 2, 1, k=3,
                                     device="cpu")
    assert from_stream.dim == 2 and from_stream.protos_q8 is not None
    with pytest.raises(TypeError, match="t/m only apply"):
        ClusterIndex.build(result, 2, 1)
    with pytest.raises(TypeError, match="needs t and m"):
        ClusterIndex.build(x)
    from repro_torch.serve import ClusterService

    svc = ClusterService.from_fit(result, impl="fused_int8", buckets=(8, 64))
    svc.warmup()
    assert svc.index.protos_q8 is not None and svc.stats["requests"] == 0
    np.testing.assert_array_equal(svc.assign(x).numpy(),
                                  from_result.assign(x, impl="fused_int8").numpy())


def test_serve_surface_exports():
    import repro_torch.serve as serve

    for name in serve.__all__:
        assert getattr(serve, name) is not None
    assert serve.OnlineFitter is OnlineFitter
    assert repro_torch.AsyncClusterService is AsyncClusterService
    assert repro_torch.IndexStore is IndexStore
    with pytest.raises(AttributeError):
        serve.not_a_thing
    assert set(serve.__all__) <= set(repro.serve.__all__)
