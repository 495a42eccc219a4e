"""The port's streaming executor against the JAX package's.

Bitwise cases use dyadic grids under ``n_blocks=1`` (one row-order fold;
ROADMAP Queue 3 says why the reference's 8-block fold is not bitwise
under jit). A multi-chunk stream with cascades is held against the
reference run op by op (``jax.disable_jit``): once prototypes are means of
three points they leave the grid, and the jitted reference's kNN may then
split a distance near-tie by a contracted FMA where an eager run does not
(Queue 3). Single-buffer streams equal the port's in-memory fit; every
``prefetch_depth`` equals depth 0 bit for bit; on continuous data labels
agree with the reference's streaming fit at >= 0.99 under the best
renaming.
"""
import threading

import jax
import numpy as np
import pytest
import torch
from conftest import gmm_sample

import repro
import repro_torch
from repro import runtime as jruntime
from repro.cluster.metrics import clustering_accuracy
from repro_torch import prng, runtime
from repro_torch.core.plan import LabelSpill
from repro_torch.core.streaming import _PREFETCH_THREAD_NAME, ihtc_streaming

torch.set_num_threads(1)


def dyadic(rng, shape, scale=0.25, lim=16):
    return (rng.integers(-lim, lim + 1, size=shape) * scale).astype(np.float32)


def chunked(x, size):
    return [x[lo:lo + size] for lo in range(0, len(x), size)]


def stream_fit(chunks, t, m, **kw):
    return ihtc_streaming(iter(chunks), t, m, "kmeans", device="cpu", **kw)


def assert_same_fit(a, b):
    np.testing.assert_array_equal(np.asarray(a.labels), np.asarray(b.labels))
    for f in ("protos", "proto_mass", "proto_labels"):
        np.testing.assert_array_equal(getattr(a, f).numpy(), getattr(b, f).numpy())


@pytest.mark.parametrize("m", [1, 2, 3])
def test_single_buffer_stream_equals_the_memory_fit(m):
    """One chunk == the whole level-0 buffer, a reservoir that never
    overflows: the stream runs the memory executor's levels with its keys,
    so labels, prototypes and masses are the same bits — and the same as
    the reference's streaming fit of that stream."""
    x = dyadic(np.random.default_rng(m), (512, 2))
    key = prng.PRNGKey(7)
    want = repro_torch.fit(x, 2, m, "kmeans", k=3, key=key, device="cpu",
                           n_blocks=1)
    got = stream_fit([x], 2, m, k=3, key=key, chunk_n=512, reservoir_n=1024,
                     n_blocks=1)
    assert got.n_cascades == 0 and got.executor == "streaming"
    np.testing.assert_array_equal(got.labels_for(0), want.labels.numpy())
    for f in ("protos", "proto_mass", "proto_labels"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(want, f).numpy())
    with jruntime.configure(n_blocks=1):
        ref = repro.fit(iter([x]), 2, m, "kmeans", k=3, chunk_n=512,
                        reservoir_n=1024, key=jax.random.PRNGKey(7))
    np.testing.assert_array_equal(got.labels_for(0), ref.labels_for(0))
    np.testing.assert_array_equal(got.protos.numpy(), np.asarray(ref.protos))


def test_multichunk_cascading_stream_matches_reference_bitwise():
    """Five chunks, three cascades of the reservoir and a finalize of two
    more levels: maps, prototypes and labels bit for bit against the
    reference run op by op."""
    rng = np.random.default_rng(0)
    chunks = chunked(dyadic(rng, (480, 2)), 96)
    kw = dict(k=3, iters=8, reservoir_n=120)
    with jruntime.configure(n_blocks=1), jax.disable_jit():
        want = repro.fit(iter(chunks), 2, 3, "kmeans",
                         key=jax.random.PRNGKey(1), **kw)
    got = stream_fit(chunks, 2, 3, key=prng.PRNGKey(1), n_blocks=1, **kw)
    assert got.n_cascades == want.n_cascades == 3
    for a, b in zip(got.spill.maps, want.spill.maps):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.spill.chunk_assign, want.spill.chunk_assign):
        np.testing.assert_array_equal(a, b)
    assert got.spill.chunk_offset == want.spill.chunk_offset
    assert got.spill.chunk_epoch == want.spill.chunk_epoch
    np.testing.assert_array_equal(np.asarray(got.labels), np.asarray(want.labels))
    np.testing.assert_array_equal(got.protos.numpy(), np.asarray(want.protos))
    np.testing.assert_array_equal(got.proto_mass.numpy(),
                                  np.asarray(want.proto_mass))


def test_early_stop_and_tiny_raw_fold_match_reference():
    rng = np.random.default_rng(5)
    x = dyadic(rng, (64, 2))
    with jruntime.configure(n_blocks=1):
        want = repro.fit(iter([x]), 2, 6, "kmeans", k=2, chunk_n=64,
                         reservoir_n=64, key=jax.random.PRNGKey(3))
    got = stream_fit([x], 2, 6, k=2, chunk_n=64, reservoir_n=64,
                     key=prng.PRNGKey(3), n_blocks=1)
    np.testing.assert_array_equal(got.labels_for(0), want.labels_for(0))
    tiny = dyadic(rng, (3, 2))  # below the reduction floor: folds raw
    want = repro.fit(iter([tiny]), 2, 2, "kmeans", k=2, chunk_n=3,
                     reservoir_n=16, key=jax.random.PRNGKey(5))
    got = stream_fit([tiny], 2, 2, k=2, chunk_n=3, reservoir_n=16,
                     key=prng.PRNGKey(5))
    np.testing.assert_array_equal(got.labels_for(0), want.labels_for(0))
    np.testing.assert_array_equal(got.proto_labels.numpy(),
                                  np.asarray(want.proto_labels))


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_every_prefetch_depth_is_bitwise_depth_zero(depth):
    """Pairs, bare arrays, an empty chunk, a raw tail and ragged chunks, with
    cascades: every depth gives depth 0's bits."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(1500, 2)).astype(np.float32)
    padded = np.zeros((256, 2), np.float32)
    padded[:200] = x[:200]
    chunks = [(padded, 200), x[200:456], np.zeros((0, 2), np.float32),
              x[456:700], x[700:956], x[956:1212], x[1212:1468], x[1468:]]
    kw = dict(k=3, chunk_n=256, reservoir_n=320, key=prng.PRNGKey(2))
    base = stream_fit(chunks, 2, 2, prefetch_depth=0, **kw)
    got = stream_fit(chunks, 2, 2, prefetch_depth=depth, **kw)
    assert base.n_cascades >= 2
    assert_same_fit(got, base)
    assert [len(a) for a in got.iter_labels()] == [200, 256, 0, 244, 256, 256,
                                                   256, 32]
    assert got.spill.ingest_stats["prefetch_depth"] == depth
    assert _prefetch_threads() == []


def test_continuous_stream_agrees_with_reference():
    x, comp = gmm_sample(4000, np.random.default_rng(4))
    chunks = chunked(x, 1000)
    want = repro.fit(iter(chunks), 2, 3, "kmeans", k=3,
                     key=jax.random.PRNGKey(0))
    got = stream_fit(chunks, 2, 3, k=3, key=prng.PRNGKey(0))
    assert got.n_cascades == want.n_cascades
    assert clustering_accuracy(np.asarray(want.labels), np.asarray(got.labels),
                               3) >= 0.99
    mass = got.proto_mass.numpy()[got.proto_valid.numpy()]
    assert abs(mass.sum() - 4000) < 1e-2


def test_point_chunks_copy_the_reference_generator():
    from repro.data.pipeline import PointStreamConfig as JCfg
    from repro.data.pipeline import point_chunks as jchunks
    from repro_torch.data import PointStreamConfig, point_chunk, point_chunks

    for kind, d in (("gmm", 2), ("blobs", 6)):
        mine = list(point_chunks(PointStreamConfig(n=2500, d=d, chunk=1000,
                                                   seed=3, kind=kind, k=7)))
        ref = list(jchunks(JCfg(n=2500, d=d, chunk=1000, seed=3, kind=kind, k=7)))
        assert len(mine) == len(ref) == 3
        for a, b in zip(mine, ref):
            np.testing.assert_array_equal(a, b)
    cfg = PointStreamConfig(n=10, chunk=4)
    assert point_chunk(cfg, 5).shape == (0, 2)
    x, comp = point_chunk(cfg, 5, with_labels=True)
    assert x.shape == (0, 2) and comp.shape == (0,)
    # the generating components: the same points, each row nearest (in
    # the mean) to its own blob centre
    blobs = PointStreamConfig(n=4000, d=6, chunk=4000, seed=3, kind="blobs", k=7)
    x, comp = point_chunk(blobs, 0, with_labels=True)
    np.testing.assert_array_equal(x, point_chunk(blobs, 0))
    assert comp.dtype == np.int64 and set(np.unique(comp)) == set(range(7))
    means = np.stack([x[comp == j].mean(0) for j in range(7)])
    near = np.argmin(((x[:, None, :] - means[None]) ** 2).sum(-1), axis=1)
    assert (near == comp).mean() > 0.9
    with pytest.raises(ValueError, match="unknown point-stream kind"):
        point_chunk(PointStreamConfig(n=10, kind="rings"), 0)


def test_stream_result_views_and_index():
    x, _ = gmm_sample(2000, np.random.default_rng(6))
    res = repro_torch.fit(iter(chunked(x, 512)), 2, 2, "kmeans", k=3,
                          device="cpu")
    assert res.chunk_n == 512 and res.n_chunks == 4 and res.n_total == 2000
    lab = res.labels()
    assert lab.shape == (2000,) and lab.min() >= 0
    np.testing.assert_array_equal(np.asarray(res.labels), lab)
    np.testing.assert_array_equal(np.concatenate(list(res.iter_labels())), lab)
    idx = res.to_index()
    assert idx.protos_q8 is not None
    # the frozen index labels the training stream as its back-out did
    assert (idx.assign(x).numpy() == lab).mean() >= 0.95
    for a in list(res.spill.chunk_assign) + list(res.spill.maps):
        assert isinstance(a, np.ndarray)
    with pytest.raises(TypeError, match="host numpy"):
        LabelSpill(chunk_assign=[torch.zeros(4, dtype=torch.int32)], maps=[],
                   chunk_offset=[0], chunk_epoch=[0], chunk_counts=[4],
                   chunk_n=4, n_cascades=0)


def test_runtime_config_fields_flow_into_the_plan():
    x = np.random.default_rng(8).normal(size=(900, 2)).astype(np.float32)
    with runtime.configure(chunk_n=300, reservoir_n=400, prefetch_depth=1,
                           device="cpu"):
        res = repro_torch.fit(iter(chunked(x, 300)), 2, 2, k=3)
        plan = repro_torch.plan_fit(iter([x]), 2, 2)
    assert (plan.chunk_n, plan.reservoir_n, plan.prefetch_depth) == (300, 400, 1)
    assert res.spill.ingest_stats["reservoir_n"] == 400
    env = runtime.config_from_env({"REPRO_TORCH_CHUNK_N": "64",
                                   "REPRO_TORCH_RESERVOIR_N": "128",
                                   "REPRO_TORCH_PREFETCH_DEPTH": "2"})
    assert (env.chunk_n, env.reservoir_n, env.prefetch_depth) == (64, 128, 2)
    for bad in (dict(chunk_n=-1), dict(reservoir_n=-2), dict(prefetch_depth=-1)):
        with pytest.raises(ValueError):
            runtime.RuntimeConfig(**bad)


def test_stream_validation_errors():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(300, 2)).astype(np.float32)
    with pytest.raises(ValueError, match="rows > chunk_n"):
        stream_fit([x[:100], x], 2, 2, k=2, chunk_n=100)
    with pytest.raises(ValueError, match="expected"):
        stream_fit([x[:100], x[:100, :1]], 2, 2, k=2)
    with pytest.raises(ValueError, match="empty"):
        stream_fit([], 2, 2, k=2)
    with pytest.raises(ValueError, match="cannot absorb"):
        stream_fit([x], 2, 2, k=2, chunk_n=300, reservoir_n=160)
    with pytest.raises(ValueError, match="weights"):
        repro_torch.fit(iter([x]), 2, 2, weights=np.ones(300), device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        stream_fit([x], 2, 0, k=2)
    with pytest.raises(ValueError, match="prefetch_depth"):
        repro_torch.fit(x, 2, 1, prefetch_depth=2, device="cpu")
    with pytest.raises(ValueError, match="no valid rows"):
        stream_fit([(x[:100], 0), (x[100:200], 0)], 2, 2, k=2)
    with pytest.raises(ValueError, match="n_valid"):
        stream_fit([(x[:100], 101)], 2, 2, k=2)


def _prefetch_threads():
    return [th for th in threading.enumerate()
            if th.name == _PREFETCH_THREAD_NAME and th.is_alive()]


def test_prefetch_fault_mid_stream_shuts_down_cleanly():
    x = np.random.default_rng(10).normal(size=(512, 2)).astype(np.float32)
    bad = np.zeros((300, 2), np.float32)

    def stream():
        yield x[:256]
        yield x[256:512]
        yield bad

    with pytest.raises(ValueError, match="rows > chunk_n") as serial:
        ihtc_streaming(stream(), 2, 2, k=3, chunk_n=256, prefetch_depth=0,
                       device="cpu")
    with pytest.raises(ValueError, match="rows > chunk_n") as piped:
        ihtc_streaming(stream(), 2, 2, k=3, chunk_n=256, prefetch_depth=2,
                       device="cpu")
    assert str(piped.value) == str(serial.value)
    assert _prefetch_threads() == []

    def exploding():
        yield x[:256]
        raise RuntimeError("source died")

    with pytest.raises(RuntimeError, match="source died"):
        ihtc_streaming(exploding(), 2, 2, k=3, chunk_n=256, prefetch_depth=2,
                       device="cpu")
    assert _prefetch_threads() == []


def test_hole_heavy_reservoir_compacts():
    """Near-duplicate chunks collapse to a few clusters each, so the
    reservoir fills with holes and is compacted instead of reduced (as in
    the reference's test; the points sit 1e-4 apart, so the TC's
    near-ties make it no bitwise case): the back-out stays exact."""
    rng = np.random.default_rng(12)
    base = rng.normal(size=(1, 2)).astype(np.float32)
    chunks = [base + 1e-4 * rng.normal(size=(30, 2)).astype(np.float32)
              for _ in range(6)]
    got = stream_fit(chunks, 3, 2, k=1, chunk_n=30, reservoir_n=15,
                     key=prng.PRNGKey(0))
    finalize_maps = len(got.spill.ingest_stats["finalize_n_valid"])
    compactions = len(got.spill.maps) - finalize_maps - got.n_cascades
    assert compactions >= 1
    lab = got.labels()
    assert lab.shape == (180,) and lab.min() >= 0
    mass = got.proto_mass.numpy()[got.proto_valid.numpy()]
    assert abs(mass.sum() - 180) < 1e-2


def test_staging_pool_rezeroes_stale_tails():
    from repro_torch.core.streaming import _StagingPool

    pool = _StagingPool(1, 6, 2, pin=False)
    i = pool.stage(np.ones((5, 2), np.float32))
    pool.release(i)
    i = pool.stage(np.full((2, 2), 3.0, np.float32))
    np.testing.assert_array_equal(pool.buffer(i).numpy(),
                                  np.array([[3, 3], [3, 3]] + [[0, 0]] * 4,
                                           np.float32))
