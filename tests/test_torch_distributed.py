"""The sharded fit of the port (``repro_torch.core.distributed``) on gloo
ranks on the CPU, against the single-device port and the reference.

Ranks are spawned processes (``repro_torch.launch.mesh.spawn_ranks``: a
``file://`` rendezvous in ``tmp_path``, a timeout on every collective and
on the whole run, an error if any rank fails). One spawn per rank count
runs every check (tests/torch_dist_ranks.py), and each test reads its part:

  * ``ring_knn`` against the port's ``knn_graph`` and the reference's:
    indices equal, distances within DIST_TOL, bitwise on a dyadic grid;
  * the ordered K3 fold bitwise ``ops.blocked_segment_sum``; ``tc_sharded``
    bitwise ``threshold_clustering``; ``kmeans_sharded`` bitwise ``kmeans``;
  * ``fit(..., mesh=)`` at the reference's n = 576, t 3, m 2, k 3, key 7:
    bitwise the port's memory executor on every rank (also through
    ``runtime.configure(mesh=)``, ``ihtc_sharded`` and ``ihtc``), and the
    reference's single-device labels with its prototypes within 1e-5 (the
    reference's own ``ihtc_sharded`` is no oracle for bits: under jax 0.9
    it does not keep its single-device prototype bits);
  * the padded path (n = 500, t 2, m 3): the mass sums to n, every cluster
    holds at least t^m units;
  * ``stream_to_mesh`` against the concatenated chunks, and a fit of its
    output bitwise the memory executor;
  * ``streaming_sharded`` bitwise ``streaming`` on an aligned stream (every
    static size a multiple of the shard multiple, one cascade), and a
    hole-heavy stream compacted under the mesh;
  * the mesh assign (100 queries: the pad path) bitwise the one-device
    assign, directly and through a service warmed under the mesh;
  * ``knn_block=`` with a mesh, and NCCL with two ranks on one card, raise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_ranks as ranks
from conftest import gmm_sample

import repro
import repro_torch
from repro.core import knn as j_knn
from repro_torch import prng
from repro_torch.cluster.kmeans import kmeans
from repro_torch.core.distributed import make_data_mesh
from repro_torch.core.index import ClusterIndex
from repro_torch.core.knn import knn_graph
from repro_torch.core.tc import threshold_clustering
from repro_torch.kernels import ops
from repro_torch.launch.mesh import spawn_ranks

torch.set_num_threads(1)

#: distances of two f32 routes of the same pair (chip_smoke.DIST_TOL)
DIST_TOL = dict(rtol=1e-5, atol=1e-4)
#: prototypes against the reference's fit (test_torch_tc_itis's tolerance)
PROTO_TOL = dict(rtol=1e-5, atol=1e-5)
#: seconds a spawn may take, start-up of every rank included
LIMIT_S = 120.0


def _inputs():
    rng = np.random.default_rng(0)
    knn_x = rng.normal(size=(96, 3)).astype(np.float32)
    knn_dyadic = (rng.integers(-8, 9, size=(96, 3)) * 0.25).astype(np.float32)
    knn_valid = rng.random(96) > 0.1
    seg_x = rng.normal(size=(96, 3)).astype(np.float32)
    seg_ids = rng.integers(-1, 13, size=96).astype(np.int64)
    seg_w = rng.integers(1, 4, size=96).astype(np.float32)
    tc_x = rng.normal(size=(128, 2)).astype(np.float32)
    tc_valid = rng.random(128) > 0.05
    km_x = rng.normal(size=(64, 2)).astype(np.float32)
    km_valid = rng.random(64) > 0.1
    km_w = rng.integers(1, 5, size=64).astype(np.float32)
    fit_x, _ = gmm_sample(576, np.random.default_rng(0))
    pad_x, _ = gmm_sample(500, np.random.default_rng(1))
    stream_x, _ = gmm_sample(768, np.random.default_rng(2))
    queries = rng.normal(loc=4.0, scale=3.0, size=(100, 2)).astype(np.float32)
    hrng = np.random.default_rng(12)
    base = hrng.normal(size=(1, 2)).astype(np.float32)
    hole_chunks = [base + 1e-4 * hrng.normal(size=(30, 2)).astype(np.float32)
                   for _ in range(6)]
    return dict(knn_x=knn_x, knn_dyadic=knn_dyadic, knn_valid=knn_valid, knn_k=3,
                seg_x=seg_x, seg_ids=seg_ids, seg_w=seg_w, seg_S=12,
                tc_x=tc_x, tc_valid=tc_valid, tc_t=3, tc_seed=5,
                km_x=km_x, km_valid=km_valid, km_w=km_w,
                fit_x=fit_x, pad_x=pad_x, stream_x=stream_x, queries=queries,
                hole_chunks=hole_chunks)


INP = _inputs()


@pytest.fixture(scope="module", params=[2, 4])
def spawned(request, tmp_path_factory):
    """(P, every rank's results) of one spawn of ``all_checks``."""
    p = request.param
    outs = spawn_ranks(ranks.all_checks, p, backend="gloo", device="cpu",
                       init_dir=str(tmp_path_factory.mktemp(f"ranks{p}")),
                       args=(INP,), timeout=LIMIT_S)
    assert [o["rank"] for o in outs] == list(range(p))
    assert all(o["size"] == p for o in outs)
    return p, outs


@pytest.fixture(scope="module")
def memory_fit():
    return repro_torch.fit(INP["fit_x"], 3, 2, "kmeans", k=3, key=prng.PRNGKey(7),
                           device="cpu")


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8))


def _same_fit(got: dict, want):
    for f in ("protos", "proto_mass", "proto_valid", "proto_labels", "n_prototypes"):
        _same(got[f], getattr(want, f).numpy())
    _same(got["labels"], np.asarray(want.labels))
    _same(got["centers"], want.backend_result.centers.numpy())


@pytest.mark.parametrize("name", ["knn_x", "knn_dyadic"])
def test_ring_knn_matches_knn_graph(spawned, name):
    _, outs = spawned
    x = torch.from_numpy(INP[name])
    v = torch.from_numpy(INP["knn_valid"])
    want_d, want_i = knn_graph(x, INP["knn_k"], valid=v)
    jd, ji = j_knn.knn_graph(jnp.asarray(INP[name]), INP["knn_k"],
                             valid=jnp.asarray(INP["knn_valid"]), impl="ref")
    for o in outs:
        d, i = o[name]
        np.testing.assert_array_equal(i, want_i.numpy())
        np.testing.assert_array_equal(i, np.asarray(ji))
        np.testing.assert_allclose(d, want_d.numpy(), **DIST_TOL)
        np.testing.assert_allclose(d, np.asarray(jd), **DIST_TOL)
        if name == "knn_dyadic":  # every sum exact: the same bits
            _same(d, want_d.numpy())
            _same(d, np.asarray(jd))


def test_folded_segment_sum_is_the_blocked_fold(spawned):
    _, outs = spawned
    want = ops.blocked_segment_sum(torch.from_numpy(INP["seg_x"]),
                                   torch.from_numpy(INP["seg_ids"]), INP["seg_S"],
                                   weights=torch.from_numpy(INP["seg_w"]), n_blocks=8)
    for o in outs:
        _same(o["segsum"][0], want[0].numpy())
        _same(o["segsum"][1], want[1].numpy())


def test_tc_sharded_is_threshold_clustering(spawned):
    _, outs = spawned
    want = threshold_clustering(torch.from_numpy(INP["tc_x"]), INP["tc_t"],
                                valid=torch.from_numpy(INP["tc_valid"]),
                                key=prng.PRNGKey(INP["tc_seed"]))
    for o in outs:
        for got, w in zip(o["tc"][:4], want[:4]):
            _same(got, w.numpy())
        assert o["tc"][4] == want.mis_rounds


def test_kmeans_sharded_is_kmeans(spawned):
    _, outs = spawned
    want = kmeans(torch.from_numpy(INP["km_x"]), 3,
                  valid=torch.from_numpy(INP["km_valid"]),
                  weights=torch.from_numpy(INP["km_w"]), key=prng.PRNGKey(3))
    for o in outs:
        centers, labels, inertia, iters = o["kmeans"]
        _same(centers, want.centers.numpy())
        _same(labels, want.labels.numpy())
        _same(inertia, want.inertia.numpy())
        assert iters == want.iters


def test_sharded_fit_is_the_memory_fit(spawned, memory_fit):
    p, outs = spawned
    for o in outs:
        assert o["fit_executor"] == "sharded"
        assert o["fit_info"]["shards"] == p
        assert o["fit_info"]["level_sizes"] == [576, 192, 64]
        assert o["fit_info"]["mis_rounds"] == memory_fit.info["mis_rounds"]
        for way in ("fit", "fit_configured", "fit_ihtc_sharded", "fit_ihtc"):
            _same_fit(o[way], memory_fit)


def test_sharded_fit_matches_the_reference():
    want = repro.fit(jnp.asarray(INP["fit_x"]), 3, 2, "kmeans", k=3,
                     key=jax.random.PRNGKey(7))
    got = repro_torch.fit(INP["fit_x"], 3, 2, "kmeans", k=3, key=prng.PRNGKey(7),
                          device="cpu")
    # the sharded fit is this fit bit for bit (the test above); here the
    # memory fit against the reference's single-device one
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert int(got.n_prototypes) == int(want.n_prototypes)
    np.testing.assert_allclose(got.protos.numpy(), np.asarray(want.protos),
                               **PROTO_TOL)


def test_knn_block_with_a_mesh_raises(spawned):
    _, outs = spawned
    for o in outs:
        assert "ring pass" in o["knn_block_raises"]


def test_padded_fit_keeps_the_guarantees(spawned):
    p, outs = spawned
    t, m, n = 2, 3, 500
    for o in outs:
        info = o["padded_info"]
        assert info["level_sizes"][0] == 504 and all(s % 8 == 0 for s in info["level_sizes"])
        lab = o["padded"]["labels"]
        assert lab.shape == (n,) and lab.min() >= 0
        sizes = np.bincount(lab)
        assert sizes[sizes > 0].min() >= t ** m
        assert abs(float(o["padded"]["proto_mass"].sum()) - n) <= 1e-3
        _same_fit_fields = ("labels", "protos", "proto_mass")
        for f in _same_fit_fields:  # every rank the same result
            _same(o["padded"][f], outs[0]["padded"][f])


def test_stream_to_mesh_is_the_concatenated_chunks(spawned, memory_fit):
    _, outs = spawned
    for o in outs:
        shape, x, v = o["stream_to_mesh"]
        assert shape == (576, 2)
        _same(x, INP["fit_x"])
        assert v.all()
        shape, x, v = o["stream_ragged"]
        assert shape == (504, 2)
        _same(x[:500], INP["pad_x"])
        assert not x[500:].any() and v[:500].all() and not v[500:].any()
        _same_fit(o["fit_streamed"], memory_fit)


def test_streaming_sharded_is_streaming(spawned):
    _, outs = spawned
    sx = INP["stream_x"]
    want = repro_torch.fit(iter([sx[i:i + 256] for i in range(0, 768, 256)]),
                           2, 3, "kmeans", k=3, key=prng.PRNGKey(7),
                           reservoir_n=256, device="cpu")
    assert want.n_cascades == 1
    for o in outs:
        assert o["streaming_executor"] == "streaming_sharded"
        assert o["streaming_cascades"] == 1
        _same_fit(o["streaming_sharded"], want)


def test_hole_heavy_sharded_stream_compacts(spawned):
    _, outs = spawned
    for o in outs:
        h = o["hole"]
        assert h["compactions"] >= 1
        assert h["labels"].shape == (180,) and h["labels"].min() >= 0
        assert abs(float(h["mass"].sum()) - 180) < 1e-2
        _same(h["labels"], outs[0]["hole"]["labels"])


def test_mesh_assign_is_the_one_device_assign(spawned, memory_fit):
    _, outs = spawned
    want = ClusterIndex.build(memory_fit).assign(torch.from_numpy(INP["queries"]))
    for o in outs:
        _same(o["assign"], want.numpy())
        _same(o["assign_service"], want.numpy())


def test_sharded_fit_at_eight_ranks(tmp_path, memory_fit):
    outs = spawn_ranks(ranks.fit_only, 8, backend="gloo", device="cpu",
                       init_dir=str(tmp_path), args=({"fit_x": INP["fit_x"]},),
                       timeout=LIMIT_S)
    for o in outs:
        _same_fit(o, memory_fit)


def test_a_failed_rank_fails_the_spawn(tmp_path):
    with pytest.raises(RuntimeError, match="planted failure on rank 1"):
        spawn_ranks(ranks.fails_on_rank_1, 2, backend="gloo", device="cpu",
                    init_dir=str(tmp_path), timeout=LIMIT_S)


def test_nccl_with_two_ranks_on_one_card_raises(tmp_path, monkeypatch):
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="Duplicate GPU"):
        spawn_ranks(ranks.fit_only, cards + 1, backend="nccl", device="cuda",
                    init_dir=str(tmp_path), args=({},))
    # a torchrun launch of more ranks than cards, before any group exists
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", str(cards + 1))
    with pytest.raises(ValueError, match="Duplicate GPU"):
        make_data_mesh(backend="nccl", device_type="cuda")
