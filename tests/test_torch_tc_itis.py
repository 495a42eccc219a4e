"""TC, prototype reduce and ITIS of the port against the JAX package, with
the same key, on dyadic-grid points (every distance exact in f32, ties
common): all outputs bit for bit, on both the one-shot and the blocked
kNN paths. Plus TC's invariants (size ≥ t, seeds independent in NG²).

From the second ITIS level on, the points are centroids and no longer on
the grid, so the order of the 8-block segment-sum fold shows in the last
bit. The reference pins that order (``blocked_segment_sum``), but under
``jit`` XLA:CPU does not keep its rounding, so multi-level comparisons use
a one-block fold (``n_blocks=1``: one row-order fold on both sides). The
8-block fold itself is held bit for bit against the reference run op by
op in test_torch_kernels.py.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import prototypes as j_proto
from repro.core import tc as j_tc
from repro_torch import prng
from repro_torch.core import itis as t_itis
from repro_torch.core import prototypes as t_proto
from repro_torch.core import tc as t_tc
from repro_torch.core.knn import knn_graph

torch.set_num_threads(1)

# the module, not the function that repro.core re-exports under its name
j_itis = importlib.import_module("repro.core.itis")


def dyadic(rng, shape, scale=0.25, lim=16):
    return (rng.integers(-lim, lim + 1, size=shape) * scale).astype(np.float32)


def keys(seed):
    k = jax.random.PRNGKey(seed)
    return k, prng.key_from_numpy(np.asarray(k))


def assert_same(got, want):
    np.testing.assert_array_equal(got.cpu().numpy(), np.asarray(want))


@pytest.mark.parametrize("n,t,knn_block,masked", [
    (120, 2, 0, False),
    (120, 3, 0, True),
    (300, 3, 64, False),   # blocked kNN, n not a multiple of the block
    (300, 2, 64, True),
    (97, 4, 32, False),
])
def test_threshold_clustering_bitwise(rng, n, t, knn_block, masked):
    x = dyadic(rng, (n, 2))
    v = (rng.random(n) > 0.2) if masked else np.ones(n, bool)
    jk, tk = keys(n + t)
    want = j_tc.threshold_clustering(jnp.asarray(x), t, valid=jnp.asarray(v),
                                     key=jk, knn_block=knn_block, impl="ref")
    for impl in ("auto", "fused"):
        got = t_tc.threshold_clustering(torch.from_numpy(x), t,
                                        valid=torch.from_numpy(v), key=tk,
                                        knn_block=knn_block, impl=impl)
        for f in ("labels", "seed_of", "is_seed", "n_clusters"):
            assert_same(getattr(got, f), getattr(want, f))
        assert got.labels.dtype == torch.int32 and got.seed_of.dtype == torch.int32
        assert got.mis_rounds >= 1


@pytest.mark.parametrize("t", [2, 3])
def test_tc_invariants(rng, t):
    """Every valid point is labelled, every cluster has ≥ t members, and no
    two seeds lie within undirected graph distance 2 of NG."""
    n = 200
    x = rng.normal(size=(n, 2)).astype(np.float32)
    _, tk = keys(7)
    xt = torch.from_numpy(x)
    r = t_tc.threshold_clustering(xt, t, key=tk)
    lab = r.labels.numpy()
    nc = int(r.n_clusters)
    assert lab.min() >= 0 and lab.max() == nc - 1
    assert np.bincount(lab, minlength=nc).min() >= t
    _, idx = knn_graph(xt, t - 1)
    adj = np.zeros((n, n), bool)
    for i, row in enumerate(idx.numpy()):
        for j in row[row >= 0]:
            adj[i, j] = adj[j, i] = True
    two_hop = adj | ((adj.astype(int) @ adj.astype(int)) > 0)
    seeds = np.nonzero(r.is_seed.numpy())[0]
    assert not two_hop[np.ix_(seeds, seeds)][~np.eye(len(seeds), dtype=bool)].any()


@pytest.mark.parametrize("t,d,grid", [(2, 2, True), (3, 2, True), (2, 16, False)])
def test_threshold_clustering_heads_equals_each_set_alone(rng, t, d, grid):
    """TC over H point sets at once (the KV compression's heads of one
    layer) gives each set the labels and cluster count that
    ``threshold_clustering`` gives it alone with the same key, bit for bit
    (on the grid, ties common; off it, distances of every rounding), with
    a different valid mask per set."""
    H, n = 5, 120
    x = dyadic(rng, (H, n, d)) if grid else rng.normal(size=(H, n, d)).astype(np.float32)
    v = rng.random((H, n)) > 0.15
    v[0] = True
    _, tk = keys(11)
    pri = t_tc.seed_priorities(tk, n)
    labels, n_clusters, rounds = t_tc.threshold_clustering_heads(
        torch.from_numpy(x), t, valid=torch.from_numpy(v), priorities=pri)
    assert labels.dtype == torch.int32 and labels.shape == (H, n)
    most = 0
    for h in range(H):
        one = t_tc.threshold_clustering(torch.from_numpy(x[h]), t,
                                        valid=torch.from_numpy(v[h]), key=tk)
        assert torch.equal(labels[h], one.labels), h
        assert int(n_clusters[h]) == int(one.n_clusters), h
        most = max(most, one.mis_rounds)
    assert rounds == most


def test_tc_t1_degenerate(rng):
    x = dyadic(rng, (10, 2))
    v = np.array([True] * 7 + [False] * 3)
    jk, tk = keys(0)
    want = j_tc.threshold_clustering(jnp.asarray(x), 1, valid=jnp.asarray(v), key=jk)
    got = t_tc.threshold_clustering(torch.from_numpy(x), 1,
                                    valid=torch.from_numpy(v), key=tk)
    for f in ("labels", "seed_of", "is_seed", "n_clusters"):
        assert_same(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("weighted", [False, True])
def test_reduce_to_prototypes_bitwise(rng, weighted):
    n, n_max = 90, 30
    x = dyadic(rng, (n, 3))
    labels = rng.integers(-1, n_max, size=n).astype(np.int32)
    w = (rng.integers(1, 4, size=n)).astype(np.float32)
    want = j_proto.reduce_to_prototypes(jnp.asarray(x), jnp.asarray(labels), n_max,
                                        weights=jnp.asarray(w), weighted=weighted,
                                        impl="ref")
    got = t_proto.reduce_to_prototypes(torch.from_numpy(x), torch.from_numpy(labels),
                                       n_max, weights=torch.from_numpy(w),
                                       weighted=weighted)
    for a, b in zip(got, want):
        assert_same(a, b)


def test_compose_assignments_and_standardize(rng):
    levels = [rng.integers(-1, 6, size=20).astype(np.int32),
              rng.integers(-1, 3, size=6).astype(np.int32)]
    final = rng.integers(-1, 2, size=3).astype(np.int32)
    want = j_proto.compose_assignments([jnp.asarray(a) for a in levels],
                                       jnp.asarray(final))
    got = t_proto.compose_assignments([torch.from_numpy(a) for a in levels],
                                      torch.from_numpy(final))
    assert_same(got, want)
    x = rng.normal(size=(50, 3)).astype(np.float32)
    v = rng.random(50) > 0.3
    for vv in (None, v):
        w = j_proto.standardize(jnp.asarray(x), None if vv is None else jnp.asarray(vv))
        g = t_proto.standardize(torch.from_numpy(x),
                                None if vv is None else torch.from_numpy(vv))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t,weighted,knn_block", [(2, False, 0), (3, True, 64)])
def test_itis_step_bitwise(rng, t, weighted, knn_block):
    n = 240
    x = dyadic(rng, (n, 2))
    mass = rng.integers(1, 3, size=n).astype(np.float32)
    v = rng.random(n) > 0.1
    jk, tk = keys(3)
    want = j_itis.itis_step(jnp.asarray(x), jnp.asarray(mass), jnp.asarray(v), t,
                            key=jk, weighted=weighted, knn_block=knn_block,
                            impl="ref")
    got = t_itis.itis_step(torch.from_numpy(x), torch.from_numpy(mass),
                           torch.from_numpy(v), t, key=tk, weighted=weighted,
                           knn_block=knn_block)
    for f in ("protos", "mass", "valid", "assignment", "n_clusters"):
        assert_same(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("t,m,knn_block,n_blocks", [
    (2, 3, 0, 1), (3, 3, 0, 1), (3, 2, 64, 1), (2, 4, 64, 1),
    (2, 1, 64, 8), (3, 1, 0, 8),   # one level: the default 8-block fold
])
def test_itis_bitwise(rng, t, m, knn_block, n_blocks):
    n = 300
    x = dyadic(rng, (n, 2))
    jk, tk = keys(t * 10 + m)
    want = j_itis.itis(jnp.asarray(x), t, m, key=jk, knn_block=knn_block,
                       impl="ref", n_blocks=n_blocks)
    got = t_itis.itis(torch.from_numpy(x), t, m, key=tk, knn_block=knn_block,
                      n_blocks=n_blocks)
    for f in ("protos", "mass", "valid", "n_prototypes"):
        assert_same(getattr(got, f), getattr(want, f))
    assert len(got.assignments) == len(want.assignments)
    for a, b in zip(got.assignments, want.assignments):
        assert_same(a, b)
    assert len(got.mis_rounds) == len(got.assignments)


def test_level_sizes_and_validation():
    assert t_itis.level_sizes(581_012, 3, 5) == j_itis.level_sizes(581_012, 3, 5)
    assert t_itis.level_sizes(100, 3, 2, multiple=8) == \
        j_itis.level_sizes(100, 3, 2, multiple=8)
    for bad in (dict(t=1, m=2), dict(t=2.5, m=1), dict(t=2, m=-1)):
        with pytest.raises(ValueError):
            t_itis.validate_reduction_params(**bad)
    with pytest.raises(ValueError, match="t - 1 < n"):
        t_itis.validate_reduction_params(5, 1, n=4)
