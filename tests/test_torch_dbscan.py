"""The port's DBSCAN (``repro_torch.cluster.dbscan``) against the JAX
package's.

The same numpy inputs go through ``repro.cluster.dbscan.dbscan`` (on the
CPU, ``impl="ref"``, and ``impl="pallas"``: K4's Pallas kernel in
interpret mode) and through the port's plain path. With integer masses the
weighted density is exact in any order, so labels and core flags are
bitwise, whether the port forms the density and the masked minima in one
block of rows or in many. Then the naive oracle of
``test_cluster_oracle.py``: mass = replication, masked rows inert, and
all noise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_cluster_oracle import naive_dbscan, partition

from repro.cluster.dbscan import dbscan as j_dbscan
from repro_torch.cluster import dbscan as dbscan_mod
from repro_torch.cluster.dbscan import dbscan

torch.set_num_threads(1)


def dyadic(rng, shape, lim=6):
    return (rng.integers(-lim, lim + 1, size=shape) * 0.25).astype(np.float32)


def both(x, eps, min_pts, valid=None, weights=None, impl="ref"):
    j = j_dbscan(jnp.asarray(x), eps, min_pts, impl=impl,
                 valid=None if valid is None else jnp.asarray(valid),
                 weights=None if weights is None else jnp.asarray(weights))
    t = dbscan(torch.from_numpy(x), eps, min_pts, impl="ref",
               valid=None if valid is None else torch.from_numpy(valid),
               weights=None if weights is None else torch.from_numpy(weights))
    return j, t


def assert_same(j, t):
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels))
    np.testing.assert_array_equal(t.is_core.numpy(), np.asarray(j.is_core))
    assert t.labels.dtype == torch.int32 and t.rounds >= 1


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kind", ["dyadic", "continuous"])
def test_dbscan_bitwise(kind, weighted, masked):
    rng = np.random.default_rng(1 + 10 * weighted + 100 * masked)
    x = (dyadic(rng, (64, 2)) if kind == "dyadic"
         else rng.normal(size=(64, 3)).astype(np.float32))
    w = rng.integers(1, 5, size=64).astype(np.float32) if weighted else None
    v = (rng.random(64) > 0.2) if masked else None
    # eps 0.5 on the dyadic grid puts many pairs exactly on eps²
    eps = 0.5 if kind == "dyadic" else 0.7
    j, t = both(x, eps, 4.0, valid=v, weights=w)
    assert_same(j, t)


@pytest.mark.parametrize("rows", [1, 7, 64])
def test_dbscan_row_blocks_change_nothing(monkeypatch, rows):
    """The density and masked minima a block of rows at a time: any block
    size gives the one-block bits."""
    rng = np.random.default_rng(5)
    x = dyadic(rng, (50, 2))
    w = rng.integers(1, 4, size=50).astype(np.float32)
    want = dbscan(torch.from_numpy(x), 0.5, 5.0, weights=torch.from_numpy(w))
    monkeypatch.setattr(dbscan_mod, "BLOCK_ELEMENTS", rows * 50)
    got = dbscan(torch.from_numpy(x), 0.5, 5.0, weights=torch.from_numpy(w))
    assert torch.equal(got.labels, want.labels)
    assert torch.equal(got.is_core, want.is_core)
    assert got.rounds == want.rounds


def test_dbscan_matches_pallas_route():
    rng = np.random.default_rng(9)
    x = dyadic(rng, (40, 3))
    w = rng.integers(1, 4, size=40).astype(np.float32)
    j, t = both(x, 0.75, 5.0, weights=w, impl="pallas")
    assert_same(j, t)


def test_dbscan_eps_rounds_like_the_reference():
    """eps² in f32 (the reference's traced scalar), not in float64: a
    pair at exactly 0.1² in f32 arithmetic is a neighbour in both."""
    x = np.array([[0.0], [0.1], [0.3]], np.float32)
    for eps in (0.1, 0.2, 1 / 3):
        j, t = both(x, eps, 2.0)
        assert_same(j, t)


def test_dbscan_matches_naive_reference(rng):
    x = rng.normal(size=(24, 2)).astype(np.float32)
    got = dbscan(torch.from_numpy(x), 0.8, 3.0).labels.numpy()
    np.testing.assert_array_equal(got, naive_dbscan(x, 0.8, 3.0))


def test_dbscan_weighted_matches_naive_reference(rng):
    x = rng.normal(size=(20, 2)).astype(np.float32)
    w = rng.integers(1, 5, size=20).astype(np.float32)
    r = dbscan(torch.from_numpy(x), 0.7, 4.0, weights=torch.from_numpy(w))
    np.testing.assert_array_equal(r.labels.numpy(), naive_dbscan(x, 0.7, 4.0, weights=w))
    d = np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1))
    np.testing.assert_array_equal(r.is_core.numpy(), (w[None, :] * (d <= 0.7)).sum(1) >= 4.0)


def test_dbscan_mass_equals_replication(rng):
    x = rng.normal(scale=0.5, size=(10, 2)).astype(np.float32)
    w = np.array([4, 1, 1, 1, 2, 1, 1, 1, 1, 1], np.float32)
    got = dbscan(torch.from_numpy(x), 0.6, 3.0,
                 weights=torch.from_numpy(w)).labels.numpy()
    rep = np.repeat(np.arange(10), w.astype(int))
    want_rep = naive_dbscan(x[rep], 0.6, 3.0)
    want = np.array([want_rep[np.flatnonzero(rep == i)[0]] for i in range(10)])
    assert partition(got) == partition(want)
    np.testing.assert_array_equal(got == -1, want == -1)


def test_dbscan_masked_rows_are_inert(rng):
    x = rng.normal(size=(15, 2)).astype(np.float32)
    xp = torch.from_numpy(np.vstack([x, np.zeros((5, 2), np.float32)]))
    valid = torch.tensor([True] * 15 + [False] * 5)
    lab = dbscan(xp, 0.8, 3.0, valid=valid).labels.numpy()
    assert (lab[15:] == -1).all()
    np.testing.assert_array_equal(lab[:15], naive_dbscan(x, 0.8, 3.0))


def test_dbscan_all_noise(rng):
    x = (rng.normal(size=(30, 2)) * 100).astype(np.float32)
    j, t = both(x, 0.01, 2.0)
    assert_same(j, t)
    assert (t.labels.numpy() == -1).all() and not t.is_core.any()
    assert t.rounds == 1
