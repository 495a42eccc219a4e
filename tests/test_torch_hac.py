"""The port's HAC (``repro_torch.cluster.hac``) against the JAX package's.

The same numpy inputs go through ``repro.cluster.hac.hac`` (on the CPU,
``impl="ref"``, and ``impl="pallas"``, whose (n, n) matrix is K4's Pallas
kernel in interpret mode) and through the port's plain path. The port
keeps the reference's float operations in its order, so labels and the
merge count are bitwise: on small-integer dyadic grids (many exact ties,
where the first-flat-index rule decides) and on continuous data. The
port is also held against the naive oracle of ``test_cluster_oracle.py``:
from-scratch member sets, mass = replication, masked rows inert.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_cluster_oracle import naive_hac, partition

from repro.cluster.hac import hac as j_hac
from repro_torch.cluster import hac as hac_mod
from repro_torch.cluster.hac import hac

torch.set_num_threads(1)

LINKAGES = ["single", "complete", "average", "ward"]


def dyadic(rng, shape, lim=6):
    return (rng.integers(-lim, lim + 1, size=shape) * 0.25).astype(np.float32)


def both(x, k, linkage, valid=None, weights=None, impl="ref"):
    """(JAX result, port result) on the same numpy inputs."""
    j = j_hac(jnp.asarray(x), k, linkage=linkage, impl=impl,
              valid=None if valid is None else jnp.asarray(valid),
              weights=None if weights is None else jnp.asarray(weights))
    t = hac(torch.from_numpy(x), k, linkage=linkage, impl="ref",
            valid=None if valid is None else torch.from_numpy(valid),
            weights=None if weights is None else torch.from_numpy(weights))
    return j, t


def assert_same(j, t):
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels))
    assert int(t.n_merges) == int(j.n_merges)
    assert t.labels.dtype == torch.int32


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("linkage", LINKAGES)
def test_hac_dyadic_bitwise(linkage, weighted, masked):
    rng = np.random.default_rng(LINKAGES.index(linkage) + 10 * weighted + 100 * masked)
    x = dyadic(rng, (48, 2))
    w = rng.integers(1, 5, size=48).astype(np.float32) if weighted else None
    v = (rng.random(48) > 0.2) if masked else None
    j, t = both(x, 4, linkage, valid=v, weights=w)
    assert_same(j, t)
    if masked:
        assert (t.labels.numpy()[~v] == -1).all()
    # the merge record: one (i < j) pair and its height per merge
    assert t.merges.shape == (int(t.n_merges), 2)
    assert bool((t.merges[:, 0] < t.merges[:, 1]).all())
    assert t.heights.shape == (int(t.n_merges),)


@pytest.mark.parametrize("linkage", LINKAGES)
def test_hac_matches_pallas_route(linkage):
    """The reference with K4 as its Pallas kernel (interpret mode)."""
    rng = np.random.default_rng(7)
    x = dyadic(rng, (40, 3))
    w = rng.integers(1, 4, size=40).astype(np.float32)
    j, t = both(x, 3, linkage, weights=w, impl="pallas")
    assert_same(j, t)


@pytest.mark.parametrize("linkage", LINKAGES)
def test_hac_continuous_matches_reference(linkage):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(64, 3)).astype(np.float32)
    w = rng.integers(1, 6, size=64).astype(np.float32)
    j, t = both(x, 5, linkage, weights=w)
    assert partition(t.labels.numpy()) == partition(np.asarray(j.labels))
    assert_same(j, t)


def test_hac_ties_take_the_first_flat_index():
    """A matrix full of ties: every point on a unit lattice. torch.argmin on
    the flattened matrix picks the first flat index, as jnp.argmin does,
    so the merge order (and so the labels) match."""
    g = np.stack(np.meshgrid(np.arange(5), np.arange(5)), -1).reshape(-1, 2)
    x = g.astype(np.float32)
    d = torch.cdist(torch.from_numpy(x), torch.from_numpy(x)) ** 2
    d.fill_diagonal_(torch.inf)
    assert int(torch.argmin(d)) == int(jnp.argmin(jnp.asarray(d.numpy())))
    for linkage in LINKAGES:
        j, t = both(x, 3, linkage)
        assert_same(j, t)


@pytest.mark.parametrize("linkage", LINKAGES)
def test_hac_matches_naive_reference(rng, linkage):
    x = rng.normal(size=(14, 3)).astype(np.float32)
    got = hac(torch.from_numpy(x), 4, linkage=linkage).labels.numpy()
    assert partition(got) == partition(naive_hac(x, 4, linkage))


@pytest.mark.parametrize("linkage", ["average", "ward"])
def test_hac_weighted_matches_naive_reference(rng, linkage):
    x = rng.normal(size=(12, 2)).astype(np.float32)
    w = rng.integers(1, 6, size=12).astype(np.float32)
    got = hac(torch.from_numpy(x), 3, linkage=linkage,
              weights=torch.from_numpy(w)).labels.numpy()
    assert partition(got) == partition(naive_hac(x, 3, linkage, weights=w))


@pytest.mark.parametrize("linkage", ["average", "ward"])
def test_hac_mass_equals_replication(rng, linkage):
    x = rng.normal(size=(8, 2)).astype(np.float32)
    w = np.array([3, 1, 1, 2, 1, 1, 1, 1], np.float32)
    got = hac(torch.from_numpy(x), 3, linkage=linkage,
              weights=torch.from_numpy(w)).labels.numpy()
    rep = np.repeat(np.arange(8), w.astype(int))
    want_rep = naive_hac(x[rep], 3, linkage)
    want = np.array([want_rep[np.flatnonzero(rep == i)[0]] for i in range(8)])
    assert partition(got) == partition(want)


def test_hac_masked_rows_are_inert(rng):
    x = rng.normal(size=(10, 2)).astype(np.float32)
    xp = torch.from_numpy(np.vstack([x, np.full((4, 2), 37.0, np.float32)]))
    valid = torch.tensor([True] * 10 + [False] * 4)
    lab = hac(xp, 3, linkage="complete", valid=valid).labels.numpy()
    assert (lab[10:] == -1).all()
    assert partition(lab[:10]) == partition(naive_hac(x, 3, "complete"))


def test_hac_degenerate_counts():
    x = torch.zeros((3, 2))
    r = hac(x, 5, valid=torch.zeros(3, dtype=torch.bool))  # nothing valid
    assert r.labels.tolist() == [-1, -1, -1] and int(r.n_merges) == 0
    r = hac(x, 1)
    assert r.labels.tolist() == [0, 0, 0] and int(r.n_merges) == 2
    with pytest.raises(ValueError, match="linkage"):
        hac(x, 2, linkage="median")


def test_merge_loop_updates_in_place_and_records_heights():
    """merge_loop is the device loop hac() runs after its one host read:
    the first merge is the closest pair, recorded with its height."""
    x = torch.tensor([[0.0, 0.0], [0.0, 1.0], [5.0, 5.0]])
    d = hac_mod._initial_matrix(x, torch.ones(3), "single", "ref")
    assign, alive, pairs, heights = hac_mod.merge_loop(d, torch.ones(3), "single", 1)
    assert pairs.tolist() == [[0, 1]] and heights.tolist() == [1.0]
    assert assign.tolist() == [0, 0, 2] and alive.tolist() == [True, False, True]
    assert bool(torch.isinf(d[1]).all()) and bool(torch.isinf(d[:, 1]).all())
