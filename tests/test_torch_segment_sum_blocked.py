"""K3's blocked entry point on the CPU against the JAX package's.

``repro_torch.kernels.segment_sum.blocked_segment_sum`` is one kernel call
on the card for the whole ``n_blocks`` fold; handed CPU tensors it runs its
plain version, which is what runs here. Both it and ``ops.blocked_segment_sum``
under every impl are held bit for bit against
``repro.kernels.ops.blocked_segment_sum`` run eagerly (op by op, XLA:CPU's
scatter folds rows in row order, as ``index_add_`` does), on dyadic grids
(every sum exact) and on continuous data (where any other fold order
shows). The kernel's own bits are held against the same plain version on
the card by ``chip_smoke.py``'s kernels phase. The wrapper's host logic
(the path choice and the row -> block formula) is tested as pure functions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref
from repro_torch.kernels import segment_sum as seg

torch.set_num_threads(1)


def _inputs(rng, n, d, s, weighted, exact):
    x = ((rng.integers(-16, 17, size=(n, d)) * 0.25) if exact
         else rng.normal(size=(n, d))).astype(np.float32)
    ids = rng.integers(-1, s + 1, size=n).astype(np.int64)
    special = np.array([-5, s, s + 7, 2 ** 31 + 3, 2 ** 33 + 1], dtype=np.int64)
    ids[:min(n, special.size)] = special[:min(n, special.size)]
    w = None
    if weighted:
        w = ((rng.integers(1, 5, size=n) * 0.5) if exact
             else rng.random(n) + 0.5).astype(np.float32)
    return x, ids, w


def _jax_blocked(x, ids, s, w, n_blocks):
    # JAX holds ids as int32: give it the ids clipped to [-1, S], which
    # drops the same rows as the int64 ids above 2^31 do
    jids = jnp.asarray(np.clip(ids, -1, s).astype(np.int32))
    return jops.blocked_segment_sum(jnp.asarray(x), jids, s,
                                    weights=None if w is None else jnp.asarray(w),
                                    n_blocks=n_blocks, impl="ref")


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("s_kind", ["1", "3", "n"])
@pytest.mark.parametrize("n_kind", ["1", "nb-1", "1000", "4099"])
@pytest.mark.parametrize("n_blocks", [1, 2, 3, 8])
def test_blocked_segment_sum_matches_reference(rng, n_blocks, n_kind, s_kind,
                                               weighted):
    n = {"1": 1, "nb-1": n_blocks - 1, "1000": 1000, "4099": 4099}[n_kind]
    s = {"1": 1, "3": 3, "n": max(n, 1)}[s_kind]
    d = 3
    for exact in (True, False):
        x, ids, w = _inputs(rng, n, d, s, weighted, exact)
        want_s, want_m = (np.asarray(a) for a in _jax_blocked(x, ids, s, w, n_blocks))
        tw = None if w is None else torch.from_numpy(w)
        tx, tids = torch.from_numpy(x), torch.from_numpy(ids)
        got = [seg.blocked_segment_sum(tx, tids, s, tw, n_blocks=n_blocks),
               seg.blocked_segment_sum(tx, tids.clamp(-1, s).to(torch.int32),
                                       s, tw, n_blocks=n_blocks)]
        for impl in ("ref", "cuda", "auto"):
            got.append(ops.blocked_segment_sum(tx, tids, s, weights=tw,
                                               n_blocks=n_blocks, impl=impl))
        for gs, gm in got:
            assert gs.shape == (s, d) and gm.shape == (s,)
            np.testing.assert_array_equal(gs.numpy(), want_s)
            np.testing.assert_array_equal(gm.numpy(), want_m)


@pytest.mark.parametrize("n,n_blocks", [
    (1, 1), (1, 8), (7, 8), (8, 8), (9, 8), (53, 3), (1000, 8), (4099, 8),
    (581_012, 8), (2208, 8), (100, 1),
])
def test_row_to_block_formula_is_the_reference_padding(n, n_blocks):
    # the reference right-pads to a multiple of n_blocks and slices equal
    # blocks; the kernel puts row r in block r // nb, nb = ceil(n / n_blocks)
    _, nb = seg.plan(n, 10, n_blocks)
    pad = (-n) % n_blocks
    ref_nb = (n + pad) // n_blocks
    assert nb == ref_nb
    rows = np.arange(n)
    ref_block = np.repeat(np.arange(n_blocks), ref_nb)[:n]
    np.testing.assert_array_equal(rows // nb, ref_block)
    assert -(-n // nb) <= n_blocks  # the blocks that hold rows


@pytest.mark.parametrize("s,path", [
    (1, "few"), (3, "few"), (7, "few"), (64, "few"), (65, "many"),
    (1104, "many"), (193_670, "many"),
])
def test_path_choice_by_segment_count(s, path):
    assert seg.plan(1000, s, 8)[0] == path
    assert seg.FEW_SEGMENTS == 64


def test_segment_sum_is_the_one_block_case(rng):
    x, ids, w = _inputs(rng, 500, 4, 40, True, False)
    tx, tids, tw = map(torch.from_numpy, (x, ids, w))
    a = seg.segment_sum(tx, tids, 40, tw)
    b = seg.blocked_segment_sum(tx, tids, 40, tw, n_blocks=1)
    c = ref.segment_sum(tx, tids, 40, weights=tw)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    for u, v in zip(a, c):
        assert torch.equal(u, v)


def test_plain_blocked_version_sums_blocks_left_to_right(rng):
    # the plain version's partials, added in block order, by hand
    x, ids, w = _inputs(rng, 1001, 2, 30, True, False)
    tx, tids, tw = map(torch.from_numpy, (x, ids, w))
    got_s, got_m = ref.blocked_segment_sum(tx, tids, 30, weights=tw, n_blocks=8)
    nb = -(-1001 // 8)
    want_s = want_m = None
    for b in range(8):
        sl = slice(b * nb, (b + 1) * nb)
        ps, pm = ref.segment_sum(tx[sl], tids[sl], 30, weights=tw[sl])
        want_s = ps if want_s is None else want_s + ps
        want_m = pm if want_m is None else want_m + pm
    assert torch.equal(got_s, want_s) and torch.equal(got_m, want_m)


def test_cpu_call_counts_no_launch(rng):
    before = seg.blocked_segment_sum.launches
    x, ids, w = _inputs(rng, 50, 2, 5, True, True)
    seg.blocked_segment_sum(*map(torch.from_numpy, (x, ids)), 5,
                            torch.from_numpy(w), n_blocks=8)
    assert seg.blocked_segment_sum.launches == before
