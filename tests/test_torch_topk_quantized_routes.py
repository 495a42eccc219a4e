"""K1's bf16 and int8 key instances on the tensor-core and split routes,
their arithmetic emulated on the CPU.

``csrc/topk.cu`` runs bf16 and int8 keys through the f32 routes: the
tensor-core route (d <= 32, k <= 8) and the CUDA-core split route
(d > 32, k <= 8). Neither can run here (no card, no nvcc). What can be
held here is what they compute, written out in torch:

  * the staging: a key element through ``key_at`` — bf16 widened exactly,
    int8 dequantized as a rounded multiply, then a rounded add,
    ``(q8 * scale) + zero`` (never one fused multiply-add); bf16 queries
    widened to f32;
  * the tensor-core route: the widened or dequantized keys split into
    TF32 big and small parts (``tests/test_torch_topk_tc.py``'s emulation,
    A = [q, 1, xn], B = [-2 y, yn, 1], 3xTF32), a candidate list of
    ``tc_list_len(k)`` per query by that distance under (distance, index),
    then the exact rescore in the CUDA-core arithmetic (fma chains) with
    the keys read through ``key_at`` again, the k best kept;
  * the split route: per key range the K best under (distance, index) of
    the fma-chain distances, then the merge of the ranges' lists
    (``tests/test_torch_topk_split.py``'s emulation), on the dequantized
    keys.

(a) On dyadic grids both routes are bitwise the plain version
(``fused_topk_plain``) and the JAX package's Pallas kernel in interpret
mode (``repro.kernels.fused_assign.fused_topk`` with ``keys_scale`` /
``keys_zero`` for int8): ties, invalid keys and self-exclusion included.
(b) On the covertype analog (the online index's shape, d 6, k 8) the
tensor-core route is within DIST_TOL of the plain version and its indices
differ only at near-ties. (c) The pair loop's lists: the chain-free
insert equals the bubble for a lane's ascending stream, and the row bound
(``quad_bound``) with the slot-wise offers (lists of 4 and 8) or the
per-pair passes (lists of 12) keeps every row's K best, ties included.
(d) The route of every (key type, d, k) boundary.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_topk_split as sp
import test_torch_topk_tc as tc
from repro.kernels import fused_assign as jfa
from repro_torch.data import PAPER_DATASETS, dataset_analog
from repro_torch.kernels import fused_assign as fa
from repro_torch.kernels import ref

torch.set_num_threads(1)

DIST_TOL = dict(rtol=1e-5, atol=1e-4)


def key_at(keys, scale=None, zero=None):
    """The staging's view of a key set as f32: bf16 widened, int8 as a
    rounded multiply then a rounded add."""
    if keys.dtype == torch.int8:
        return (keys.float() * scale) + zero
    return keys.float()


def _excluded(q, keys_f, valid, q_gidx):
    """(nq, p) mask of the pairs no list may hold: invalid keys, a query's
    own index."""
    nq, p = q.shape[0], keys_f.shape[0]
    out = torch.zeros((nq, p), dtype=torch.bool)
    if valid is not None:
        out |= ~valid[None, :]
    if q_gidx is not None:
        out |= torch.arange(p)[None, :] == q_gidx[:, None].long()
    return out


def tc_route_topk(q, keys, k, valid=None, q_gidx=None, scale=None, zero=None):
    """The tensor-core route end to end for any key type."""
    qf, kf = q.float(), key_at(keys, scale, zero)
    drop = _excluded(qf, kf, valid, q_gidx)
    approx = torch.where(drop, torch.inf, tc.tc_dist(qf, kf))
    exact = torch.where(drop, torch.inf, tc.epilogue(
        tc.fma_chain_sq(qf), tc.fma_chain_sq(kf), tc.fma_chain_cross(qf, kf)))
    idx = torch.arange(kf.shape[0]).expand_as(approx)
    # the candidates: the list's length by (3xTF32 distance, index)
    _, cand = sp.by_dist_then_index(approx, idx, tc.tc_list_len(k))
    cand = cand.long()
    cd = torch.where(cand >= 0, torch.gather(exact, 1, cand.clamp_min(0)), torch.inf)
    return sp.by_dist_then_index(cd, cand, k)


def split_route_topk(q, keys, k, valid=None, q_gidx=None, scale=None, zero=None):
    """The split route for any key type: the f32 split route on the keys
    as the conversion pass leaves them."""
    return sp.split_route_topk(q.float(), key_at(keys, scale, zero), k, valid, q_gidx)


def _route_topk(d, k):
    return {"tc3xtf32": tc_route_topk, "cuda_core_split": split_route_topk}[
        fa.route(torch.float32, torch.int8, d, k)]


def _dyadic_case(rng, nq, p, d, k, key_type):
    lim = 2 if k >= 8 else 16  # a coarse grid: many exact ties
    q = (rng.integers(-lim, lim + 1, size=(nq, d)) * 0.25).astype(np.float32)
    if key_type == "bf16":
        keys = (rng.integers(-lim, lim + 1, size=(p, d)) * 0.25).astype(np.float32)
        # duplicate rows: ties across the candidate list and the ranges
        keys[p // 2:] = keys[rng.integers(0, p // 2, size=p - p // 2)]
        return q, keys, None, None
    q8 = rng.integers(-16, 17, size=(p, d)).astype(np.int8)
    q8[p // 2:] = q8[rng.integers(0, p // 2, size=p - p // 2)]
    scale = (2.0 ** -rng.integers(1, 3, size=d)).astype(np.float32)
    zero = (rng.integers(-8, 9, size=d) * 0.25).astype(np.float32)
    return q, q8, scale, zero


@pytest.mark.parametrize("key_type", ["bf16", "int8"])
@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("d", [2, 6, 8, 16, 32, 33, 64, 256])
def test_dyadic_grids_bitwise(key_type, d, k):
    rng = np.random.default_rng(1000 * d + 10 * k + (key_type == "int8"))
    nq, p = 37, 150
    q, keys, scale, zero = _dyadic_case(rng, nq, p, d, k, key_type)
    valid = rng.random(p) > 0.3
    gidx = rng.integers(0, 2 * p, size=nq).astype(np.int32)
    if key_type == "bf16":
        tq = torch.from_numpy(q).bfloat16()
        tk = torch.from_numpy(keys).bfloat16()
        jq, jk = jnp.asarray(q, jnp.bfloat16), jnp.asarray(keys, jnp.bfloat16)
        kw, jkw = {}, {}
    else:
        tq, tk = torch.from_numpy(q), torch.from_numpy(keys)
        jq, jk = jnp.asarray(q), jnp.asarray(keys)
        kw = dict(keys_scale=torch.from_numpy(scale), keys_zero=torch.from_numpy(zero))
        jkw = dict(keys_scale=jnp.asarray(scale), keys_zero=jnp.asarray(zero))
    emulate = _route_topk(d, k)
    for v, g in ((None, None), (valid, gidx)):
        tv = None if v is None else torch.from_numpy(v)
        tg = None if g is None else torch.from_numpy(g)
        got = emulate(tq, tk, k, tv, tg, kw.get("keys_scale"), kw.get("keys_zero"))
        want = fa.fused_topk_plain(tq, tk, k, tv, q_gidx=tg, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (v is None,)
        jd, ji = jfa.fused_topk(jq, jk, k, None if v is None else jnp.asarray(v),
                                q_gidx=None if g is None else jnp.asarray(g),
                                block_q=16, block_k=64, interpret=True, **jkw)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(jd))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ji))


@pytest.mark.parametrize("key_type", ["bf16", "int8"])
@pytest.mark.parametrize("d", [6, 64])
def test_every_key_invalid_and_self_exclusion(key_type, d):
    """Every key invalid gives (inf, -1) on both routes; on the K2 layout
    (keys = queries, q_gidx = arange) no query finds itself."""
    rng = np.random.default_rng(d)
    q, keys, scale, zero = _dyadic_case(rng, 40, 40, d, 8, key_type)
    tk = torch.from_numpy(keys)
    tk = tk.bfloat16() if key_type == "bf16" else tk
    s = None if scale is None else torch.from_numpy(scale)
    z = None if zero is None else torch.from_numpy(zero)
    emulate = _route_topk(d, 8)
    none = torch.zeros(40, dtype=torch.bool)
    gd, gi = emulate(torch.from_numpy(q), tk, 8, none, None, s, z)
    assert bool(torch.isinf(gd).all()) and bool((gi == -1).all())
    x = key_at(tk, s, z)
    self_g = torch.arange(40, dtype=torch.int32)
    gd, gi = emulate(x, tk, 8, None, self_g, s, z)
    want = fa.fused_topk_plain(x, x, 8, None, q_gidx=self_g)
    assert torch.equal(gd, want[0]) and torch.equal(gi, want[1])
    assert not bool((gi == self_g[:, None]).any())


def test_staging_dequantizes_as_multiply_then_add():
    """The FMA case of chip_smoke.py: q8 = 127, scale 1 + 2^-23, zero -127
    dequantize to 2^-16 by a rounded multiply then an add, to 127·2^-23 by
    one fused multiply-add; the staging (and so the 3xTF32 B operand and
    the rescore) must give the former, as the plain version does."""
    q8 = torch.full((1, 4), 127, dtype=torch.int8)
    scale = torch.full((4,), 1 + 2.0 ** -23)
    zero = torch.full((4,), -127.0)
    got = key_at(q8, scale, zero)
    assert bool((got == 2.0 ** -16).all())
    fused = (q8.double() * scale.double() + zero.double()).float()
    assert bool((fused == 127 * 2.0 ** -23).all())
    d, i = tc_route_topk(torch.zeros((3, 4)), q8, 1, None, None, scale, zero)
    assert bool((d == 4 * 2.0 ** -32).all()) and bool((i == 0).all())


def test_bf16_keys_are_exact_in_tf32():
    """For bf16 keys the small part of -2 y is 0 (8 significant bits fit
    TF32's 11), so the 3xTF32 B operand holds the key exactly."""
    y = torch.from_numpy(np.random.default_rng(0).normal(size=5000).astype(np.float32))
    yb = y.bfloat16().float()
    big, small = tc.split(-2.0 * yb)
    assert torch.equal(big, -2.0 * yb) and bool((small == 0).all())


def _covertype(n):
    spec = next(s for s in PAPER_DATASETS if s.name == "covertype")
    x = dataset_analog(spec, seed=0, max_n=n)
    return torch.from_numpy(((x - x.mean(0)) / x.std(0)).astype(np.float32))


@pytest.mark.parametrize("key_type", ["bf16", "int8"])
def test_covertype_within_dist_tol(key_type):
    """The online shortlist's geometry at a small size: 500 queries against
    2,000 index rows (d 6, k 8), the keys packed as the index packs them."""
    x = _covertype(2500)
    keys, q = x[:2000], x[2000:]
    valid = torch.from_numpy(np.random.default_rng(1).random(2000) > 0.05)
    if key_type == "bf16":
        tq, tk, s, z = q.bfloat16(), keys.bfloat16(), None, None
    else:
        tk, s, z = fa.quantize_keys(keys, valid)
        tq = q
    got_d, got_i = tc_route_topk(tq, tk, 8, valid, None, s, z)
    kw = {} if s is None else dict(keys_scale=s, keys_zero=z)
    want_d, want_i = fa.fused_topk_plain(tq, tk, 8, valid, **kw)
    torch.testing.assert_close(got_d, want_d, **DIST_TOL)
    full = ref.pairwise_sq_l2(tq.float(), key_at(tk, s, z), y_valid=valid)
    for r, c in (got_i != want_i).nonzero().tolist():
        # a near-tie: the pick's plain distance is within DIST_TOL of the
        # plain version's distance at that slot
        assert torch.isclose(full[r, got_i[r, c]], want_d[r, c], **DIST_TOL), (r, c)


def insert_bubble(bd, bi, dv, iv):
    """``insert`` of topk.cu: the pair at the end, bubbled up under (d, i)."""
    bd, bi = bd[:-1] + [dv], bi[:-1] + [iv]
    for s in range(len(bd) - 1, 0, -1):
        if (bd[s], bi[s]) < (bd[s - 1], bi[s - 1]):
            bd[s], bd[s - 1], bi[s], bi[s - 1] = bd[s - 1], bd[s], bi[s - 1], bi[s]
    return bd, bi


def insert_ascending(bd, bi, dv, iv):
    """``insert_ascending`` of topk.cu: independent compares, then a shift."""
    gt = [x > dv for x in bd]
    nd, ni = list(bd), list(bi)
    for s in range(len(bd) - 1, 0, -1):
        nd[s] = bd[s - 1] if gt[s - 1] else dv if gt[s] else bd[s]
        ni[s] = bi[s - 1] if gt[s - 1] else iv if gt[s] else bi[s]
    nd[0], ni[0] = (dv, iv) if gt[0] else (bd[0], bi[0])
    return nd, ni


def pair_loop_row(dist, K, empty=1e38):
    """One row of topk_tc_kernel's pair loop: lane l of the row's quad takes
    columns 2 l, 2 l + 1 of every 8-key tile; per group of 4 tiles the row's
    bound (quad_bound) is taken once; a lane offers a pair of columns when
    their minimum is at or below it (lists of 4 and 8), or each pair at or
    below it, in ascending index (lists of 12: the passes); a pair enters
    its own list when below the last entry; then the 4 lists merge under
    (distance, index)."""
    lists = [([empty] * K, [-1] * K) for _ in range(4)]
    q = (K + 3) // 4 - 1
    for g0 in range(0, len(dist), 32):
        bound = min(min(bd[-1] for bd, _ in lists), max(bd[q] for bd, _ in lists))
        for j in range(g0, min(g0 + 32, len(dist)), 8):
            for lane in range(4):
                cols = [c for c in (j + 2 * lane, j + 2 * lane + 1) if c < len(dist)]
                if K > 8:
                    cols = [c for c in cols if dist[c] <= bound]
                elif not cols or min(dist[c] for c in cols) > bound:
                    continue
                for c in cols:
                    bd, bi = lists[lane]
                    if dist[c] < bd[-1]:
                        lists[lane] = insert_ascending(bd, bi, dist[c], c)
    merged = sorted((d, i) for bd, bi in lists for d, i in zip(bd, bi) if i >= 0)
    return merged[:K]


def test_insert_ascending_is_the_bubble_for_ascending_streams():
    """For a stream in ascending index (a lane's keys), the chain-free shift
    gives the bubble's list, ties to the lowest index included."""
    rng = np.random.default_rng(0)
    for K in (4, 8, 12):
        bd_a, bi_a = [np.inf] * K, [-1] * K
        bd_b, bi_b = list(bd_a), list(bi_a)
        for i, d in enumerate(rng.integers(0, 6, size=400).astype(float)):
            if d < bd_a[-1]:
                bd_a, bi_a = insert_ascending(bd_a, bi_a, d, i)
            if (d, i) < (bd_b[-1], bi_b[-1]):
                bd_b, bi_b = insert_bubble(bd_b, bi_b, d, i)
            assert (bd_a, bi_a) == (bd_b, bi_b)


@pytest.mark.parametrize("K", [4, 8, 12])
@pytest.mark.parametrize("levels", [3, 40, 100_000])
def test_pair_loop_keeps_each_rows_k_best(K, levels):
    """The pruning bound and the per-lane lists keep every row's K best under
    (distance, index): coarse distances (many ties across lanes and tiles),
    a key count that fills no group."""
    rng = np.random.default_rng(K * levels)
    for n in (5, 37, 1000):
        dist = rng.integers(0, levels, size=n).astype(float).tolist()
        want = sorted((d, i) for i, d in enumerate(dist))[:K]
        assert pair_loop_row(dist, K) == want


@pytest.mark.parametrize("keys_dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("d,k,want", [
    (1, 1, "tc3xtf32"), (32, 1, "tc3xtf32"), (32, 8, "tc3xtf32"),
    (33, 1, "cuda_core_split"), (33, 8, "cuda_core_split"), (256, 8, "cuda_core_split"),
    (6, 9, "cuda_core"), (32, 9, "cuda_core"), (33, 9, "cuda_core"), (256, 32, "cuda_core"),
])
def test_route_boundaries(keys_dtype, d, k, want):
    q_dtype = torch.bfloat16 if keys_dtype == torch.bfloat16 else torch.float32
    assert fa.route(q_dtype, keys_dtype, d, k) == want
    assert fa.key_type(keys_dtype) == {torch.float32: "K1", torch.bfloat16: "K1-bf16",
                                       torch.int8: "K1-int8"}[keys_dtype]
