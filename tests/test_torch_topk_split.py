"""The arithmetic of K1/K2's CUDA-core split route, emulated on the CPU.

``csrc/topk.cu``'s split kernel (f32 queries and keys, d > 32, k <= 8: K2
at the LM's compression, d 256, k 1) cannot run here (no card, no nvcc).
What can be held here is what it computes, written out in torch with the
kernel's own split rule (``fused_assign.split_plan``): the distance of
every pair in the CUDA-core kernel's arithmetic, ``max(xn + yn - 2·cross,
0)`` with xn, yn and the cross term sequential fma chains in ascending
feature order (each step the exact ``a·b + acc`` rounded once to f32,
taken in f64), an invalid key at +inf and the query's own index excluded;
then, per key range, the K best under the total order (dist, g) (the
kernel's strict-< insert in ascending g), and the merge of the ranges'
lists under the same order, keeping k.

(a) On dyadic grids (multiples of 1/4; every product and sum exact in
f32) at d 33, 64, 256 and 512 the route is bitwise the plain version's
(``ref.knn``) and the JAX package's Pallas kernel's in interpret mode
(``repro.kernels.knn_topk.knn_topk``): duplicate rows on both sides of a
range boundary (the tie goes to the lowest index), invalid keys, the
self-exclusion, k 1, 2 and 8, n not a multiple of 64. (b) On continuous
data at d 256 (bf16-valued keys, as a KV head holds them) its distances
lie within the tolerance ``chip_smoke.py`` holds K2 to at that width
(rtol 1e-5, atol 1e-3: the fma chain and the plain version's matrix
product round |x|² ~ 256 in other orders), the filled slots are the same
and the indices differ only at near-ties. (c) The split rule.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.knn_topk import knn_topk as j_knn_topk
from repro_torch.kernels import fused_assign as fa
from repro_torch.kernels import ref

torch.set_num_threads(1)

K2_D256_TOL = dict(rtol=1e-5, atol=1e-3)


def fma_chain_sq(x: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros(x.shape[0], dtype=torch.float32)
    for f in range(x.shape[1]):
        v = x[:, f].double()
        acc = (v * v + acc.double()).float()
    return acc


def fma_chain_cross(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros((q.shape[0], k.shape[0]), dtype=torch.float32)
    for f in range(q.shape[1]):
        acc = (q[:, f, None].double() * k[None, :, f].double() + acc.double()).float()
    return acc


def by_dist_then_index(d: torch.Tensor, idx: torch.Tensor, k: int):
    """The k first of each row under (dist, index); +inf slots, and slots
    past the row's entries, are (inf, -1)."""
    if d.shape[1] < k:
        pad = k - d.shape[1]
        d = torch.cat([d, torch.full((d.shape[0], pad), torch.inf)], 1)
        idx = torch.cat([idx, torch.full((d.shape[0], pad), -1, dtype=idx.dtype)], 1)
    order = torch.sort(idx, dim=1, stable=True).indices
    d, idx = torch.gather(d, 1, order), torch.gather(idx, 1, order)
    order = torch.sort(d, dim=1, stable=True).indices[:, :k]
    d, idx = torch.gather(d, 1, order), torch.gather(idx, 1, order)
    return d, torch.where(torch.isinf(d), -1, idx).to(torch.int32)


def list_len(k: int) -> int:
    """The list a block keeps for an output of k (topk.cu: sp_list_len)."""
    return 1 if k <= 1 else 2 if k <= 2 else 4 if k <= 4 else 8


def split_route_topk(q, keys, k, valid=None, q_gidx=None):
    """The route end to end: partial lists per key range, then the merge."""
    nq, p = q.shape[0], keys.shape[0]
    dist = torch.clamp_min((fma_chain_sq(q)[:, None] + fma_chain_sq(keys)[None, :])
                           - 2.0 * fma_chain_cross(q, keys), 0.0)
    if valid is not None:
        dist = torch.where(valid[None, :], dist, torch.inf)
    cols = torch.arange(p).expand(nq, p)
    if q_gidx is not None:
        dist = torch.where(cols == q_gidx[:, None].long(), torch.inf, dist)
    splits, per = fa.split_plan(nq, p)
    kk = list_len(k)
    parts_d, parts_i = [], []
    for s in range(splits):
        lo, hi = s * per, min(p, (s + 1) * per)
        assert lo < hi  # no range is empty
        pd, pi = by_dist_then_index(dist[:, lo:hi], cols[:, lo:hi], kk)
        parts_d.append(pd)
        parts_i.append(pi.long())
    assert splits == 1 or (splits - 1) * per < p <= splits * per
    return by_dist_then_index(torch.cat(parts_d, 1), torch.cat(parts_i, 1), k)


def dyadic(rng, shape, lim=16):
    return (rng.integers(-lim, lim + 1, size=shape) * 0.25).astype(np.float32)


@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("n,d", [(200, 33), (150, 64), (200, 256), (130, 512)])
@pytest.mark.parametrize("masked", [False, True])
def test_dyadic_knn_bitwise(rng, n, d, k, masked):
    assert fa.route(torch.float32, torch.float32, d, k) == "cuda_core_split"
    x = dyadic(rng, (n, d), lim=2)  # a coarse grid: many exact ties
    splits, per = fa.split_plan(n, n)
    assert splits > 1
    # duplicate rows on both sides of every range boundary
    for b in range(per, n, per):
        x[b - 2:b + 2] = x[b - 3]
    v = rng.random(n) > 0.25 if masked else None
    tx = torch.from_numpy(x)
    tv = None if v is None else torch.from_numpy(v)
    got_d, got_i = split_route_topk(tx, tx, k, tv, torch.arange(n, dtype=torch.int32))
    want_d, want_i = ref.knn(tx, k, valid=tv)
    assert torch.equal(got_d, want_d) and torch.equal(got_i, want_i)
    jd, ji = j_knn_topk(jnp.asarray(x), k, None if v is None else jnp.asarray(v),
                        block_q=64, block_k=64, interpret=True)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ji))
    # a boundary's duplicates (rows per - 3 .. per + 1): the tie at
    # distance 0 goes to the lowest valid index other than the row itself
    dups = [j for j in range(per - 3, per + 2) if j != per and (v is None or v[j])]
    if dups:
        assert float(got_d[per, 0]) == 0.0 and int(got_i[per, 0]) == dups[0]
    assert not bool((got_i == torch.arange(n)[:, None]).any())


@pytest.mark.parametrize("nq,p,d,k", [(40, 130, 256, 2), (70, 200, 300, 1),
                                      (7, 33, 33, 8), (5, 3, 40, 8), (130, 700, 64, 4)])
def test_dyadic_assign_bitwise(rng, nq, p, d, k):
    """Queries other than the keys (K1 at d > 32): masks and a q_gidx
    that hits some keys."""
    q, keys = torch.from_numpy(dyadic(rng, (nq, d))), torch.from_numpy(dyadic(rng, (p, d)))
    valid = torch.from_numpy(rng.random(p) > 0.3)
    gidx = torch.from_numpy(rng.integers(0, 2 * p, size=nq).astype(np.int32))
    for v, g in ((None, None), (valid, gidx)):
        got = split_route_topk(q, keys, k, v, g)
        want = fa.fused_topk_plain(q, keys, k, v, q_gidx=g, block_q=16, block_k=32)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("k", [1, 8])
def test_continuous_d256_within_tolerance(k):
    """K2 at the compression's width: 300 bf16-valued rows of d 256, the
    last 40 invalid (unwritten cache slots)."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((300, 256), generator=gen).bfloat16().float()
    valid = torch.arange(300) < 260
    got_d, got_i = split_route_topk(x, x, k, valid, torch.arange(300, dtype=torch.int32))
    want_d, want_i = ref.knn(x, k, valid=valid)
    ok = torch.isfinite(want_d)
    assert torch.equal(torch.isfinite(got_d), ok)
    torch.testing.assert_close(got_d[ok], want_d[ok], **K2_D256_TOL)
    full = ref.pairwise_sq_l2(x, x, y_valid=valid)
    for r, c in (got_i != want_i).nonzero().tolist():
        # a near-tie: the pick's plain distance is within the tolerance of
        # the plain version's distance at that slot
        assert torch.isclose(full[r, got_i[r, c]], want_d[r, c], **K2_D256_TOL), (r, c)


@pytest.mark.parametrize("nq,p,want", [
    (2208, 2208, (7, 320)),     # the compression: 35 query tiles x 7 ranges
    (40, 130, (3, 64)),
    (5, 3, (1, 64)),
    (1, 0, (1, 64)),
    (300, 1000, (16, 64)),
    (8192, 581_632, (3, 193_920)),
    (7172, 7172, (3, 2432)),    # 113 tiles in 3 ranges of 38
])
def test_split_plan(nq, p, want):
    splits, per = fa.split_plan(nq, p)
    assert (splits, per) == want
    assert per % 64 == 0
    if p:
        assert (splits - 1) * per < p <= splits * per
    assert splits <= -(-fa.SPLIT_BLOCKS_WANTED // -(-nq // fa.SPLIT_Q))
