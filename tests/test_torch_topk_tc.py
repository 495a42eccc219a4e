"""The arithmetic of K1's tensor-core route (3xTF32), emulated on the CPU.

``csrc/topk.cu``'s tensor-core kernel cannot run here (no card, no nvcc).
What can be held here is its arithmetic, written out in torch:
``cvt.rna.tf32`` (round to nearest, ties away, to 10 mantissa bits, by bit
masks on the int32 view), the split ``a = big + small`` with
``small = tf32(a - big)``, and the three products ``small·big' +
big·small'`` then ``big·big'`` accumulated in f32, of the augmented rows
``A = [q, 1, xn]`` and ``B = [-2 y, yn, 1]`` (``xn``, ``yn`` the CUDA-core
kernel's sequential fma chains), whose product is the distance
``xn + yn - 2 q·y``. Each TF32 product is exact in f32 (11 x 11
significant bits); the tensor core's order (and rounding) of the sums
inside one mma is not specified, so the emulation adds in feature order.

That distance only chooses candidates: the route keeps, per query, a list
a few entries longer than k by it, then rescores those candidates in the
CUDA-core kernel's arithmetic (``max(xn + yn - 2·cross, 0)`` with the cross
term an fma chain too) and keeps the k best, so the distances it returns
are the fma chain's.

(a) on the dyadic grids of ``chip_smoke.py``'s edge checks the split is
exact (``big + small == a``) and so is every sum: the emulated 3xTF32
distances equal the fma chain's bits and the plain version's. (b) on the
covertype analog (d 6) and the paper's GMM (d 2) the route's distances lie
within DIST_TOL (rtol 1e-5, atol 1e-4: the kernel-vs-plain tolerance on
the card) of ``ref.pairwise_sq_l2`` and its top-k indices differ from the
plain version's only at near-ties; so at rows of magnitude ~1e3 at d 8
and 32, while at d <= 6 even an exactly rounded cross term misses DIST_TOL
there (cancellation in the f32 formula itself, whatever the route). The
3xTF32 distances alone miss DIST_TOL on the GMM (a point's distance to
itself, |x|^2 near 100), which is why the route rescores. (c) the dispatch
rule.
"""
import numpy as np
import pytest
import torch

from repro_torch.data import PAPER_DATASETS, dataset_analog, gmm_sample
from repro_torch.kernels import fused_assign as fa
from repro_torch.kernels import ref

torch.set_num_threads(1)

DIST_TOL = dict(rtol=1e-5, atol=1e-4)


def tf32_rna(a: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: keep 10 mantissa bits, rounding the magnitude half
    away from zero (add half an ulp of the kept bits, then mask)."""
    b = a.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def split(a: torch.Tensor):
    big = tf32_rna(a)
    return big, tf32_rna(a - big)


def mma_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n, p) a·b' as the kernel forms it: per 8-column k-step the
    small·big' and big·small' products, then every big·big' product."""
    ab, as_ = split(a)
    bb, bs = split(b)
    c = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.float32)
    for f in range(a.shape[1]):
        c = c + as_[:, f, None] * bb[None, :, f]
        c = c + ab[:, f, None] * bs[None, :, f]
    for f in range(a.shape[1]):
        c = c + ab[:, f, None] * bb[None, :, f]
    return c


def augmented(q: torch.Tensor, k: torch.Tensor):
    """The tensor-core operands: A = [q, 1, xn], B = [-2 y, yn, 1]."""
    ones_q = torch.ones((q.shape[0], 1), dtype=torch.float32)
    ones_k = torch.ones((k.shape[0], 1), dtype=torch.float32)
    a = torch.cat([q, ones_q, fma_chain_sq(q)[:, None]], dim=1)
    b = torch.cat([-2.0 * k, fma_chain_sq(k)[:, None], ones_k], dim=1)
    return a, b


def fma_chain_sq(x: torch.Tensor) -> torch.Tensor:
    """Row norms as the kernel's sequential fmaf chain (each step one
    rounding to f32 of the exact a·a + acc, taken in f64)."""
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


def epilogue(xn, yn, cross):
    return torch.clamp_min((xn[:, None] + yn[None, :]) - 2.0 * cross, 0.0)


def tc_dist(q, k):
    """The pair loop's distance (unclamped): A·B' in 3xTF32."""
    return mma_3xtf32(*augmented(q, k))


def tc_list_len(k: int) -> int:
    """The candidates the pair loop keeps for an output of k (topk.cu)."""
    return 4 if k <= 2 else 8 if k <= 4 else 12


def tc_route_topk(q, keys, k, exclude_self=False):
    """The route end to end: candidates by the 3xTF32 distance (the lowest
    index first among ties), rescored by the fma chains, the k best under
    (distance, index)."""
    approx = tc_dist(q, keys)
    exact = epilogue(fma_chain_sq(q), fma_chain_sq(keys), fma_chain_cross(q, keys))
    if exclude_self:
        eye = torch.arange(q.shape[0])
        approx[eye, eye] = torch.inf
        exact[eye, eye] = torch.inf
    cand = topk_idx(approx, tc_list_len(k))
    cd = torch.gather(exact, 1, cand)
    # (distance, index) order: sort by index, then stably by distance
    by_idx = torch.sort(cand, dim=1).indices
    cand, cd = torch.gather(cand, 1, by_idx), torch.gather(cd, 1, by_idx)
    order = torch.sort(cd, dim=1, stable=True).indices[:, :k]
    return torch.gather(cd, 1, order), torch.gather(cand, 1, order)


def topk_idx(d: torch.Tensor, k: int) -> torch.Tensor:
    """k smallest of each row, the lowest index first among ties."""
    return torch.sort(d, dim=1, stable=True).indices[:, :k]


def test_tf32_rounding_by_bit_masks():
    one = 1.0
    ulp = 2.0 ** -10
    cases = [
        (one, one),
        (one + ulp / 2, one + ulp),           # a tie: away from zero
        (-(one + ulp / 2), -(one + ulp)),
        (one + ulp / 2 - 2.0 ** -23, one),    # below the tie: down
        (one + ulp * 0.75, one + ulp),
        (2.0 - ulp / 2, 2.0),                 # carries into the exponent
        (0.0, 0.0), (3.0, 3.0), (1e-3, None),
    ]
    for a, want in cases:
        got = float(tf32_rna(torch.tensor([a], dtype=torch.float32))[0])
        if want is not None:
            assert got == want, (a, got, want)
        assert got.hex() == float(np.float32(got)).hex()
        # 10 mantissa bits kept: the low 13 bits of the pattern are zero
        bits = torch.tensor([got], dtype=torch.float32).view(torch.int32)
        assert int(bits[0]) & 0x1FFF == 0
    a = torch.from_numpy(np.random.default_rng(0).normal(size=10_000).astype(np.float32))
    big, small = split(a)
    # the split keeps about 21 bits: |a - big - small| <= 2^-22 |a|
    resid = (a.double() - big.double() - small.double()).abs()
    assert bool((resid <= 2.0 ** -22 * a.double().abs()).all())


@pytest.mark.parametrize("nq,p,d", [
    (7, 33, 1), (33, 17, 5), (9, 9, 2), (300, 1000, 6), (5, 3, 4),
    (130, 1100, 8), (70, 300, 9), (40, 200, 32),
])
def test_dyadic_grids_are_bitwise(nq, p, d):
    # multiples of 1/4 in [-4, 4], the edge grids of chip_smoke.py
    rng = np.random.default_rng(nq * 1000 + d)
    q = torch.from_numpy((rng.integers(-16, 17, size=(nq, d)) * 0.25).astype(np.float32))
    k = torch.from_numpy((rng.integers(-16, 17, size=(p, d)) * 0.25).astype(np.float32))
    for m in augmented(q, k):
        big, small = split(m)
        assert torch.equal(big + small, m)  # the split is exact here
    got = torch.clamp_min(tc_dist(q, k), 0.0)
    chain = epilogue(fma_chain_sq(q), fma_chain_sq(k), fma_chain_cross(q, k))
    assert torch.equal(got, chain)
    assert torch.equal(got, ref.pairwise_sq_l2(q, k))


def _covertype(n):
    spec = next(s for s in PAPER_DATASETS if s.name == "covertype")
    x = dataset_analog(spec, seed=0, max_n=n)
    x = (x - x.mean(0)) / x.std(0)
    return torch.from_numpy(x.astype(np.float32))


def _main_path_data(data):
    if data == "covertype_d6":
        return _covertype(3000)
    return torch.from_numpy(gmm_sample(3000, seed=0)[0])


def _check_route(q, keys, k, exclude_self):
    got_d, got_i = tc_route_topk(q, keys, k, exclude_self)
    want = ref.pairwise_sq_l2(q, keys)
    if exclude_self:
        eye = torch.arange(q.shape[0])
        want[eye, eye] = torch.inf
    want_i = topk_idx(want, k)
    want_d = torch.gather(want, 1, want_i)
    torch.testing.assert_close(got_d, want_d, **DIST_TOL)
    for r, c in (got_i != want_i).nonzero().tolist():
        # a near-tie: the pick's plain distance is within DIST_TOL of the
        # plain version's distance at that slot
        assert torch.isclose(want[r, got_i[r, c]], want_d[r, c], **DIST_TOL), (r, c)


@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("data", ["covertype_d6", "gmm_d2"])
def test_main_path_data_within_dist_tol(data, k):
    x = _main_path_data(data)
    _check_route(x[:1000], x, k, exclude_self=True)   # the TC's self-kNN
    _check_route(x[2000:], x[:2000], k, exclude_self=False)  # an assign


def test_raw_3xtf32_distances_need_the_rescore():
    x = _main_path_data("gmm_d2")
    q = x[:1000]
    err = (tc_dist(q, x) - ref.pairwise_sq_l2(q, x)).abs()
    assert float(err.max()) > DIST_TOL["atol"]


@pytest.mark.parametrize("d", [8, 32])
def test_large_magnitude_rows_within_dist_tol(d):
    rng = np.random.default_rng(d)
    q = torch.from_numpy((rng.normal(size=(500, d)) * 1e3).astype(np.float32))
    k = torch.from_numpy((rng.normal(size=(2000, d)) * 1e3).astype(np.float32))
    for kk in (1, 8):
        _check_route(q, k, kk, exclude_self=False)


def test_large_magnitude_at_low_d_is_bound_by_the_formula():
    # why chip_smoke.py holds the |x| ~ 1e3 case at d >= 8: at d 6 the
    # f32 formula itself loses DIST_TOL at the nearest keys, even with a
    # cross term rounded exactly once
    rng = np.random.default_rng(6)
    q = torch.from_numpy((rng.normal(size=(2000, 6)) * 1e3).astype(np.float32))
    k = torch.from_numpy((rng.normal(size=(3000, 6)) * 1e3).astype(np.float32))
    want = ref.pairwise_sq_l2(q, k)
    exact_cross = (q.double() @ k.double().T).float()
    best = epilogue(fma_chain_sq(q), fma_chain_sq(k), exact_cross)
    near = want <= torch.sort(want, dim=1).values[:, 1:2]
    tol = DIST_TOL["atol"] + DIST_TOL["rtol"] * want.abs()
    assert bool(((best - want).abs() > tol)[near].any())


@pytest.mark.parametrize("q_dtype,k_dtype,d,k,want", [
    (torch.float32, torch.float32, 1, 1, "tc3xtf32"),
    (torch.float32, torch.float32, 6, 2, "tc3xtf32"),
    (torch.float32, torch.float32, 2, 1, "tc3xtf32"),
    (torch.float32, torch.float32, 32, 8, "tc3xtf32"),
    (torch.float64, torch.float32, 6, 2, "tc3xtf32"),   # widened to f32
    (torch.float32, torch.float32, 33, 1, "cuda_core_split"),
    (torch.float32, torch.float32, 256, 1, "cuda_core_split"),
    (torch.float32, torch.float32, 6, 9, "cuda_core"),
    (torch.float32, torch.float32, 6, 32, "cuda_core"),
    # bf16 and int8 keys take the same routes (widened or dequantized as
    # they are staged)
    (torch.bfloat16, torch.bfloat16, 6, 8, "tc3xtf32"),
    (torch.float32, torch.int8, 6, 8, "tc3xtf32"),
    (torch.float32, torch.int8, 6, 1, "tc3xtf32"),
    # the CUDA-core split route: f32, d > 32, k <= 8
    (torch.float32, torch.float32, 256, 8, "cuda_core_split"),
    (torch.float32, torch.float32, 512, 2, "cuda_core_split"),
    (torch.float64, torch.float32, 64, 4, "cuda_core_split"),  # widened to f32
    (torch.float32, torch.float32, 256, 9, "cuda_core"),
    (torch.float32, torch.float32, 33, 32, "cuda_core"),
    (torch.bfloat16, torch.bfloat16, 256, 1, "cuda_core_split"),
    (torch.float32, torch.int8, 256, 1, "cuda_core_split"),
])
def test_dispatch_rule(q_dtype, k_dtype, d, k, want):
    assert fa.route(q_dtype, k_dtype, d, k) == want
    assert (fa.TC_MAX_D, fa.TC_MAX_K) == (32, 8)
