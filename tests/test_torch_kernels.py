"""The port's kernel functions on the CPU against the JAX package's.

Each function of ``repro_torch.kernels`` that the card runs as a CUDA
kernel runs its plain PyTorch version here (the wrapper is handed a CPU
tensor), and is held against the JAX reference (``repro.kernels.ref``)
and the Pallas kernel in interpret mode, on the same numpy inputs.

Two data regimes: dyadic-grid inputs make every distance and partial sum
exact in f32, so those comparisons are bit for bit and flood the merges
with ties; continuous inputs are held to rtol = atol = 1e-5 (XLA:CPU and
torch's BLAS round differently), with neighbour indices equal except
where the two candidates' distances lie within that tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.fused_assign import fused_topk as j_fused_topk
from repro.kernels.fused_assign import fused_topk_xla as j_fused_topk_xla
from repro.kernels.knn_topk import knn_topk as j_knn_topk
from repro.kernels.pairwise_l2 import pairwise_sq_l2 as j_pairwise
from repro.kernels.segment_sum import segment_sum as j_segment_sum
from repro_torch import kernels as tkernels
from repro_torch.kernels import _cuda, ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_assign import fused_topk, fused_topk_plain, launch_topk
from repro_torch.kernels.knn_topk import knn_topk
from repro_torch.kernels.pairwise_l2 import pairwise_sq_l2
from repro_torch.kernels.segment_sum import segment_sum

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def dyadic(rng, shape, scale=0.25, lim=16):
    return (rng.integers(-lim, lim + 1, size=shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def assert_idx_equal_up_to_ties(got_i, want_i, want_d, atol=1e-5, rtol=1e-5):
    """Neighbour indices agree except where the reference's distances of
    the two picks lie within tolerance of each other."""
    got_i, want_i, want_d = map(np.asarray, (got_i, want_i, want_d))
    bad = np.argwhere(got_i != want_i)
    for r, c in bad:
        row = want_d[r]
        # a near-tie at this rank: some other slot/candidate is within tol
        near = np.isclose(row, row[c], atol=atol, rtol=rtol).sum() > 1
        assert near, f"index mismatch at {(r, c)} with no near-tie"


# ---------------------------------------------------------------- pairwise

@pytest.mark.parametrize("n,m,d,masked", [
    (7, 9, 1, False), (17, 33, 5, True), (31, 16, 8, False), (9, 7, 6, True),
])
def test_pairwise_matches_reference(rng, n, m, d, masked):
    yv = rng.random(m) > 0.3 if masked else None
    for data, exact in ((dyadic, True), (None, False)):
        if data is None:
            x = rng.normal(size=(n, d)).astype(np.float32)
            y = rng.normal(size=(m, d)).astype(np.float32)
        else:
            x, y = data(rng, (n, d)), data(rng, (m, d))
        want = np.asarray(jref.pairwise_sq_l2(
            jnp.asarray(x), jnp.asarray(y),
            y_valid=None if yv is None else jnp.asarray(yv)))
        pallas = np.asarray(j_pairwise(jnp.asarray(x), jnp.asarray(y),
                                       None if yv is None else jnp.asarray(yv),
                                       block_q=8, block_k=8, interpret=True))
        got = pairwise_sq_l2(t(x), t(y), None if yv is None else t(yv)).numpy()
        if exact:
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, pallas)
        else:
            np.testing.assert_allclose(got, want, **TOL)
            np.testing.assert_allclose(got, pallas, **TOL)


# --------------------------------------------------------------------- knn

@pytest.mark.parametrize("n,d,k,masked", [
    (33, 1, 32, False),   # k = n-1 at d=1
    (17, 1, 17, False),   # k = n: the last slot is unfillable
    (9, 5, 8, True),
    (40, 2, 3, True),
])
def test_knn_dyadic_bitwise(rng, n, d, k, masked):
    x = dyadic(rng, (n, d))
    v = rng.random(n) > 0.3 if masked else None
    jv = None if v is None else jnp.asarray(v)
    wd, wi = jref.knn(jnp.asarray(x), k, valid=jv)
    pd, pi = j_knn_topk(jnp.asarray(x), k, jv, block_q=8, block_k=8,
                        interpret=True)
    for fn in (lambda: knn_topk(t(x), k, None if v is None else t(v)),
               lambda: ops.knn(t(x), k, valid=None if v is None else t(v),
                               impl="fused")):
        gd, gi = fn()
        np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(pi))


@pytest.mark.parametrize("n,d,k", [(31, 3, 4), (64, 6, 2)])
def test_knn_continuous_tolerance(rng, n, d, k):
    x = rng.normal(size=(n, d)).astype(np.float32)
    wd, wi = jref.knn(jnp.asarray(x), k)
    gd, gi = knn_topk(t(x), k)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), **TOL)
    assert_idx_equal_up_to_ties(gi.numpy(), wi, wd)


def test_knn_k_exceeds_valid_count(rng):
    x = dyadic(rng, (12, 3))
    v = np.array([True] * 8 + [False] * 4)
    gd, gi = knn_topk(t(x), 9, t(v))
    wd, wi = jref.knn(jnp.asarray(x), 9, valid=jnp.asarray(v))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert np.isinf(gd.numpy()[:, -1]).all() and (gi.numpy()[:, -1] == -1).all()


# -------------------------------------------------------- fused / nearest

@pytest.mark.parametrize("nq,p,d,k,bk,masked,self_excl", [
    (7, 33, 1, 1, 32, False, False),   # d=1, one partial key block
    (33, 17, 5, 3, 16, True, True),    # no axis divides its block
    (9, 9, 2, 9, 8, False, True),      # k = p
    (16, 8, 8, 2, 8, True, False),     # aligned
])
def test_fused_topk_dyadic_bitwise(rng, nq, p, d, k, bk, masked, self_excl):
    q, keys = dyadic(rng, (nq, d)), dyadic(rng, (p, d))
    v = rng.random(p) > 0.3 if masked else None
    g = rng.integers(0, 2 * p, size=nq).astype(np.int32) if self_excl else None
    jv = None if v is None else jnp.asarray(v)
    jg = None if g is None else jnp.asarray(g)
    pd, pi = j_fused_topk(jnp.asarray(q), jnp.asarray(keys), k, jv, q_gidx=jg,
                          block_q=8, block_k=bk, interpret=True)
    xd, xi = j_fused_topk_xla(jnp.asarray(q), jnp.asarray(keys), k, jv,
                              q_gidx=jg, block_k=bk)
    tv = None if v is None else t(v)
    tg = None if g is None else t(g)
    for impl in ("fused", "cuda", "ref"):
        gd, gi = ops.nearest_topk(t(q), t(keys), k, key_valid=tv, q_gidx=tg,
                                  impl=impl, block_k=bk)
        np.testing.assert_array_equal(gd.numpy(), np.asarray(pd))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(pi))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(xi))
        assert gi.dtype == torch.int32 and gd.dtype == torch.float32


def test_fused_topk_all_invalid_keys(rng):
    q = rng.normal(size=(9, 3)).astype(np.float32)
    keys = rng.normal(size=(17, 3)).astype(np.float32)
    gd, gi = fused_topk(t(q), t(keys), 2, torch.zeros(17, dtype=torch.bool),
                        block_k=8)
    assert torch.isinf(gd).all() and (gi == -1).all()


def test_fused_topk_continuous_tolerance(rng):
    q = rng.normal(size=(40, 6)).astype(np.float32)
    keys = rng.normal(size=(70, 6)).astype(np.float32)
    wd, wi = j_fused_topk_xla(jnp.asarray(q), jnp.asarray(keys), 2, block_k=16)
    gd, gi = fused_topk_plain(t(q), t(keys), 2, block_k=16)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), **TOL)
    assert_idx_equal_up_to_ties(gi.numpy(), wi, wd)


def test_fused_topk_empty_key_set(rng):
    q = rng.normal(size=(4, 2)).astype(np.float32)
    gd, gi = fused_topk(t(q), torch.zeros((0, 2)), 1)
    assert torch.isinf(gd).all() and (gi == -1).all()


# ------------------------------------------------------------- segment sum

@pytest.mark.parametrize("n,d,s,weighted", [
    (7, 1, 1, False), (17, 5, 9, True), (33, 2, 17, True), (16, 8, 5, False),
])
def test_segment_sum_matches_reference(rng, n, d, s, weighted):
    # ids straddle the legal range: -1 and s are dropped
    ids = rng.integers(-1, s + 1, size=n).astype(np.int32)
    for exact in (True, False):
        x = dyadic(rng, (n, d)) if exact else rng.normal(size=(n, d)).astype(np.float32)
        w = ((rng.integers(1, 5, size=n) * 0.5).astype(np.float32) if exact
             else rng.random(n).astype(np.float32)) if weighted else None
        jw = None if w is None else jnp.asarray(w)
        ws, wm = jref.segment_sum(jnp.asarray(x), jnp.asarray(ids), s, weights=jw)
        ps, pm = j_segment_sum(jnp.asarray(x), jnp.asarray(ids), s, jw,
                               block_s=8, block_n=8, interpret=True)
        gs, gm = segment_sum(t(x), t(ids), s, None if w is None else t(w))
        if exact:
            for a, b in ((gs, ws), (gm, wm), (gs, ps), (gm, pm)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            for a, b in ((gs, ws), (gm, wm), (gs, ps), (gm, pm)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("n_blocks", [1, 3, 8])
def test_blocked_segment_sum_matches_reference(rng, n_blocks):
    n, d, s = 53, 3, 11
    x = rng.normal(size=(n, d)).astype(np.float32)
    ids = rng.integers(-1, s + 1, size=n).astype(np.int32)
    w = rng.random(n).astype(np.float32)
    ws, wm = jops.blocked_segment_sum(jnp.asarray(x), jnp.asarray(ids), s,
                                      weights=jnp.asarray(w), n_blocks=n_blocks,
                                      impl="ref")
    for impl in ("ref", "cuda", "auto"):
        gs, gm = ops.blocked_segment_sum(t(x), t(ids), s, weights=t(w),
                                         n_blocks=n_blocks, impl=impl)
        # the reference's scatter and index_add_ both fold in row order
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))


# ----------------------------------------------------------------- dispatch

def test_resolve_policies():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert ops.resolve("auto", cpu) == "ref"
    assert ops.resolve("auto", cpu, fused=True) == "ref"
    assert ops.resolve("auto", cuda) == "cuda"
    assert ops.resolve("auto", cuda, fused=True) == "fused"
    assert ops.resolve("fused", cuda) == "cuda"      # no fused path: auto
    assert ops.resolve("fused", cpu) == "ref"
    assert ops.resolve("ref", cuda, fused=True) == "ref"
    with pytest.raises(ValueError, match="unknown impl"):
        ops.resolve("pallas", cpu)


def test_cuda_launch_refuses_cpu_tensors_and_counts_nothing(rng):
    tkernels.reset_launch_counts()
    x = t(rng.normal(size=(5, 2)).astype(np.float32))
    with pytest.raises(ValueError, match="CUDA kernel got a tensor on cpu"):
        launch_topk(x, x, 1, None, None)
    with pytest.raises(ValueError, match="CUDA kernel got a tensor on cpu"):
        _cuda.require_cuda("segment_sum", x)
    with pytest.raises(TypeError, match="float tensors"):
        _cuda.f32(torch.zeros(3, dtype=torch.int64))
    with pytest.raises(TypeError, match="integers"):
        _cuda.index(torch.zeros(3), torch.int64)
    # CPU tensors run the plain versions: no kernel launch is counted
    fused_topk(x, x, 1)
    knn_topk(x, 1)
    segment_sum(x, torch.zeros(5, dtype=torch.int64), 2)
    pairwise_sq_l2(x, x)
    q = x.reshape(1, 1, 5, 2)
    flash_attention(q, q, q)
    fused_topk(x.bfloat16(), x.bfloat16(), 1)
    fused_topk(x, torch.zeros((5, 2), dtype=torch.int8), 1,
               keys_scale=torch.ones(2), keys_zero=torch.zeros(2))
    assert tkernels.launch_counts() == {"K1": 0, "K1-bf16": 0, "K1-int8": 0,
                                        "K2": 0, "K3": 0, "K4": 0, "K5": 0}


def test_merge_topk_tie_rule():
    # running list first, then the lowest column among equal distances
    bd = torch.tensor([[1.0, torch.inf]])
    bi = torch.tensor([[5, -1]], dtype=torch.int32)
    d = torch.tensor([[1.0, 0.5, 1.0]])
    idx = torch.tensor([[7, 8, 9]])
    gd, gi = ref.merge_topk(bd, bi, d, idx, 3)
    assert gd.tolist() == [[0.5, 1.0, 1.0]]
    assert gi.tolist() == [[8, 5, 7]]
