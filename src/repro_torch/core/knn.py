"""kNN-graph construction — the computational bottleneck of TC.

Brute force, organised two ways by scale (the counterparts of
``repro.core.knn``; the multi-device ``ring_knn`` is not ported yet):

  * :func:`knn_graph`         — one-shot self-kNN (K2 on the card).
  * :func:`knn_graph_blocked` — query blocks against the whole key set.
    On the card the inner loop is K1, which streams every key tile itself
    and takes the self-exclusion as global query indices, so neither an
    (n, n) nor a (block, block) distance matrix is ever written. The
    plain path folds (block, block) distance tiles into a running best
    list with the shared merge.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import merge_topk
from repro_torch.runtime import active

#: what ``knn_block == 0`` ("auto") means: one-shot up to this row count,
#: blocks of this size above
AUTO_KNN_BLOCK = 8192


def resolve_auto_block(n: int, d: int = 0, k: int = 0) -> int:
    """What ``knn_block == 0`` resolves to for an (n, d) problem (the
    tuning cache of the reference is not ported: always the constant)."""
    return AUTO_KNN_BLOCK


def knn_graph(
    x: torch.Tensor,
    k: int,
    *,
    valid: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact (dists, idx) of the k nearest valid neighbours of each row;
    ``k`` may exceed the valid count (those slots are inf/-1) but not n."""
    if k > x.shape[0]:
        raise ValueError(
            f"knn_graph: k={k} exceeds the number of rows n={x.shape[0]}; "
            f"slots beyond the valid count are padded with -1, but k itself "
            f"must be <= n")
    return ops.knn(x, k, valid=valid, exclude_self=True, impl=impl)


def knn_graph_blocked(
    x: torch.Tensor,
    k: int,
    *,
    valid: Optional[torch.Tensor] = None,
    block: Optional[int] = None,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked exact kNN for n beyond one-shot range: query blocks of
    ``block`` rows (default: the config's ``knn_block``, auto when 0)."""
    cfg = active()
    n = x.shape[0]
    if block is None:
        block = cfg.knn_block or resolve_auto_block(n, x.shape[1], k)
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=x.device)
    r = ops.resolve(impl, x.device, fused=True)
    pad = (-n) % block
    xp = torch.nn.functional.pad(x, (0, 0, 0, pad))
    vp = torch.nn.functional.pad(valid.bool(), (0, pad))
    npad = n + pad
    out_d, out_i = [], []
    for q0 in range(0, npad, block):
        q = xp[q0:q0 + block]
        q_gidx = torch.arange(q0, q0 + block, dtype=torch.int64, device=x.device)
        if r in ops.FUSED_IMPLS:
            # the kernel streams the keys itself; self-exclusion by global
            # query index
            bd, bi = ops.nearest_topk(q, xp, k, key_valid=vp,
                                      q_gidx=q_gidx.to(torch.int32),
                                      impl="fused")
        else:
            bd = torch.full((block, k), torch.inf, dtype=torch.float32,
                            device=x.device)
            bi = torch.full((block, k), -1, dtype=torch.int32, device=x.device)
            for k0 in range(0, npad, block):
                d = ops.pairwise_sq_l2(q, xp[k0:k0 + block],
                                       y_valid=vp[k0:k0 + block], impl=r)
                k_gidx = torch.arange(k0, k0 + block, dtype=torch.int64,
                                      device=x.device)
                d = torch.where(q_gidx[:, None] == k_gidx[None, :], torch.inf, d)
                bd, bi = merge_topk(bd, bi, d, k_gidx.expand(block, block), k)
        out_d.append(bd)
        out_i.append(bi)
    return torch.cat(out_d)[:n], torch.cat(out_i)[:n]
