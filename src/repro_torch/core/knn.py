"""kNN-graph construction — the computational bottleneck of TC.

Brute force, organised three ways by scale (the counterparts of
``repro.core.knn``):

  * :func:`knn_graph`         — one-shot self-kNN (K2 on the card).
  * :func:`knn_graph_blocked` — query blocks against the whole key set.
    On the card the inner loop is K1, which streams every key tile itself
    and takes the self-exclusion as global query indices, so neither an
    (n, n) nor a (block, block) distance matrix is ever written. The
    plain path folds (block, block) distance tiles into a running best
    list with the shared merge.
  * :func:`ring_knn`          — rows sharded over a mesh dimension: key
    blocks travel around the ring of ranks and each rank folds every
    visiting block into its queries' best lists (K1 on the card).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core._collectives import Axis
from repro_torch.kernels import ops
from repro_torch.kernels.ref import merge_topk
from repro_torch.runtime import active

#: what ``knn_block == 0`` ("auto") means: one-shot up to this row count,
#: blocks of this size above; with the tuning policy on, the measured
#: winner of this device kind and shape bucket replaces it
AUTO_KNN_BLOCK = 8192


def resolve_auto_block(n: int, d: int = 0, k: int = 0, dtype: str = "float32",
                       device=None) -> int:
    """What ``knn_block == 0`` ("auto") resolves to for an (n, d) problem
    on ``device`` (default: the configured one): the ``"knn_block"``
    cell's winner when the tuning policy is on and has one, else
    :data:`AUTO_KNN_BLOCK`. ``dtype`` is the data's element type name, so
    this lookup and ``plan_fit``'s key the cache identically."""
    if active().tune != "off":
        from repro_torch import tune  # no import cycle through core

        tuned = tune.tuned_params("knn_block", dtype=dtype, device=device,
                                  n=n, d=d, k=k)
        if tuned.get("knn_block"):
            return int(tuned["knn_block"])
    return AUTO_KNN_BLOCK


def knn_graph(
    x: torch.Tensor,
    k: int,
    *,
    valid: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
    route: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact (dists, idx) of the k nearest valid neighbours of each row;
    ``k`` may exceed the valid count (those slots are inf/-1) but not n.
    ``route``: K2's route on the card (default: the tuned one, else its
    shape rule)."""
    if k > x.shape[0]:
        raise ValueError(
            f"knn_graph: k={k} exceeds the number of rows n={x.shape[0]}; "
            f"slots beyond the valid count are padded with -1, but k itself "
            f"must be <= n")
    return ops.knn(x, k, valid=valid, exclude_self=True, impl=impl, route=route)


def knn_graph_blocked(
    x: torch.Tensor,
    k: int,
    *,
    valid: Optional[torch.Tensor] = None,
    block: Optional[int] = None,
    impl: Optional[str] = None,
    route: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked exact kNN for n beyond one-shot range: query blocks of
    ``block`` rows (default: the config's ``knn_block``, auto when 0).
    ``route``: K1's route on the fused family (default: the tuned one,
    else its shape rule)."""
    cfg = active()
    n = x.shape[0]
    if block is None:
        block = cfg.knn_block or resolve_auto_block(
            n, x.shape[1], k, ops.dtype_name(x.dtype), x.device)
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
                                      impl="fused", route=route)
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


def _merge_by_index(best_d: torch.Tensor, best_i: torch.Tensor, d: torch.Tensor,
                    idx: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest of two (n, ·) lists under the total order (dist,
    global index): the lowest index wins a tie whichever list holds it
    (the ring visits blocks in rank order from this rank, not from 0)."""
    cat_d = torch.cat([best_d, d], dim=1)
    cat_i = torch.cat([best_i.to(torch.int64), idx.to(torch.int64)], dim=1)
    by_i = torch.argsort(cat_i, dim=1, stable=True)
    cat_d, cat_i = torch.gather(cat_d, 1, by_i), torch.gather(cat_i, 1, by_i)
    sd, pos = torch.sort(cat_d, dim=1, stable=True)
    sd, pos = sd[:, :k], pos[:, :k]
    si = torch.gather(cat_i, 1, pos)
    return sd, torch.where(torch.isfinite(sd), si, -1).to(torch.int32)


def ring_knn(
    x_local: torch.Tensor,
    k: int,
    *,
    axis: Axis,
    valid: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
    route: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sharded exact kNN: this rank holds rows ``[r·n_local, (r+1)·n_local)``
    of the global point set; returns the (dists, global idx) of the k
    nearest valid rows of each local row, itself excluded — the function
    :func:`knn_graph` computes on the concatenated rows.

    At step s the visiting key block is that of rank ``(r + s) % P``; it
    goes through the streaming top-k (K1 on the card, on ``route``) with
    the self-exclusion as query indices shifted into the block's frame
    (out of ``[0, n_local)`` for every other block), and the block's list
    joins the running one under (dist, global index): the lowest index
    wins a tie, as in one pass over all keys. The reference forms a dense
    (n_local, n_local) block per step instead; at the fit's size that is
    tens of GB. The block then moves one rank down the ring (P - 1 moves:
    one all-gather's bytes, never held at once)."""
    n_local = x_local.shape[0]
    dev = x_local.device
    if valid is None:
        valid = torch.ones((n_local,), dtype=torch.bool, device=dev)
    p, me = axis.size, axis.index
    q_gidx = me * n_local + torch.arange(n_local, dtype=torch.int64, device=dev)
    bd = torch.full((n_local, k), torch.inf, dtype=torch.float32, device=dev)
    bi = torch.full((n_local, k), -1, dtype=torch.int32, device=dev)
    keys, kval = x_local, valid.bool()
    for s in range(p):
        src = (me + s) % p  # owner of the visiting block
        d, i = ops.nearest_topk(x_local, keys, k, key_valid=kval,
                                q_gidx=(q_gidx - src * n_local).to(torch.int32),
                                impl=impl, route=route)
        gi = torch.where(i >= 0, i.to(torch.int64) + src * n_local, -1)
        bd, bi = _merge_by_index(bd, bi, d, gi, k)
        if s + 1 < p:
            keys = axis.ring_shift(keys)
            kval = axis.ring_shift(kval.to(torch.uint8)).bool()
    return bd, bi
