"""Public kernel entry points and their dispatch.

Dispatch policy (``impl=``), resolved by :func:`resolve`:

  * ``None``    — the active runtime config's policy;
  * ``"auto"``  — for a CUDA tensor the hand-written kernels (``"fused"``
    on the nearest/kNN ops, ``"cuda"`` elsewhere), for a CPU tensor the
    plain PyTorch versions (``"ref"``);
  * ``"cuda"``  — each op's kernel wrapper (which runs its plain version
    when handed a CPU tensor); nearest composes the K4 distance matrix
    with the plain merge, as the reference's ``"pallas"`` does;
  * ``"fused"`` — the streaming top-k on nearest/kNN; ops without a fused
    path treat it as ``"auto"``;
  * ``"ref"``   — the plain versions, on any device (on the card only when
    asked for explicitly).

Unknown names raise. On a CUDA tensor a kernel either launches or raises:
nothing falls back to the plain version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import fused_assign, knn_topk, pairwise_l2, ref
from repro_torch.kernels import segment_sum as _segsum
from repro_torch.runtime import IMPLS, active


def resolve(impl: Optional[str], device: torch.device, *,
            fused: bool = False) -> str:
    """Dispatch policy → "ref" | "cuda" | "fused" for a tensor on
    ``device``; ``fused`` marks the ops that have a streaming top-k."""
    if impl is None:
        impl = active().impl
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; registered impls: {list(IMPLS)}")
    if impl == "fused" and not fused:
        impl = "auto"
    if impl == "auto":
        if torch.device(device).type == "cuda":
            impl = "fused" if fused else "cuda"
        else:
            impl = "ref"
    return impl


def pairwise_sq_l2(
    x: torch.Tensor,
    y: torch.Tensor,
    *,
    y_valid: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
) -> torch.Tensor:
    if resolve(impl, x.device) == "cuda":
        return pairwise_l2.pairwise_sq_l2(x, y, y_valid)
    return ref.pairwise_sq_l2(x, y, y_valid=y_valid)


def knn(
    x: torch.Tensor,
    k: int,
    *,
    valid: Optional[torch.Tensor] = None,
    exclude_self: bool = True,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Self-kNN: K2 on the card (under "fused" and "cuda"); on the CPU the
    fused policy runs the plain streaming fold, the others the dense
    reference."""
    r = resolve(impl, x.device, fused=True)
    if r == "fused" and not x.is_cuda:
        gidx = (torch.arange(x.shape[0], dtype=torch.int32, device=x.device)
                if exclude_self else None)
        return fused_assign.fused_topk_plain(x, x, k, valid, q_gidx=gidx)
    if r in ("fused", "cuda"):
        return knn_topk.knn_topk(x, k, valid, exclude_self=exclude_self)
    return ref.knn(x, k, valid=valid, exclude_self=exclude_self)


def nearest_topk(
    q: torch.Tensor,
    keys: torch.Tensor,
    k: int,
    *,
    key_valid: Optional[torch.Tensor] = None,
    q_gidx: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
    block_k: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest valid keys of each query row (dists ascending, idx; -1 for
    unfillable slots) — the assign and blocked-kNN entry point. Every
    policy gives the same bits on exact inputs: they share the merge's tie
    rule."""
    r = resolve(impl, q.device, fused=True)
    if r == "fused":
        return fused_assign.fused_topk(q, keys, k, key_valid, q_gidx=q_gidx,
                                       block_k=block_k)
    d = pairwise_sq_l2(q, keys, y_valid=key_valid, impl=r)
    kcols = torch.arange(keys.shape[0], dtype=torch.int64, device=q.device)
    if q_gidx is not None:
        d = torch.where(q_gidx.to(torch.int64)[:, None] == kcols[None, :],
                        torch.inf, d)
    nq = q.shape[0]
    init_d = torch.full((nq, k), torch.inf, dtype=torch.float32, device=q.device)
    init_i = torch.full((nq, k), -1, dtype=torch.int32, device=q.device)
    return ref.merge_topk(init_d, init_i, d, kcols.expand(nq, -1), k)


def segment_sum(
    x: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    weights: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    if resolve(impl, x.device) == "cuda":
        return _segsum.segment_sum(x, segment_ids, num_segments, weights)
    return ref.segment_sum(x, segment_ids, num_segments, weights=weights)


def blocked_segment_sum(
    x: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    weights: Optional[torch.Tensor] = None,
    n_blocks: Optional[int] = None,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment sum with a fixed reduction tree: rows split into ``n_blocks``
    equal blocks (right-padded with dropped ids), one partial per block,
    partials added left to right in block order. The order is pinned by
    ``n_blocks`` alone, which is what makes the bits reproducible; it
    defaults to the runtime config (8). ``n_blocks <= 1`` is one plain
    segment sum."""
    if n_blocks is None:
        n_blocks = active().n_blocks
    if n_blocks <= 1:
        return segment_sum(x, segment_ids, num_segments, weights=weights,
                           impl=impl)
    n = x.shape[0]
    pad = (-n) % n_blocks
    xp = torch.nn.functional.pad(x, (0, 0, 0, pad))
    # padded rows get id == num_segments, which the segment sum drops; the
    # ids go to i32 once here (the kernel reads i32), clamped first so that
    # no wide id wraps into range
    ids = segment_ids
    if ids.dtype != torch.int32:
        ids = ids.clamp(-1, num_segments).to(torch.int32)
    ip = torch.nn.functional.pad(ids, (0, pad), value=num_segments)
    wp = None if weights is None else torch.nn.functional.pad(weights, (0, pad))
    nb = (n + pad) // n_blocks
    sums = masses = None
    for b in range(n_blocks):
        sl = slice(b * nb, (b + 1) * nb)
        s_b, m_b = segment_sum(xp[sl], ip[sl], num_segments,
                               weights=None if wp is None else wp[sl], impl=impl)
        sums = s_b if sums is None else sums + s_b
        masses = m_b if masses is None else masses + m_b
    return sums, masses
