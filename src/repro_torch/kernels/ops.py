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
  * ``"fused_bf16"`` / ``"fused_int8"`` — the quantized shortlist of
    :meth:`repro_torch.core.index.ClusterIndex.assign`, which holds the
    frozen low-precision buffers; the stateless ops here run them as
    ``"fused"``, and ops without a fused path as ``"auto"``;
  * ``"ref"``   — the plain versions, on any device (on the card only when
    asked for explicitly).

Unknown names raise. On a CUDA tensor a kernel either launches or raises:
nothing falls back to the plain version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_assign, knn_topk, pairwise_l2, ref
from repro_torch.kernels import segment_sum as _segsum
from repro_torch.runtime import IMPLS, active

#: the fused nearest/top-k dispatch family
FUSED_IMPLS = ("fused", "fused_bf16", "fused_int8")


def resolve(impl: Optional[str], device: torch.device, *,
            fused: bool = False) -> str:
    """Dispatch policy → "ref" | "cuda" or one of :data:`FUSED_IMPLS` for
    a tensor on ``device``; ``fused`` marks the ops that have a streaming
    top-k (the others degrade the fused family to "auto")."""
    if impl is None:
        impl = active().impl
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; registered impls: {list(IMPLS)}")
    if impl in FUSED_IMPLS and not fused:
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
    if r in FUSED_IMPLS and not x.is_cuda:
        gidx = (torch.arange(x.shape[0], dtype=torch.int32, device=x.device)
                if exclude_self else None)
        return fused_assign.fused_topk_plain(x, x, k, valid, q_gidx=gidx)
    if r in FUSED_IMPLS or r == "cuda":
        return knn_topk.knn_topk(x, k, valid, exclude_self=exclude_self)
    return ref.knn(x, k, valid=valid, exclude_self=exclude_self)


def nearest_topk(
    q: torch.Tensor,
    keys: torch.Tensor,
    k: int,
    *,
    key_valid: Optional[torch.Tensor] = None,
    q_gidx: Optional[torch.Tensor] = None,
    keys_scale: Optional[torch.Tensor] = None,
    keys_zero: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
    block_k: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest valid keys of each query row (dists ascending, idx; -1 for
    unfillable slots) — the assign and blocked-kNN entry point. Every
    policy gives the same bits on exact inputs: they share the merge's tie
    rule. int8 keys (with ``keys_scale``/``keys_zero``) and bf16 keys go
    through the fused family's streaming fold (K1's int8/bf16 instances
    on the card); the composed policies dequantize or widen them first."""
    r = resolve(impl, q.device, fused=True)
    if r in FUSED_IMPLS:
        return fused_assign.fused_topk(q, keys, k, key_valid, q_gidx=q_gidx,
                                       keys_scale=keys_scale,
                                       keys_zero=keys_zero, block_k=block_k)
    if keys_scale is not None:
        keys = keys.float() * keys_scale.float() + keys_zero.float()
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


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    kv_bias: Optional[torch.Tensor] = None,
    logit_softcap: float = 0.0,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """GQA attention entry point: q (b, hq, lq, dh); k/v (b, hkv, lk, dh);
    kv_bias (b, hkv or hq, lk). K5 for a CUDA tensor, the plain version
    (kv heads repeated, dense softmax) for a CPU tensor or ``impl="ref"``."""
    if resolve(impl, q.device) == "cuda":
        return _fa.flash_attention(q, k, v, kv_bias, causal=causal, scale=scale,
                                   logit_softcap=logit_softcap)
    return _fa.flash_attention_plain(q, k, v, kv_bias, causal=causal,
                                     scale=scale, logit_softcap=logit_softcap)
