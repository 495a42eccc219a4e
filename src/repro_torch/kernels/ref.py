"""Plain PyTorch versions of the kernels.

These are the reference semantics of the port, and the counterparts of
``repro.kernels.ref``. Every CUDA kernel of this package is checked
against them on the card, and they are what the kernel wrappers run for
tensors that lie on the CPU.

Ties follow the reference: among equal distances the earliest position
wins (``lax.top_k``). ``torch.topk`` promises no order on ties, so every
selection here is a stable sort. ``torch.matmul`` on the card runs in
full float32 only with TF32 off: :func:`pairwise_sq_l2` turns it off.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def no_tf32(t: torch.Tensor) -> None:
    """Full-f32 matrix products on the card (TF32 off), as the reference
    folds them."""
    # the reference folds distances in full f32 (Precision.HIGHEST); a TF32
    # product keeps about three decimal digits
    if t.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False


def pairwise_sq_l2(
    x: torch.Tensor,
    y: torch.Tensor,
    *,
    y_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(n, m) squared Euclidean distances ``max(|x|²+|y|²−2x·y, 0)`` in
    f32; invalid keys get ``+inf``."""
    x = x.float()
    y = y.float()
    no_tf32(x)
    xn = torch.sum(x * x, dim=-1)
    yn = torch.sum(y * y, dim=-1)
    cross = x @ y.T
    d = (xn[:, None] + yn[None, :]) - 2.0 * cross
    d = torch.clamp_min(d, 0.0)
    if y_valid is not None:
        d = torch.where(y_valid.bool()[None, :], d, torch.inf)
    return d


def _topk_rows(d: torch.Tensor, idx: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k smallest of each row, earliest position first among ties."""
    sd, pos = torch.sort(d, dim=1, stable=True)
    sd, pos = sd[:, :k], pos[:, :k]
    si = torch.gather(idx, 1, pos)
    return sd, torch.where(torch.isfinite(sd), si, -1).to(torch.int32)


def knn(
    x: torch.Tensor,
    k: int,
    *,
    valid: Optional[torch.Tensor] = None,
    exclude_self: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k nearest valid neighbours of each row of ``x`` within ``x``:
    (dists (n, k) ascending, idx (n, k) int32; unfillable slots inf/-1)."""
    n = x.shape[0]
    d = pairwise_sq_l2(x, x, y_valid=valid)
    if exclude_self:
        d.fill_diagonal_(torch.inf)
    cols = torch.arange(n, dtype=torch.int64, device=x.device)
    return _topk_rows(d, cols.expand(n, n), k)


def merge_topk(
    best_d: torch.Tensor, best_i: torch.Tensor, d: torch.Tensor,
    idx: torch.Tensor, k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold candidate (d, idx) columns into a running (n, k) best list: the
    running list wins ties over the new tile, and within the tile the
    earlier column wins — the reference's streaming merge contract."""
    cat_d = torch.cat([best_d, d], dim=1)
    cat_i = torch.cat([best_i.to(torch.int64), idx.to(torch.int64)], dim=1)
    return _topk_rows(cat_d, cat_i, k)


def segment_sum(
    x: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sums (S, d), masses (S,)): ``sums[s] = Σ_{ids==s} w·x``. Ids
    outside [0, S) are dropped.

    ``index_add_`` folds the rows of a CPU tensor in row order, as the
    reference's scatter does; on the card it uses float atomics, whose
    order varies from run to run (this version is only compared with the
    kernel there, never run on the card's main path).
    """
    n = x.shape[0]
    w = (torch.ones(n, dtype=x.dtype, device=x.device) if weights is None
         else weights.to(x.dtype))
    ids = segment_ids.to(torch.int64)
    keep = (ids >= 0) & (ids < num_segments)
    ids = torch.where(keep, ids, num_segments)  # one spill row, cut below
    sums = torch.zeros((num_segments + 1, x.shape[1]), dtype=x.dtype,
                       device=x.device)
    masses = torch.zeros((num_segments + 1,), dtype=x.dtype, device=x.device)
    sums.index_add_(0, ids, x * w[:, None])
    masses.index_add_(0, ids, w)
    return sums[:num_segments], masses[:num_segments]


def blocked_segment_sum(
    x: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    weights: Optional[torch.Tensor] = None,
    n_blocks: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`segment_sum` under the reference's fixed tree: the rows
    right-padded (with dropped ids) to ``n_blocks`` equal blocks, one
    partial per block, the partials added left to right in block order.
    ``n_blocks <= 1`` is one plain segment sum."""
    if n_blocks <= 1:
        return segment_sum(x, segment_ids, num_segments, weights=weights)
    n = x.shape[0]
    pad = (-n) % n_blocks
    xp = torch.nn.functional.pad(x, (0, 0, 0, pad))
    # padded rows get id == num_segments, which the segment sum drops; wide
    # ids are clamped first so that none wraps into range
    ids = segment_ids.to(torch.int64).clamp(-1, num_segments)
    ip = torch.nn.functional.pad(ids, (0, pad), value=num_segments)
    wp = None if weights is None else torch.nn.functional.pad(weights, (0, pad))
    nb = (n + pad) // n_blocks
    sums = masses = None
    for b in range(n_blocks):
        sl = slice(b * nb, (b + 1) * nb)
        s_b, m_b = segment_sum(xp[sl], ip[sl], num_segments,
                               weights=None if wp is None else wp[sl])
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
) -> torch.Tensor:
    """Multi-head attention, the plain version of K5 (heads already
    matched: q (b, h, lq, dh), k/v (b, h, lk, dh), kv_bias (b, h, lk)).

    Everything folds in f32 (TF32 off on the card). ``causal`` aligns the
    mask to the end of kv (query i sits at position lk − lq + i), and masks
    with −inf; ``kv_bias`` is added to the logits after the softcap
    ``cap·tanh(l/cap)``. Returns q's dtype.
    """
    orig = q.dtype
    q, k, v = q.float(), k.float(), v.float()
    no_tf32(q)
    dh = q.shape[-1]
    s = 1.0 / math.sqrt(dh) if scale is None else scale
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * s
    if logit_softcap and logit_softcap > 0.0:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    if kv_bias is not None:
        logits = logits + kv_bias.float()[:, :, None, :]
    if causal:
        lq, lk = logits.shape[-2], logits.shape[-1]
        qpos = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
        kpos = torch.arange(lk, device=q.device)[None, :]
        logits = torch.where(kpos <= qpos, logits, -torch.inf)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v)
    return out.to(orig)
