"""Streaming k-nearest-keys (K1) — the assign and blocked-kNN hot path.

The serving assign and the TC inner loop both reduce to: distances of a
query block against a big key set, keep the k best. Two versions of one
function, with the reference's merge semantics (the earliest key index
wins a distance tie, unfilled slots are (inf, -1)):

  * :func:`fused_topk` — the wrapper of the CUDA kernel ``csrc/topk.cu``
    (the port of ``repro.kernels.fused_assign._fused_kernel``). It streams
    every key tile through shared memory against a best list held in
    registers, so the (nq, p) distance matrix never exists. For a CPU
    tensor it runs :func:`fused_topk_plain`.
  * :func:`fused_topk_plain` — the same streaming fold in plain PyTorch,
    one (block_q, block_k) tile at a time (the counterpart of
    ``fused_topk_xla``); peak memory O(block_q·block_k).

The int8/bf16 key variants of the reference (``quantize_keys``,
``rescore_top1``) are not ported yet.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _cuda, ref
from repro_torch.runtime import active


def launch_topk(
    q: torch.Tensor,
    keys: torch.Tensor,
    k: int,
    key_valid: Optional[torch.Tensor],
    q_gidx: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/topk.cu`` (shared by the K1 and K2 wrappers)."""
    dev = _cuda.require_cuda("topk", q, keys, key_valid, q_gidx)
    lib = _cuda.library("topk")
    if q.ndim != 2 or keys.ndim != 2 or q.shape[1] != keys.shape[1]:
        raise ValueError(f"topk: want q (nq, d) and keys (p, d), got "
                         f"{tuple(q.shape)} and {tuple(keys.shape)}")
    nq, d = q.shape
    p = keys.shape[0]
    if not 1 <= k <= lib.repro_topk_max_k():
        raise ValueError(f"topk: k={k} outside the kernel's range "
                         f"[1, {lib.repro_topk_max_k()}]")
    if not 1 <= d <= lib.repro_topk_max_d():
        raise ValueError(f"topk: d={d} outside the kernel's range "
                         f"[1, {lib.repro_topk_max_d()}]")
    if key_valid is not None and tuple(key_valid.shape) != (p,):
        raise ValueError(f"topk: key_valid has shape {tuple(key_valid.shape)}, "
                         f"want ({p},)")
    if q_gidx is not None and tuple(q_gidx.shape) != (nq,):
        raise ValueError(f"topk: q_gidx has shape {tuple(q_gidx.shape)}, "
                         f"want ({nq},)")
    qf, kf, v = _cuda.f32(q), _cuda.f32(keys), _cuda.u8(key_valid)
    g = _cuda.index(q_gidx, torch.int32)
    out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _cuda.call("topk", _cuda.ptr(qf), _cuda.ptr(kf), _cuda.ptr(v),
                   _cuda.ptr(g), _cuda.ptr(out_d), _cuda.ptr(out_i),
                   nq, p, d, k, _cuda.stream(dev))
    return out_d, out_i


def fused_topk(
    q: torch.Tensor,
    keys: torch.Tensor,
    k: int,
    key_valid: Optional[torch.Tensor] = None,
    *,
    q_gidx: Optional[torch.Tensor] = None,
    block_k: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest valid keys of each query row (K1).

    Args:
      q: (nq, d) queries; keys: (p, d) keys (distances fold in f32).
      k: best-list length (1 for assign, t−1 for TC).
      key_valid: optional (p,) mask; invalid keys never enter a list.
      q_gidx: optional (nq,) global index of each query among the keys;
        the matching key is excluded (the blocked-kNN self-match mask).
      block_k: key block of the plain fold (CPU tensors only).

    Returns:
      (dists (nq, k) f32 ascending, idx (nq, k) int32; unfilled slots
      inf/-1).
    """
    if not q.is_cuda:
        return fused_topk_plain(q, keys, k, key_valid, q_gidx=q_gidx,
                                block_k=block_k)
    out = launch_topk(q, keys, k, key_valid, q_gidx)
    if q.shape[0]:
        fused_topk.launches += 1
    return out


fused_topk.launches = 0


def fused_topk_plain(
    q: torch.Tensor,
    keys: torch.Tensor,
    k: int,
    key_valid: Optional[torch.Tensor] = None,
    *,
    q_gidx: Optional[torch.Tensor] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain streaming fold: dense distances of one (block_q, block_k)
    tile at a time, merged into the query block's running best list, so
    peak memory is O(block_q·block_k) whatever nq and p."""
    cfg = active()
    block_q = cfg.block_q if block_q is None else block_q
    block_k = cfg.block_k if block_k is None else block_k
    nq, p = q.shape[0], keys.shape[0]
    bk = min(block_k, max(p, 1))
    out_d, out_i = [], []
    for q0 in range(0, nq, block_q):
        qb = q[q0:q0 + block_q]
        gb = None if q_gidx is None else q_gidx[q0:q0 + block_q].to(torch.int64)
        n = qb.shape[0]
        bd = torch.full((n, k), torch.inf, dtype=torch.float32, device=q.device)
        bi = torch.full((n, k), -1, dtype=torch.int32, device=q.device)
        for lo in range(0, p, bk):
            hi = min(lo + bk, p)
            v = None if key_valid is None else key_valid[lo:hi]
            d = ref.pairwise_sq_l2(qb, keys[lo:hi], y_valid=v)
            gidx = torch.arange(lo, hi, dtype=torch.int64, device=q.device)
            if gb is not None:
                d = torch.where(gb[:, None] == gidx[None, :], torch.inf, d)
            bd, bi = ref.merge_topk(bd, bi, d, gidx.expand(n, hi - lo), k)
        out_d.append(bd)
        out_i.append(bi)
    if not out_d:
        return (torch.empty((0, k), dtype=torch.float32, device=q.device),
                torch.empty((0, k), dtype=torch.int32, device=q.device))
    return torch.cat(out_d), torch.cat(out_i)
