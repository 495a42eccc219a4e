"""Weighted segment sum (K3) — prototype reduce and k-means statistics.

The port of ``repro.kernels.segment_sum``. The TPU kernel contracts a
one-hot membership tile on the MXU; on the card that would be O(n·S·d)
work, so ``csrc/segment_sum.cu`` folds each segment's rows instead: the
wrapper sorts the ids (as i32) stably (grouping each segment's rows in
ascending row order) and one thread per segment sums ``w·x`` and ``w`` left to
right. Deterministic, no float atomics. For a CPU tensor the wrapper runs
the plain version, :func:`repro_torch.kernels.ref.segment_sum`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _cuda, ref


def segment_sum(
    x: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sums (S, d) f32, masses (S,) f32); ids outside [0, S) are dropped."""
    if not x.is_cuda:
        return ref.segment_sum(x, segment_ids, num_segments, weights=weights)
    dev = _cuda.require_cuda("segment_sum", x, segment_ids, weights)
    if x.ndim != 2 or x.shape[1] < 1:
        raise ValueError(f"segment_sum: want x (n, d>=1), got {tuple(x.shape)}")
    n, d = x.shape
    if tuple(segment_ids.shape) != (n,):
        raise ValueError(f"segment_sum: ids have shape "
                         f"{tuple(segment_ids.shape)}, want ({n},)")
    if weights is not None and tuple(weights.shape) != (n,):
        raise ValueError(f"segment_sum: weights have shape "
                         f"{tuple(weights.shape)}, want ({n},)")
    xf = _cuda.f32(x)
    w = (torch.ones((n,), dtype=torch.float32, device=dev) if weights is None
         else _cuda.f32(weights))
    sorted_ids, perm = torch.sort(_ids32(segment_ids, num_segments), stable=True)
    sums = torch.empty((num_segments, d), dtype=torch.float32, device=dev)
    mass = torch.empty((num_segments,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _cuda.call("segment_sum", _cuda.ptr(xf), _cuda.ptr(w),
                   _cuda.ptr(sorted_ids), _cuda.ptr(perm),
                   _cuda.ptr(sums), _cuda.ptr(mass), n, num_segments, d,
                   _cuda.stream(dev))
    if num_segments:
        segment_sum.launches += 1
    return sums, mass


segment_sum.launches = 0


def _ids32(ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The ids as contiguous i32, as the kernel reads them; wider ids are
    first clamped to [-1, S], which drops the same rows."""
    if ids.dtype != torch.int32:
        ids = _cuda.index(ids, ids.dtype).clamp(-1, num_segments)
    return _cuda.index(ids, torch.int32)
