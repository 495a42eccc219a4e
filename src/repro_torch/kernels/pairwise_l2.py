"""Dense squared-L2 distance matrix (K4) — k-means++ and Lloyd distances.

The port of ``repro.kernels.pairwise_l2``: ``csrc/pairwise_l2.cu`` tiles
the (n, m) output, computes both norms and the cross term in f32 in the
kernel, clamps at 0 and writes +inf for invalid keys. For a CPU tensor the
wrapper runs the plain version, :func:`repro_torch.kernels.ref.pairwise_sq_l2`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _cuda, ref

#: rows the kernel's grid can cover (grid.y ≤ 65535 tiles of 32 rows)
MAX_ROWS = 65535 * 32


def pairwise_sq_l2(
    x: torch.Tensor,
    y: torch.Tensor,
    y_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(n, d) × (m, d) → (n, m) f32 distances; invalid keys → +inf."""
    if not x.is_cuda:
        return ref.pairwise_sq_l2(x, y, y_valid=y_valid)
    dev = _cuda.require_cuda("pairwise_sq_l2", x, y, y_valid)
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1] or x.shape[1] < 1:
        raise ValueError(f"pairwise_sq_l2: want x (n, d) and y (m, d), got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    n, d = x.shape
    m = y.shape[0]
    if n > MAX_ROWS:
        raise ValueError(f"pairwise_sq_l2: n={n} exceeds the kernel's grid "
                         f"({MAX_ROWS} rows)")
    if y_valid is not None and tuple(y_valid.shape) != (m,):
        raise ValueError(f"pairwise_sq_l2: y_valid has shape "
                         f"{tuple(y_valid.shape)}, want ({m},)")
    xf, yf, v = _cuda.f32(x), _cuda.f32(y), _cuda.u8(y_valid)
    out = torch.empty((n, m), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _cuda.call("pairwise_l2", _cuda.ptr(xf), _cuda.ptr(yf), _cuda.ptr(v),
                   _cuda.ptr(out), n, m, d, _cuda.stream(dev))
    if n and m:
        pairwise_sq_l2.launches += 1
    return out


pairwise_sq_l2.launches = 0
