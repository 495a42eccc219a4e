"""Int8 quantization of a gradient — the standalone half of
``repro.train.compression``.

Per-tensor symmetric int8: the payload the reference's compressed
cross-pod all-reduce puts on the wire. The collectives themselves
(``compressed_psum``, ``psum_with_error_feedback``,
``tree_compressed_psum``) need a collective axis and wait for the port's
mesh (ROADMAP.md, Queue 1, item 7b).
"""
from __future__ import annotations

from typing import Tuple

import torch


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8. Returns (q int8, scale f32)."""
    xf = x.to(torch.float32)
    amax = torch.max(torch.abs(xf))
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale
