"""Gradient compression for the slow (cross-pod) axis — the port of
``repro.train.compression``: an int8 quantized all-reduce with error
feedback.

Per-tensor symmetric int8 quantization, a sum of int32 accumulators (exact
in any order), dequantization, and an error-feedback buffer that carries
the quantization residual into the next step (Karimireddy et al., 2019).
The collectives run over one dimension of a ``DeviceMesh``, named as the
reference names its ``shard_map`` axis (``mesh=``, else the runtime's
``mesh``), one process a rank: the reference's ``pmax`` of the scales and
``psum`` of the int32 payloads are :class:`~repro_torch.core._collectives.Axis`
calls, and every float operation is the reference's, in its order, so the
results are the reference's bits. No train step reads them: the
reference's ``compress_pod_grads`` is stored and unread there too.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.runtime import active


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` rounded once, as the reference divides: the divisor is a
    tensor on ``a``'s device (CUDA multiplies by the reciprocal of a Python
    scalar divisor, which can be an ulp off)."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8. Returns (q int8, scale f32)."""
    xf = x.to(torch.float32)
    amax = torch.max(torch.abs(xf))
    scale = _div(torch.clamp_min(amax, 1e-12), 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _axis(axis_name: str, mesh):
    from repro_torch.core._collectives import Axis

    mesh = active().mesh if mesh is None else mesh
    if mesh is None:
        raise ValueError("the compressed all-reduce needs a mesh: pass mesh= "
                         "or set the runtime's mesh")
    return Axis(mesh, axis_name)


def compressed_psum(x: torch.Tensor, axis_name: str, *, mesh=None) -> torch.Tensor:
    """Mean over ``axis_name`` with an int8 payload (≈4× fewer bytes than
    f32); the scales are reconciled with an f32 max across the ranks."""
    axis = _axis(axis_name, mesh)
    q, scale = quantize_int8(x)
    smax = axis.pmax(scale)
    requant = torch.clamp(torch.round(dequantize_int8(q, scale) / smax),
                          -127, 127).to(torch.int8)
    total = axis.psum(requant.to(torch.int32))  # exact in any order
    return _div(total.to(torch.float32) * smax, axis.size)


def psum_with_error_feedback(x: torch.Tensor, err: torch.Tensor, axis_name: str,
                             *, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compressed mean of ``x + err``; returns (mean, new_err), ``new_err``
    the local quantization residual fed back into the next step's input."""
    axis = _axis(axis_name, mesh)
    y = x.to(torch.float32) + err
    _, scale = quantize_int8(y)
    smax = axis.pmax(scale)
    requant = torch.clamp(torch.round(y / smax), -127, 127).to(torch.int8)
    local_deq = requant.to(torch.float32) * smax
    new_err = y - local_deq
    total = axis.psum(requant.to(torch.int32))  # exact in any order
    return _div(total.to(torch.float32) * smax, axis.size), new_err


def tree_compressed_psum(tree: Any, err_tree: Any, axis_name: str, *, mesh=None):
    """:func:`psum_with_error_feedback` over every leaf of a dict or list
    tree (dicts in sorted key order, the reference's leaf order); each
    mean is cast to its leaf's dtype. Returns (means, new errors)."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        outs = [tree_compressed_psum(tree[k], err_tree[k], axis_name, mesh=mesh)
                for k in keys]
        return ({k: o for k, (o, _) in zip(keys, outs, strict=True)},
                {k: e for k, (_, e) in zip(keys, outs, strict=True)})
    if isinstance(tree, (list, tuple)):
        outs = [tree_compressed_psum(x, e, axis_name, mesh=mesh)
                for x, e in zip(tree, err_tree, strict=True)]
        return type(tree)(o for o, _ in outs), type(tree)(e for _, e in outs)
    out, new_err = psum_with_error_feedback(tree, err_tree, axis_name, mesh=mesh)
    return out.to(tree.dtype), new_err
