"""Dense squared-L2 distance matrix (K4) — k-means++ and Lloyd distances,
and the (n, n) matrices of HAC and DBSCAN.

The port of ``repro.kernels.pairwise_l2``: ``csrc/pairwise_l2.cu`` computes
both norms and the cross term in f32 on the CUDA cores, clamps at 0 and
writes +inf for invalid keys, in one of two instances (:func:`route`):
"small_m" (m ≤ 16 centres and d ≤ 32: a thread a row, the centres in
shared memory) or "tiled" (64 × 128 output tiles, streaming float4
stores). Both give the same bits. For a CPU tensor the wrapper runs the
plain version, :func:`repro_torch.kernels.ref.pairwise_sq_l2`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _cuda, meta, ref

#: the small-m instance of ``csrc/pairwise_l2.cu``: at most this many keys
#: and features
SMALL_M, SMALL_D = 16, 32


#: the instances of ``csrc/pairwise_l2.cu`` by their C codes
ROUTES = ("small_m", "tiled")


def route(m: int, d: int) -> str:
    """Which instance of ``csrc/pairwise_l2.cu`` a launch takes by default:
    "small_m" (m ≤ 16 and d ≤ 32, the k-means shapes) or "tiled"."""
    return "small_m" if m <= SMALL_M and d <= SMALL_D else "tiled"


def route_ok(name: str, m: int, d: int) -> bool:
    """Whether instance ``name`` can run m keys of d features: "tiled"
    anywhere, "small_m" at m ≤ 16 and d ≤ 32 (powers of two, so legal at a
    shape bucket's edge means legal in the bucket)."""
    if name == "tiled":
        return True
    return name == "small_m" and m <= SMALL_M and d <= SMALL_D


def check_route(name: Optional[str], m: int, d: int) -> str:
    """``name`` (None: :func:`route`'s rule) if it can run (m, d); raise
    ``ValueError`` otherwise — an instance asked for is never rerouted."""
    if name is None:
        return route(m, d)
    if name not in ROUTES or not route_ok(name, m, d):
        raise ValueError(f"pairwise_sq_l2: route {name!r} cannot run m={m}, "
                         f"d={d}; routes {ROUTES}")
    return name


def pairwise_sq_l2(
    x: torch.Tensor,
    y: torch.Tensor,
    y_valid: Optional[torch.Tensor] = None,
    *,
    route: Optional[str] = None,
) -> torch.Tensor:
    """(n, d) × (m, d) → (n, m) f32 distances; invalid keys → +inf.
    ``route``: the instance by name (None: the default rule); one
    that cannot run (m, d) raises; ignored for a CPU tensor. Launches
    count in ``.launches`` and per route in ``.route_launches``."""
    if x.is_meta:
        return meta.pairwise(x, y, y_valid, check_route(route, y.shape[0], x.shape[1]))
    if not _cuda.on_card(x):
        return ref.pairwise_sq_l2(x, y, y_valid=y_valid)
    _cuda.forbid_grad("pairwise_sq_l2", x, y)
    dev = _cuda.require_cuda("pairwise_sq_l2", x, y, y_valid)
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1] or x.shape[1] < 1:
        raise ValueError(f"pairwise_sq_l2: want x (n, d) and y (m, d), got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    n, d = x.shape
    m = y.shape[0]
    if max(n, m) >= 2 ** 31:
        raise ValueError(f"pairwise_sq_l2: {n} x {m} rows exceed the kernel's "
                         f"32-bit row counts")
    if y_valid is not None and tuple(y_valid.shape) != (m,):
        raise ValueError(f"pairwise_sq_l2: y_valid has shape "
                         f"{tuple(y_valid.shape)}, want ({m},)")
    way = check_route(route, m, d)
    xf, yf, v = _cuda.f32(x), _cuda.f32(y), _cuda.u8(y_valid)
    out = torch.empty((n, m), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _cuda.call("pairwise_l2", _cuda.ptr(xf), _cuda.ptr(yf), _cuda.ptr(v),
                   _cuda.ptr(out), n, m, d, ROUTES.index(way), _cuda.stream(dev))
    if n and m:
        pairwise_sq_l2.launches += 1
        pairwise_sq_l2.route_launches[way] = pairwise_sq_l2.route_launches.get(way, 0) + 1
    return out


pairwise_sq_l2.launches = 0
pairwise_sq_l2.route_launches = {}
