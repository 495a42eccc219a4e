"""Blocked weighted segment sum (K3) — prototype reduce and k-means statistics.

The port of ``repro.kernels.segment_sum`` as the reference always calls
it, through ``ops.blocked_segment_sum``'s fixed tree: rows fall into
``n_blocks`` contiguous blocks, each block's partial folds its rows in
row order, and the partials add left to right in block order. The TPU
kernel contracts a one-hot membership tile on the MXU; on the card that
would be O(n·S·d) work, so ``csrc/segment_sum.cu`` folds each segment's
rows instead, the whole tree in one call (no sort, no per-block loop):
few segments (S ≤ :data:`FEW_SEGMENTS`) by a thread block per (segment,
block) that walks the block's rows, many by a counting grouping of the
rows on the card. Deterministic, no float atomics: the bits of the plain
version on the CPU. For a CPU tensor the wrapper runs the plain version,
:func:`repro_torch.kernels.ref.blocked_segment_sum`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _cuda, meta, ref

#: up to this many segments the kernel walks each block's rows once per
#: segment (the k-means statistics); above it, it groups the rows first
FEW_SEGMENTS = 64


#: the kernel's two paths, by their C mode codes
ROUTES = ("few", "many")


def plan(n: int, num_segments: int, n_blocks: int) -> Tuple[str, int]:
    """(path, rows per block) of a call: "few" or "many" segments, and
    ``nb = ceil(n / n_blocks)`` (row ``r`` lies in block ``r // nb``; the
    reference right-pads the rows to ``n_blocks · nb``)."""
    nb = max(1, -(-n // max(1, n_blocks)))
    return ("few" if num_segments <= FEW_SEGMENTS else "many"), nb


def route_ok(name: str, num_segments: int) -> bool:
    """Whether path ``name`` may run ``num_segments`` segments: "many"
    always, "few" up to :data:`FEW_SEGMENTS` (a thread block per segment
    and block; a power of two, so legal at a shape bucket's edge means
    legal in the bucket). Both give the same bits."""
    if name == "many":
        return True
    return name == "few" and num_segments <= FEW_SEGMENTS


def blocked_segment_sum(
    x: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    weights: Optional[torch.Tensor] = None,
    n_blocks: int = 1,
    *,
    route: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sums (S, d) f32, masses (S,) f32) under the ``n_blocks`` fold; ids
    outside [0, S) are dropped. ``route``: the path by name (None:
    :func:`plan`'s rule); one that cannot run S segments raises; ignored
    for a CPU tensor. One kernel call, counted once in
    ``blocked_segment_sum.launches`` and per path in ``.route_launches``."""
    if x.is_meta:
        way = route if route is not None else plan(x.shape[0], num_segments, n_blocks)[0]
        return meta.segment_sum(x, segment_ids, num_segments, weights, way)
    if not _cuda.on_card(x):
        return ref.blocked_segment_sum(x, segment_ids, num_segments,
                                       weights=weights, n_blocks=n_blocks)
    _cuda.forbid_grad("segment_sum", x, weights)
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
    if n >= 2 ** 31:
        raise ValueError(f"segment_sum: {n} rows; the kernel indexes rows in i32")
    if num_segments < 0:
        raise ValueError(f"segment_sum: num_segments={num_segments}")
    path, nb = plan(n, num_segments, n_blocks)
    if route is not None:
        if route not in ROUTES or not route_ok(route, num_segments):
            raise ValueError(f"segment_sum: route {route!r} cannot run "
                             f"{num_segments} segments; routes {ROUTES}")
        path = route
    if n == 0 or num_segments == 0:  # nothing to fold: the sums are +0.0
        return (torch.zeros((num_segments, d), dtype=torch.float32, device=dev),
                torch.zeros((num_segments,), dtype=torch.float32, device=dev))
    xf = _cuda.f32(x)
    w = (torch.ones((n,), dtype=torch.float32, device=dev) if weights is None
         else _cuda.f32(weights))
    ids = _cuda.index(segment_ids, segment_ids.dtype
                      if segment_ids.dtype in (torch.int32, torch.int64)
                      else torch.int64)
    nblk = -(-n // nb)  # blocks that hold rows; the rest add +0.0
    mode = 0 if path == "few" else 1
    lib = _cuda.library("segment_sum")
    nbytes = lib.repro_segment_sum_scratch_bytes(n, num_segments, d, nblk, mode)
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    sums = torch.empty((num_segments, d), dtype=torch.float32, device=dev)
    mass = torch.empty((num_segments,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _cuda.call("segment_sum", _cuda.ptr(xf), _cuda.ptr(w), _cuda.ptr(ids),
                   int(ids.dtype == torch.int64), _cuda.ptr(sums),
                   _cuda.ptr(mass), n, num_segments, d, nb, nblk, mode,
                   _cuda.ptr(scratch), _cuda.stream(dev))
    blocked_segment_sum.launches += 1
    blocked_segment_sum.route_launches[path] = (
        blocked_segment_sum.route_launches.get(path, 0) + 1)
    return sums, mass


blocked_segment_sum.launches = 0
blocked_segment_sum.route_launches = {}


def segment_sum(
    x: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    weights: Optional[torch.Tensor] = None,
    *,
    route: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sums (S, d) f32, masses (S,) f32); ids outside [0, S) are dropped:
    :func:`blocked_segment_sum` with one block."""
    return blocked_segment_sum(x, segment_ids, num_segments, weights, n_blocks=1,
                               route=route)
