"""Self-kNN of a point set (K2) — the one-shot TC graph builder.

The port of ``repro.kernels.knn_topk``: k nearest valid neighbours of
each row of x within x, the row itself excluded. On the card it is the
K1 kernel (``csrc/topk.cu``) with keys = queries = x and
``q_gidx = arange(n)``; its launches are counted here, apart from K1's.
For a CPU tensor it runs the plain version, :func:`repro_torch.kernels.ref.knn`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _cuda, meta, ref
from repro_torch.kernels.fused_assign import check_route, launch_topk


def knn_topk(
    x: torch.Tensor,
    k: int,
    valid: Optional[torch.Tensor] = None,
    *,
    exclude_self: bool = True,
    route: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dists (n, k) ascending sq-L2 f32, idx (n, k) int32; unfilled slots
    inf/-1). ``route``: K1's route by name (None: its default rule; one
    that cannot run (d, k) raises; ignored for a CPU tensor). Launches
    count in ``.launches`` and per route in ``.route_launches``."""
    if x.is_meta:
        return meta.topk("K2", x, x, k, check_route(route, x.shape[1], k), valid)
    if not _cuda.on_card(x):
        return ref.knn(x, k, valid=valid, exclude_self=exclude_self)
    _cuda.forbid_grad("knn_topk", x)
    gidx = (torch.arange(x.shape[0], dtype=torch.int32, device=x.device)
            if exclude_self else None)
    out = launch_topk(x, x, k, valid, gidx, route_name=route)
    way = check_route(route, x.shape[1], k)  # the shapes passed the launch's checks
    if x.shape[0]:
        knn_topk.launches += 1
        knn_topk.route_launches[way] = knn_topk.route_launches.get(way, 0) + 1
    return out


knn_topk.launches = 0
knn_topk.route_launches = {}
