"""Weighted DBSCAN (the paper's Appendix-B backend), mask- and mass-aware —
the port of ``repro.cluster.dbscan``.

Density counts use sample weights, so DBSCAN on ITIS prototypes with
masses approximates density on the original units. Core-point connected
components come from iterative min-label propagation over the ε-graph,
as in the reference; its ``lax.while_loop`` is a host loop here that
reads its ``changed`` flag once a round.

The (n, n) sq-L2 matrix of the valid rows comes from K4 on the card.
Where the reference forms (n, n) int32 and f32 temporaries (10 GB each at
n = 50,000), the port keeps one boolean ε-graph and forms the density and
the masked minima a block of rows at a time. Both are exact (integer
masses below 2²⁴ sum exactly in any order), so the labels and core flags
are the reference's.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.cluster.registry import register_backend
from repro_torch.kernels import ops
from repro_torch.runtime import active

#: elements of the (rows, n) temporaries of one row block
BLOCK_ELEMENTS = 1 << 27


class DBSCANResult(NamedTuple):
    labels: torch.Tensor   # (n,) int32; -1 = noise or invalid
    is_core: torch.Tensor  # (n,) bool
    rounds: int            # min-label propagation rounds


def _f32(v: float) -> float:
    """``v`` rounded to f32, as the reference's traced scalars are."""
    return float(torch.tensor(v, dtype=torch.float32))


def _masked_min(mask: torch.Tensor, lab: torch.Tensor, rows: int,
                sentinel: int) -> torch.Tensor:
    """Per row: the least ``lab[j]`` over the columns j where ``mask`` is
    set (``sentinel`` where none is), ``rows`` rows at a time."""
    out = torch.empty_like(lab)
    for r0 in range(0, mask.shape[0], rows):
        blk = mask[r0:r0 + rows]
        out[r0:r0 + rows] = torch.where(blk, lab[None, :], sentinel).amin(dim=1)
    return out


def dbscan(
    x: torch.Tensor,
    eps: float,
    min_pts: float,
    *,
    valid: Optional[torch.Tensor] = None,
    weights: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
) -> DBSCANResult:
    """Weighted DBSCAN on x's device; ``impl`` defaults to the runtime
    config (the (n, n) matrix: K4 on the card, its plain version under
    "ref")."""
    impl = active().impl if impl is None else impl
    n = x.shape[0]
    dev = x.device
    valid = (torch.ones((n,), dtype=torch.bool, device=dev) if valid is None
             else valid.bool())
    weights = (torch.ones((n,), dtype=torch.float32, device=dev) if weights is None
               else weights.float())
    eps2 = _f32(_f32(eps) * _f32(eps))
    # masked rows are in no ε-neighbourhood: DBSCAN runs on the valid rows
    # alone, in their order (a monotone renumbering keeps the least-index
    # component labels and their ranks, so the labels are the reference's)
    keep = torch.nonzero(valid).squeeze(1)
    nv = keep.numel()
    xv, w = x[keep], weights[keep]
    rows = max(1, BLOCK_ELEMENTS // max(nv, 1))

    d = ops.pairwise_sq_l2(xv, xv, impl=impl)
    adj = torch.empty((nv, nv), dtype=torch.bool, device=dev)  # ε-graph, self included
    density = torch.empty((nv,), dtype=torch.float32, device=dev)
    for r0 in range(0, nv, rows):
        blk = d[r0:r0 + rows] <= eps2
        adj[r0:r0 + rows] = blk
        density[r0:r0 + rows] = torch.where(blk, w[None, :], 0.0).sum(dim=1)
    del d
    core = density >= _f32(min_pts)

    # from here on only edges to core points count (the core rows' graph
    # for propagation, every row's for the border labels)
    adj &= core[None, :]
    idx = torch.arange(nv, dtype=torch.int32, device=dev)
    lab = torch.where(core, idx, nv)  # nv is the +inf sentinel
    rounds = 0
    while True:
        new = torch.minimum(lab, _masked_min(adj, lab, rows, nv))
        new = torch.where(core, new, nv)
        rounds += 1
        changed = bool((new != lab).any())  # the round's one read
        lab = new
        if not changed:
            break

    # border points adopt the least component label among neighbouring cores
    full = torch.where(core, lab, _masked_min(adj, lab, rows, nv))

    # compact the component representatives to [0, n_clusters)
    is_rep = (full == idx) & core
    rank = torch.cumsum(is_rep.to(torch.int32), 0, dtype=torch.int32) - 1
    some = full < nv
    labels = torch.full((n,), -1, dtype=torch.int32, device=dev)
    labels[keep] = torch.where(some, rank[torch.where(some, full, 0).long()], -1)
    is_core = torch.zeros((n,), dtype=torch.bool, device=dev)
    is_core[keep] = core
    return DBSCANResult(labels, is_core, rounds)


@register_backend("dbscan")
def dbscan_masked(
    x: torch.Tensor,
    *,
    eps: float = 0.5,
    min_pts: float = 5.0,
    valid: Optional[torch.Tensor] = None,
    weights: Optional[torch.Tensor] = None,
    key: Optional[torch.Tensor] = None,  # unused; uniform backend signature
    impl: Optional[str] = None,
    **_: object,
) -> DBSCANResult:
    """IHTC backend adapter (the planner reads ``.labels``; -1 = noise)."""
    del key
    return dbscan(x, eps, min_pts, valid=valid, weights=weights, impl=impl)
