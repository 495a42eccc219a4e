"""Prototype (cluster centre) construction and back-out label composition
— the port of ``repro.core.prototypes``."""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.kernels import ops
from repro_torch.runtime import active

#: canonical reduction-tree width of prototype/centroid accumulations
REDUCE_BLOCKS = 8


class PrototypeSet(NamedTuple):
    x: torch.Tensor      # (n_max, d) prototype coordinates (padded)
    mass: torch.Tensor   # (n_max,) total original-unit mass per prototype
    valid: torch.Tensor  # (n_max,) bool — real prototype vs padding


def reduce_to_prototypes(
    x: torch.Tensor,
    labels: torch.Tensor,
    n_max: int,
    *,
    weights: Optional[torch.Tensor] = None,
    weighted: bool = True,
    impl: Optional[str] = None,
    n_blocks: Optional[int] = None,
) -> PrototypeSet:
    """Collapse clusters to centroid prototypes.

    ``labels`` in [0, n_max) (-1 for masked rows, which are dropped).
    ``weighted=False`` is the paper's plain centroid of the points at this
    level; ``weighted=True`` carries original-unit mass through the levels.
    ``mass`` always accumulates the true unit counts. ``n_blocks`` pins the
    accumulation order (see ``ops.blocked_segment_sum``).
    """
    cfg = active()
    impl = cfg.impl if impl is None else impl
    n_blocks = cfg.n_blocks if n_blocks is None else n_blocks
    n = x.shape[0]
    w = (torch.ones((n,), dtype=torch.float32, device=x.device) if weights is None
         else weights.float())
    safe_labels = torch.where(labels >= 0, labels.to(torch.int64), n_max)

    if weighted:
        sums, denom = ops.blocked_segment_sum(
            x, safe_labels, n_max, weights=w, n_blocks=n_blocks, impl=impl)
        mass = denom
    else:
        ones = (labels >= 0).float()
        sums, denom = ops.blocked_segment_sum(
            x, safe_labels, n_max, weights=ones, n_blocks=n_blocks, impl=impl)
        _, mass = ops.blocked_segment_sum(
            torch.zeros((n, 1), dtype=x.dtype, device=x.device), safe_labels,
            n_max, weights=w, n_blocks=n_blocks, impl=impl)
    protos = sums / torch.clamp_min(denom, 1e-12)[:, None]
    valid = denom > 0
    protos = torch.where(valid[:, None], protos, 0.0).to(x.dtype)
    return PrototypeSet(protos, mass, valid)


def compose_assignments(levels: Sequence[torch.Tensor], final: torch.Tensor
                        ) -> torch.Tensor:
    """Back out labels to the original units: ``levels[l]`` maps level-l
    points to level-(l+1) prototype ids, ``final`` maps the last level's
    prototypes to backend labels; -1 propagates."""
    lab = levels[0].to(torch.int64)
    for nxt in list(levels[1:]) + [final]:
        ok = lab >= 0
        lab = torch.where(ok, nxt.to(torch.int64)[torch.where(ok, lab, 0)], -1)
    return lab.to(torch.int32)


def standardize(x: torch.Tensor, valid: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Standardized-Euclidean preprocessing (the paper's recommended metric)."""
    if valid is None:
        mu = torch.mean(x, dim=0)
        sd = torch.std(x, dim=0, correction=0)
    else:
        w = valid.to(x.dtype)[:, None]
        denom = torch.clamp_min(torch.sum(w), 1.0)
        mu = torch.sum(x * w, dim=0) / denom
        sd = torch.sqrt(torch.sum(torch.square(x - mu) * w, dim=0) / denom)
    return (x - mu) / torch.clamp_min(sd, 1e-12)
