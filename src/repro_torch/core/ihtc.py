"""IHTC — Iterative Hybridized Threshold Clustering (the paper's §3.2): the
memory executor, the port of ``repro.core.ihtc._execute_memory``.

ITIS reduces n units to ≤ n/t^m weighted prototypes on the device, the
planner's epilogue runs the backend on them and backs labels out to all
n units; every final cluster holds ≥ t^m original units.
"""
from __future__ import annotations

import torch

from repro_torch.core.itis import itis
from repro_torch.core.plan import FitPlan, Reduction, register_executor


@register_executor("memory")
def _execute_memory(plan: FitPlan, x: torch.Tensor) -> Reduction:
    """Resident-array strategy: one ``itis_step`` per level over a padded
    buffer on the plan's device; level maps stay there for the back-out."""
    key_itis, _ = plan.split_keys()
    r = itis(x, plan.t, plan.m, weights=plan.weights, key=key_itis,
             weighted=plan.weighted, impl=plan.impl, knn_block=plan.knn_block,
             min_points=plan.min_points, n_blocks=plan.n_blocks,
             knn_route=plan.knn_route)
    info = {
        "level_sizes": plan.schedule(x.shape[0])[: len(r.assignments) + 1],
        "n_valid": list(r.n_valid),
        "mis_rounds": list(r.mis_rounds),
    }
    return Reduction(protos=r.protos, mass=r.mass, valid=r.valid,
                     n_prototypes=r.n_prototypes, assignments=r.assignments,
                     n0=x.shape[0], info=info)
