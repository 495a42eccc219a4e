"""IHTC — Iterative Hybridized Threshold Clustering (the paper's §3.2): the
memory executor, the port of ``repro.core.ihtc._execute_memory``.

ITIS reduces n units to ≤ n/t^m weighted prototypes on the device, the
planner's epilogue runs the backend on them and backs labels out to all
n units; every final cluster holds ≥ t^m original units. :func:`ihtc`
is the reference's deprecated alias of ``fit``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.cluster.registry import BackendFn
from repro_torch.core.itis import itis
from repro_torch.core.plan import FitPlan, FitResult, Reduction, fit, register_executor

#: deprecated alias: every executor returns a FitResult
IHTCResult = FitResult


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


def ihtc(
    x,
    t: int,
    m: int,
    backend: Union[str, BackendFn] = "kmeans",
    *,
    weights=None,
    weighted: bool = False,
    use_mass_in_backend: bool = True,
    key: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
    knn_block: Optional[int] = None,
    mesh=None,
    axis_name: Optional[str] = None,
    device=None,
    **backend_kwargs,
) -> FitResult:
    """IHTC on a resident array (a deprecated alias of
    :func:`repro_torch.fit`). A mesh, passed or configured, plans the
    "sharded" executor; an explicit ``knn_block`` is refused there (the
    ring kNN has no blocked scan)."""
    return fit(x, t, m, backend, weights=weights, weighted=weighted,
               use_mass_in_backend=use_mass_in_backend, key=key, impl=impl,
               knn_block=knn_block, mesh=mesh, axis_name=axis_name,
               device=device, driver="ihtc", **backend_kwargs)
