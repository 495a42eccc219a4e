"""Fit planner and executors — the port of ``repro.core.plan``, slimmed to
the resident-array ("memory") executor.

  * :class:`FitPlan` — everything decided before data moves: validated
    reduction parameters, the key schedule, the backend, the dispatch
    knobs resolved from the active runtime config, the device.
  * the executor registry — an executor owns its data-movement strategy
    and returns a :class:`Reduction`.
  * the epilogue — backend finalize and label back-out, once, here.
  * :class:`FitResult` — the fitted artifact ``ClusterIndex.build`` takes.

Streaming, sharded and tuned fits are not ported yet: a chunk iterator
raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, NamedTuple, Optional, \
    Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import prng
from repro_torch.cluster.registry import BackendFn, resolve_backend
from repro_torch.core.itis import level_sizes, validate_reduction_params
from repro_torch.core.prototypes import compose_assignments
from repro_torch.runtime import active, configure, resolve_device

ExecutorFn = Callable[["FitPlan", torch.Tensor], "Reduction"]

_REGISTRY: Dict[str, ExecutorFn] = {}


def register_executor(name: str) -> Callable[[ExecutorFn], ExecutorFn]:
    """Decorator: ``@register_executor("memory")`` on an ExecutorFn."""

    def deco(fn: ExecutorFn) -> ExecutorFn:
        if name in _REGISTRY and _REGISTRY[name] is not fn:
            raise ValueError(f"executor {name!r} is already registered "
                             f"({_REGISTRY[name]!r})")
        _REGISTRY[name] = fn
        return fn

    return deco


def _ensure_builtin_executors() -> None:
    from repro_torch.core import ihtc  # noqa: F401  (registers "memory")


def resolve_executor(name: str) -> ExecutorFn:
    _ensure_builtin_executors()
    if name not in _REGISTRY:
        raise ValueError(f"unknown executor {name!r}; have {available_executors()}")
    return _REGISTRY[name]


def available_executors() -> list:
    _ensure_builtin_executors()
    return sorted(_REGISTRY)


class Reduction(NamedTuple):
    """What an executor hands back: the final prototype buffers and the
    device-resident level maps for the back-out."""

    protos: torch.Tensor          # (n_max, d) final-level prototypes (padded)
    mass: torch.Tensor            # (n_max,)
    valid: torch.Tensor           # (n_max,) bool
    n_prototypes: torch.Tensor    # () int32
    assignments: Sequence[torch.Tensor]
    n0: int                       # original unit count
    info: Optional[Mapping[str, Any]] = None  # per-level counts


class FitResult:
    """Fitted artifact: ``protos`` / ``proto_mass`` / ``proto_valid`` — the
    final prototype buffer; ``proto_labels`` — backend labels (-1 for
    padding); ``n_prototypes``; ``labels`` — (n,) int32 labels backed out
    to every unit; ``info`` — the level sizes, valid counts and MIS rounds
    per level; ``backend_result`` — what the backend returned when it was
    more than labels (k-means: centres, inertia, Lloyd iterations)."""

    def __init__(self, *, executor: str, protos, proto_mass, proto_valid,
                 proto_labels, n_prototypes, assignments=(), labels=None,
                 info: Optional[Mapping[str, Any]] = None,
                 backend_result: Any = None):
        self.executor = executor
        self.protos = protos
        self.proto_mass = proto_mass
        self.proto_valid = proto_valid
        self.proto_labels = proto_labels
        self.n_prototypes = n_prototypes
        self.assignments = assignments
        self.labels = labels
        self.info = dict(info or {})
        self.backend_result = backend_result

    def __repr__(self) -> str:
        return (f"FitResult(executor={self.executor!r}, "
                f"n_prototypes={int(self.n_prototypes)})")


@dataclasses.dataclass(frozen=True, eq=False)
class FitPlan:
    """Everything decided before any data moves."""

    t: int
    m: int
    backend: Union[str, BackendFn]
    executor: str
    key: torch.Tensor
    device: torch.device
    weighted: bool = False
    use_mass_in_backend: bool = True
    impl: str = "auto"
    knn_block: int = 0
    block_q: int = 256
    block_k: int = 512
    n_blocks: int = 8
    min_points: int = 4
    weights: Optional[torch.Tensor] = None
    driver: str = "fit"
    backend_kwargs: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def schedule(self, n0: int) -> List[int]:
        return level_sizes(n0, self.t, self.m)

    def split_keys(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(key_itis, key_backend) — the root split of the reference."""
        keys = prng.split(self.key)
        return keys[0], keys[1]


def _is_resident(data: Any) -> bool:
    return hasattr(data, "ndim") and hasattr(data, "shape")


def as_device_tensor(data: Any, device: torch.device) -> torch.Tensor:
    """Host numpy or a tensor anywhere → a tensor on ``device``."""
    if isinstance(data, torch.Tensor):
        return data.to(device)
    return torch.tensor(np.asarray(data), device=device)


def plan_fit(
    data: Any,
    t: int,
    m: int,
    backend: Union[str, BackendFn] = "kmeans",
    *,
    executor: Optional[str] = None,
    weights=None,
    weighted: bool = False,
    use_mass_in_backend: bool = True,
    key: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
    knn_block: Optional[int] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    n_blocks: Optional[int] = None,
    min_points: int = 4,
    device=None,
    driver: str = "fit",
    **backend_kwargs,
) -> FitPlan:
    """Resolve one :class:`FitPlan` from the call, the input and the active
    runtime config (explicit kwargs win)."""
    cfg = active()
    dev = resolve_device(device)
    if not _is_resident(data):
        raise ValueError(
            f"{driver}: only resident (n, d) arrays are supported by this "
            f"port so far; streaming fits are not ported yet")
    executor = "memory" if executor is None else executor
    resolve_executor(executor)  # unknown names fail here, loudly
    validate_reduction_params(t, m, n=data.shape[0], driver=driver)
    if weights is not None:
        weights = as_device_tensor(weights, dev).float()
    return FitPlan(
        t=int(t), m=int(m), backend=backend, executor=executor,
        key=prng.PRNGKey(0) if key is None else key, device=dev,
        weighted=weighted, use_mass_in_backend=use_mass_in_backend,
        impl=cfg.impl if impl is None else impl,
        knn_block=cfg.knn_block if knn_block is None else knn_block,
        block_q=cfg.block_q if block_q is None else block_q,
        block_k=cfg.block_k if block_k is None else block_k,
        n_blocks=cfg.n_blocks if n_blocks is None else n_blocks,
        min_points=min_points, weights=weights, driver=driver,
        backend_kwargs=dict(backend_kwargs),
    )


def _finalize_backend(plan: FitPlan, red: Reduction):
    """Label the final prototype buffer: registry resolution, mass
    weighting, -1 on invalid rows. Returns (labels, backend result)."""
    _, key_backend = plan.split_keys()
    w = red.mass if plan.use_mass_in_backend else None
    fn = resolve_backend(plan.backend)
    out = fn(red.protos, valid=red.valid, weights=w, key=key_backend,
             impl=plan.impl, **dict(plan.backend_kwargs))
    labels = getattr(out, "labels", out)
    result = out if labels is not out else None
    return torch.where(red.valid, labels, -1).to(torch.int32), result


def _plan_scope(plan: FitPlan):
    """Pin the plan's resolved tile knobs for its execution."""
    return configure(block_q=plan.block_q, block_k=plan.block_k)


def finalize_reduction(plan: FitPlan, red: Reduction) -> FitResult:
    """Backend finalize + label back-out + the canonical result."""
    with _plan_scope(plan):
        proto_labels, backend_result = _finalize_backend(plan, red)
    if red.assignments:
        labels = compose_assignments(red.assignments, proto_labels)
    else:  # m == 0 or early stop before level 0: the backend ran on x itself
        labels = proto_labels
    return FitResult(
        executor=plan.executor, protos=red.protos, proto_mass=red.mass,
        proto_valid=red.valid, proto_labels=proto_labels,
        n_prototypes=red.n_prototypes, assignments=red.assignments,
        labels=labels[: red.n0].to(torch.int32), info=red.info,
        backend_result=backend_result)


def execute_plan(plan: FitPlan, data: Any) -> FitResult:
    """Run the plan's executor on ``data`` (moved to the plan's device),
    then the shared epilogue."""
    x = as_device_tensor(data, plan.device)
    with _plan_scope(plan):
        red = resolve_executor(plan.executor)(plan, x)
    return finalize_reduction(plan, red)


def fit(data: Any, t: int, m: int, backend: Union[str, BackendFn] = "kmeans",
        **kwargs) -> FitResult:
    """The public entry point, ``repro_torch.fit``: IHTC on a resident
    (n, d) array (numpy or torch). Runs on ``device=`` (default: the
    runtime config's, "cuda"); raises if that device is missing. All
    :func:`plan_fit` keywords are accepted; unknown keywords go to the
    backend clusterer."""
    plan = plan_fit(data, t, m, backend, **kwargs)
    return execute_plan(plan, data)
