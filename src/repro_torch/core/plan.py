"""Fit planner and executors — the port of ``repro.core.plan``: the
resident-array ("memory"), chunk-stream ("streaming"), mesh ("sharded")
and composed ("streaming_sharded") executors.

  * :class:`FitPlan` — everything decided before data moves: validated
    reduction parameters, the key schedule, the backend, the dispatch
    knobs resolved from the active runtime config, the device, the mesh,
    and the executor (a resident array → ``memory``, any other iterable
    of host chunks → ``streaming``; a mesh, passed or configured, turns
    them into ``sharded`` and ``streaming_sharded``).
  * the executor registry — an executor owns its data-movement strategy
    and returns a :class:`Reduction`.
  * the epilogue — backend finalize and label back-out, once, here.
  * :class:`FitResult` — the fitted artifact ``ClusterIndex.build`` takes;
    a streamed fit backs its labels out chunk by chunk from a host
    :class:`LabelSpill`.

With the tuning policy on (``RuntimeConfig.tune``), ``plan_fit`` freezes
the measured winners of the ``stream``, ``knn``, ``knn_block`` and
``assign`` cells into the plan, as the reference does; explicit kwargs
still win (on the sharded executors only the ``knn`` cell: their kNN is
a ring pass, not a blocked scan).

Under a mesh every rank runs the same plan on its own rows
(:mod:`repro_torch.core.distributed`); the epilogue keeps ``kmeans`` on
the mesh and runs any other backend on the replicated final prototypes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Mapping, NamedTuple, \
    Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import prng
from repro_torch.cluster.registry import BackendFn, resolve_backend
from repro_torch.core.itis import level_sizes, validate_reduction_params
from repro_torch.core.prototypes import compose_assignments
from repro_torch.kernels.ops import dtype_name
from repro_torch.runtime import active, configure, resolve_device

ExecutorFn = Callable[["FitPlan", Any], "Reduction"]

#: executors that consume a chunk iterator instead of a resident array
STREAMING_EXECUTORS = ("streaming", "streaming_sharded")

#: executors that place level buffers on a mesh: each rank holds its rows
SHARDED_EXECUTORS = ("sharded", "streaming_sharded")

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
    # importing the modules registers "memory", "streaming", "sharded" and
    # "streaming_sharded"
    from repro_torch.core import distributed, ihtc, streaming  # noqa: F401


def resolve_executor(name: str) -> ExecutorFn:
    _ensure_builtin_executors()
    if name not in _REGISTRY:
        raise ValueError(f"unknown executor {name!r}; have {available_executors()}")
    return _REGISTRY[name]


def available_executors() -> list:
    _ensure_builtin_executors()
    return sorted(_REGISTRY)


class LabelSpill:
    """Host-side back-out state a streaming executor spilled as it ran.

    One int32 map per chunk (chunk-local prototype id, -1 for masked rows)
    plus one map per cascade / compaction / finalize level, in epoch
    order; ``chunk_offset`` places each chunk's prototype slab in the
    reservoir and ``chunk_epoch`` says how many maps existed at its fold,
    so a chunk composes only through the maps recorded from then on. All
    host numpy — nothing O(n) stays on the device; the constructor
    refuses anything else, so a spill drain that left a device buffer
    behind fails here, not at back-out.
    """

    def __init__(self, *, chunk_n: int, chunk_assign: List[np.ndarray],
                 chunk_offset: List[int], chunk_epoch: List[int],
                 chunk_counts: List[int], maps: List[np.ndarray],
                 n_cascades: int, ingest_stats: Optional[dict] = None):
        for name, arrs in (("chunk_assign", chunk_assign), ("maps", maps)):
            for a in arrs:
                if not isinstance(a, np.ndarray):
                    raise TypeError(
                        f"LabelSpill.{name} must be host numpy; got "
                        f"{type(a).__name__} — a spill drain left a device "
                        f"buffer behind")
        self.chunk_n = chunk_n
        self.chunk_assign = chunk_assign
        self.chunk_offset = chunk_offset
        self.chunk_epoch = chunk_epoch
        self.chunk_counts = chunk_counts
        self.maps = maps
        self.n_cascades = n_cascades
        self.ingest_stats = ingest_stats

    @property
    def n_chunks(self) -> int:
        return len(self.chunk_assign)

    @property
    def n_total(self) -> int:
        return int(sum(self.chunk_counts))

    def labels_for(self, chunk_idx: int,
                   proto_labels_host: np.ndarray) -> np.ndarray:
        """Compose chunk ``chunk_idx``'s map through every level map from
        its epoch on, then through the backend labels (numpy)."""
        count = self.chunk_counts[chunk_idx]
        lab = self.chunk_assign[chunk_idx][:count].astype(np.int64)
        slot = np.where(lab >= 0, lab + self.chunk_offset[chunk_idx], -1)
        for mp in self.maps[self.chunk_epoch[chunk_idx]:]:
            slot = np.where(slot >= 0, mp[np.maximum(slot, 0)], -1)
        out = np.where(slot >= 0, proto_labels_host[np.maximum(slot, 0)], -1)
        return out.astype(np.int32)


class Reduction(NamedTuple):
    """What an executor hands back: the final prototype buffers and its
    back-out state (device-resident level maps, or a host spill)."""

    protos: torch.Tensor          # (n_max, d) final-level prototypes (padded)
    mass: torch.Tensor            # (n_max,)
    valid: torch.Tensor           # (n_max,) bool
    n_prototypes: torch.Tensor    # () int32
    assignments: Sequence[torch.Tensor]  # device level maps ([] for streaming)
    n0: int                       # original unit count
    info: Optional[Mapping[str, Any]] = None  # per-level counts
    spill: Optional[LabelSpill] = None


class _SpillLabels:
    """Lazy label view over a :class:`LabelSpill`: call it or
    ``np.asarray`` it to materialise (host numpy); at scale prefer
    :meth:`FitResult.iter_labels`."""

    def __init__(self, result: "FitResult"):
        self._result = result

    def __call__(self) -> np.ndarray:
        r = self._result
        if r.n_chunks == 0:
            return np.zeros((0,), np.int32)
        return np.concatenate(list(r.iter_labels()))

    def __array__(self, dtype=None, copy=None):
        out = self()
        return out if dtype is None else out.astype(dtype)

    def __repr__(self) -> str:
        return (f"<spilled labels of {self._result.n_total} units over "
                f"{self._result.n_chunks} chunks; call or np.asarray() to "
                f"materialize>")


class FitResult:
    """Fitted artifact: ``protos`` / ``proto_mass`` / ``proto_valid`` — the
    final prototype buffer; ``proto_labels`` — backend labels (-1 for
    padding); ``n_prototypes``; ``labels`` — (n,) int32 labels backed out
    to every unit on the device (memory executor), or a lazy host view
    over the :class:`LabelSpill` (streaming executor); ``info`` — the
    level sizes, valid counts and MIS rounds per level (the ingest
    statistics of a stream); ``backend_result`` — what the backend
    returned when it was more than labels (k-means: centres, inertia,
    Lloyd iterations)."""

    def __init__(self, *, executor: str, protos, proto_mass, proto_valid,
                 proto_labels, n_prototypes, assignments=(), labels=None,
                 spill: Optional[LabelSpill] = None,
                 info: Optional[Mapping[str, Any]] = None,
                 backend_result: Any = None):
        if (labels is None) == (spill is None):
            raise ValueError("FitResult needs exactly one of labels= "
                             "(in-memory back-out) or spill= (streaming)")
        self.executor = executor
        self.protos = protos
        self.proto_mass = proto_mass
        self.proto_valid = proto_valid
        self.proto_labels = proto_labels
        self.n_prototypes = n_prototypes
        self.assignments = assignments
        self.spill = spill
        self._labels = labels
        self._proto_labels_host: Optional[np.ndarray] = None
        self.info = dict(info or {})
        self.backend_result = backend_result

    @property
    def labels(self):
        """(n,) int32 device labels, or the lazy host view of a stream."""
        if self._labels is not None:
            return self._labels
        return _SpillLabels(self)

    def _proto_labels_np(self) -> np.ndarray:
        if self._proto_labels_host is None:
            # the fit is complete: the small label table comes to the host once
            # repro_torch: allow[HS201]: the fit is done; the small label table comes to the host once
            self._proto_labels_host = self.proto_labels.cpu().numpy()
        return self._proto_labels_host

    def labels_for(self, chunk_idx: int) -> np.ndarray:
        """Final labels of chunk ``chunk_idx``'s valid rows (host numpy);
        an in-memory fit is one chunk, index 0."""
        if self.spill is not None:
            return self.spill.labels_for(chunk_idx, self._proto_labels_np())
        if chunk_idx != 0:
            raise IndexError(
                f"in-memory fit has a single chunk; got index {chunk_idx}")
        # repro_torch: allow[HS201]: labels_for returns host numpy by contract, after the fit
        return self._labels.cpu().numpy()

    def iter_labels(self) -> Iterator[np.ndarray]:
        """Final labels, one array per input chunk, in stream order."""
        for c in range(self.n_chunks):
            yield self.labels_for(c)

    @property
    def n_chunks(self) -> int:
        return self.spill.n_chunks if self.spill is not None else 1

    @property
    def n_total(self) -> int:
        if self.spill is not None:
            return self.spill.n_total
        return int(self._labels.shape[0])

    @property
    def n_cascades(self) -> int:
        return self.spill.n_cascades if self.spill is not None else 0

    @property
    def chunk_n(self) -> Optional[int]:
        return self.spill.chunk_n if self.spill is not None else None

    def to_index(self, *, pack: bool = True):
        """Freeze into a servable :class:`repro_torch.core.index.ClusterIndex`
        (packed: with the bf16/int8 prototype buffers)."""
        from repro_torch.core.index import ClusterIndex  # no import cycle

        return ClusterIndex.build(self, pack=pack)

    def __repr__(self) -> str:
        return (f"FitResult(executor={self.executor!r}, "
                f"n_prototypes={int(self.n_prototypes)}, "
                f"n_chunks={self.n_chunks})")


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
    #: the TC kNN kernel's route on the card (the ``knn`` cell's frozen
    #: winner, the counterpart of the reference's tuned tiles); None = the
    #: shape rule
    knn_route: Optional[str] = None
    n_blocks: int = 8
    chunk_n: int = 0
    reservoir_n: int = 0
    prefetch_depth: int = 0
    min_points: int = 4
    weights: Optional[Any] = None
    #: (n,) row mask of a pre-padded resident input (the sharded executor)
    valid: Optional[Any] = None
    #: the ``DeviceMesh`` of the sharded executors (None elsewhere)
    mesh: Any = None
    axis_name: str = "data"
    driver: str = "fit"
    backend_kwargs: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def schedule(self, n0: int) -> List[int]:
        return level_sizes(n0, self.t, self.m)

    def reduction_floor(self) -> int:
        """Fewer valid points than this and a level must not run (the
        shared early-stop rule)."""
        return max(self.min_points, 2 * self.t)

    def shard_count(self) -> int:
        """Ranks along the mesh's ``axis_name`` (1 without a mesh)."""
        from repro_torch.core._collectives import Axis

        return 1 if self.mesh is None else Axis(self.mesh, self.axis_name).size

    def shard_multiple(self) -> int:
        """Level-buffer padding multiple of the mesh executors: the smallest
        multiple of the shard count covering the canonical reduction width,
        so every level splits evenly and the block fold keeps the
        single-device bits (the reference's DESIGN.md §4.3)."""
        p = self.shard_count()
        return -(-max(self.n_blocks, p) // p) * p

    def split_keys(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(key_itis, key_backend) — the root split of the reference."""
        keys = prng.split(self.key)
        return keys[0], keys[1]


def _is_chunk_stream(data: Any) -> bool:
    """Resident 2-D array → in-memory family; any other iterable → chunks."""
    return not (hasattr(data, "ndim") and hasattr(data, "shape"))


def as_device_tensor(data: Any, device: torch.device) -> torch.Tensor:
    """Host numpy or a tensor anywhere → a tensor on ``device``."""
    if isinstance(data, torch.Tensor):
        return data.to(device)
    # repro_torch: allow[HS201]: host numpy in, on its way to the card
    return torch.tensor(np.asarray(data), device=device)


def plan_fit(
    data: Any,
    t: int,
    m: int,
    backend: Union[str, BackendFn] = "kmeans",
    *,
    executor: Optional[str] = None,
    weights=None,
    valid=None,
    weighted: bool = False,
    use_mass_in_backend: bool = True,
    key: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
    knn_block: Optional[int] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    knn_route: Optional[str] = None,
    n_blocks: Optional[int] = None,
    chunk_n: Optional[int] = None,
    reservoir_n: Optional[int] = None,
    prefetch_depth: Optional[int] = None,
    mesh=None,
    axis_name: Optional[str] = None,
    min_points: int = 4,
    device=None,
    driver: str = "fit",
    **backend_kwargs,
) -> FitPlan:
    """Resolve one :class:`FitPlan` from the call, the input and the active
    runtime config (explicit kwargs win). A chunk iterator streams, a
    resident array stays in memory, and a mesh (passed or configured) turns
    either into its sharded flavour, unless ``executor=`` or the config's
    executor names one (a sharded executor without a mesh makes one with
    ``make_data_mesh()``); inputs the chosen executor cannot honour are
    refused loudly (``weights`` on a stream, ``valid`` off the sharded
    executor, ``knn_block`` on a sharded one, ``prefetch_depth`` on an
    in-memory one)."""
    cfg = active()
    dev = resolve_device(device)
    explicit_prefetch = prefetch_depth is not None
    explicit_knn_block = knn_block is not None
    auto_block_q, auto_block_k = block_q is None, block_k is None
    impl = cfg.impl if impl is None else impl
    knn_block = cfg.knn_block if knn_block is None else knn_block
    block_q = cfg.block_q if block_q is None else block_q
    block_k = cfg.block_k if block_k is None else block_k
    chunk_n = cfg.chunk_n if chunk_n is None else chunk_n
    reservoir_n = cfg.reservoir_n if reservoir_n is None else reservoir_n
    prefetch_depth = (cfg.prefetch_depth if prefetch_depth is None
                      else prefetch_depth)
    mesh = cfg.mesh if mesh is None else mesh
    axis_name = cfg.axis_name if axis_name is None else axis_name
    streaming_input = _is_chunk_stream(data)
    if executor is None and cfg.executor != "auto":
        executor = cfg.executor
    if executor is None:
        if streaming_input:
            executor = "streaming_sharded" if mesh is not None else "streaming"
        else:
            executor = "sharded" if mesh is not None else "memory"
    resolve_executor(executor)  # unknown names fail here, loudly
    if streaming_input and executor not in STREAMING_EXECUTORS:
        raise ValueError(
            f"{driver}: executor {executor!r} needs a resident (n, d) array "
            f"but got a chunk stream; use a streaming executor or pass the "
            f"materialized array")
    if not streaming_input and executor in STREAMING_EXECUTORS:
        raise ValueError(
            f"{driver}: executor {executor!r} consumes an iterable of host "
            f"chunks; wrap a resident array as iter([x]) to stream it")
    if executor in SHARDED_EXECUTORS:
        if mesh is None:
            from repro_torch.core.distributed import make_data_mesh  # no cycle

            mesh = make_data_mesh()
        if explicit_knn_block and knn_block:
            raise ValueError(
                f"{driver}: knn_block={knn_block} cannot apply to the "
                f"{executor!r} executor — the sharded kNN is a ring pass over "
                f"the mesh's ranks (repro_torch.core.knn.ring_knn), not a "
                f"blocked scan; drop the kwarg (a configured runtime "
                f"knn_block is ignored on sharded executors) or run a "
                f"single-device executor")
    else:
        mesh = None  # a configured mesh means nothing to a one-device executor
    if weights is not None and executor in STREAMING_EXECUTORS:
        raise ValueError(
            f"{driver}: weights= cannot apply to the {executor!r} executor "
            f"— per-unit weights need the resident array; chunk streams "
            f"carry unit mass")
    if valid is not None and executor != "sharded":
        raise ValueError(
            f"{driver}: valid= marks pre-padded rows of a resident mesh "
            f"array and only the 'sharded' executor honours it (got "
            f"{executor!r}); slice the array instead, or mask stream "
            f"chunks with (chunk, n_valid) pairs")
    if prefetch_depth < 0:
        raise ValueError(
            f"{driver}: prefetch_depth must be >= 0, got {prefetch_depth}")
    if (executor not in STREAMING_EXECUTORS and explicit_prefetch
            and prefetch_depth):
        raise ValueError(
            f"{driver}: prefetch_depth={prefetch_depth} cannot apply to the "
            f"{executor!r} executor — only the streaming executor stages "
            f"chunks (a configured runtime prefetch_depth is ignored "
            f"elsewhere)")
    # tuned dispatch: with the policy on, the auto knobs resolve through
    # the measured winners of this device kind and shape bucket and are
    # FROZEN into the plan, so dispatch stays fixed for the plan's life
    # even if the cache changes mid-fit
    if cfg.tune != "off":
        from repro_torch import tune  # no import cycle through core

        if streaming_input:
            if chunk_n == 0 or (prefetch_depth == 0 and not explicit_prefetch):
                ts = tune.tuned_params("stream", device=dev)
                if chunk_n == 0:
                    if ts.get("chunk_n"):
                        chunk_n = int(ts["chunk_n"])
                    if reservoir_n == 0 and ts.get("reservoir_n"):
                        reservoir_n = int(ts["reservoir_n"])
                # depth 0 is the serial default, not a measured choice
                if (prefetch_depth == 0 and not explicit_prefetch
                        and ts.get("prefetch_depth") is not None):
                    prefetch_depth = int(ts["prefetch_depth"])
        else:
            n0, d0 = int(data.shape[0]), int(data.shape[1])
            dt = dtype_name(data.dtype)
            tk = tune.tuned_params("knn", dtype=dt, device=dev, n=n0, d=d0,
                                   k=max(t - 1, 1))
            if auto_block_q and tk.get("block_q"):
                block_q = int(tk["block_q"])
            if auto_block_k and tk.get("block_k"):
                block_k = int(tk["block_k"])
            if knn_route is None and tk.get("route"):
                knn_route = str(tk["route"])
            if (knn_block == 0 and not explicit_knn_block
                    and executor not in SHARDED_EXECUTORS):
                tb = tune.tuned_params("knn_block", dtype=dt, device=dev,
                                       n=n0, d=d0, k=max(t - 1, 1))
                if tb.get("knn_block"):
                    knn_block = int(tb["knn_block"])
            # a fused winner of the "assign" cell freezes the fused
            # streaming path (the TC's kNN runs it); a quantized one
            # freezes as plain "fused": a fit has no low-precision buffers
            if impl == "auto" and executor not in SHARDED_EXECUTORS:
                ta = tune.tuned_params("assign", dtype=dt, device=dev, nq=n0,
                                       p=n0, d=d0, k=max(t - 1, 1))
                if str(ta.get("impl", "")).startswith("fused"):
                    impl = "fused"

    if streaming_input:
        validate_reduction_params(t, m, min_m=1, driver=driver)
        if chunk_n:
            validate_reduction_params(t, m, n=chunk_n, min_m=1, driver=driver)
    else:
        validate_reduction_params(t, m, n=data.shape[0], driver=driver)
    if weights is not None and executor not in SHARDED_EXECUTORS:
        weights = as_device_tensor(weights, dev).float()
    return FitPlan(
        t=int(t), m=int(m), backend=backend, executor=executor,
        key=prng.PRNGKey(0) if key is None else key, device=dev,
        weighted=weighted, use_mass_in_backend=use_mass_in_backend,
        impl=impl, knn_block=knn_block, block_q=block_q, block_k=block_k,
        knn_route=knn_route,
        n_blocks=cfg.n_blocks if n_blocks is None else n_blocks,
        chunk_n=int(chunk_n), reservoir_n=int(reservoir_n),
        prefetch_depth=int(prefetch_depth),
        min_points=min_points, weights=weights, valid=valid, mesh=mesh,
        axis_name=axis_name, driver=driver,
        backend_kwargs=dict(backend_kwargs),
    )


def _finalize_backend(plan: FitPlan, red: Reduction):
    """Label the final prototype buffer: registry resolution, mass
    weighting, -1 on invalid rows. Returns (labels, backend result)."""
    _, key_backend = plan.split_keys()
    w = red.mass if plan.use_mass_in_backend else None
    kwargs = dict(plan.backend_kwargs)
    if plan.executor in SHARDED_EXECUTORS and plan.backend == "kmeans":
        # k-means stays on the mesh; the final prototypes are replicated on
        # every rank, which computes on its block of them
        from repro_torch.core.distributed import kmeans_sharded  # no cycle

        out = kmeans_sharded(
            red.protos, kwargs.get("k", 3), valid=red.valid, weights=w,
            key=key_backend, mesh=plan.mesh, axis_name=plan.axis_name,
            iters=kwargs.get("iters", 100), impl=plan.impl,
            n_blocks=plan.shard_multiple())
    else:
        # any other backend (and every one-device executor): the replicated
        # final prototypes, as they are
        fn = resolve_backend(plan.backend)
        out = fn(red.protos, valid=red.valid, weights=w, key=key_backend,
                 impl=plan.impl, **kwargs)
    labels = getattr(out, "labels", out)
    result = out if labels is not out else None
    return torch.where(red.valid, labels, -1).to(torch.int32), result


def _plan_scope(plan: FitPlan):
    """Pin the plan's resolved tile knobs for its execution, and clamp the
    tune policy to a non-measuring one (``onthefly`` → ``cached``): the
    planner may measure, the execution never does. Nesting it re-applies
    the same overrides."""
    exec_tune = "off" if active().tune == "off" else "cached"
    return configure(block_q=plan.block_q, block_k=plan.block_k, tune=exec_tune)


def finalize_reduction(plan: FitPlan, red: Reduction) -> FitResult:
    """Backend finalize + label back-out + the canonical result."""
    with _plan_scope(plan):
        proto_labels, backend_result = _finalize_backend(plan, red)
    if red.spill is not None:
        return FitResult(
            executor=plan.executor, protos=red.protos, proto_mass=red.mass,
            proto_valid=red.valid, proto_labels=proto_labels,
            n_prototypes=red.n_prototypes, spill=red.spill, info=red.info,
            backend_result=backend_result)
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
    """Run the plan's executor on ``data`` (a resident array moved to the
    plan's device; the host chunk stream, or a mesh executor's input, as
    it is: a sharded executor moves only this rank's rows), then the shared
    epilogue."""
    if plan.executor not in STREAMING_EXECUTORS + SHARDED_EXECUTORS:
        data = as_device_tensor(data, plan.device)
    with _plan_scope(plan):
        red = resolve_executor(plan.executor)(plan, data)
    return finalize_reduction(plan, red)


def fit(data: Any, t: int, m: int, backend: Union[str, BackendFn] = "kmeans",
        **kwargs) -> FitResult:
    """The public entry point, ``repro_torch.fit``: IHTC on a resident
    (n, d) array (numpy or torch), or on any iterable of host chunks (bare
    (c, d) arrays or ``(chunk, n_valid)`` pairs) through the streaming
    executor in O(chunk + reservoir) device memory. Runs on ``device=``
    (default: the runtime config's, "cuda"); raises if that device is
    missing. All :func:`plan_fit` keywords are accepted; unknown keywords
    go to the backend clusterer."""
    plan = plan_fit(data, t, m, backend, **kwargs)
    return execute_plan(plan, data)
