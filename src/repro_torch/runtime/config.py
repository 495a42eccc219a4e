"""Process-wide runtime configuration for kernel dispatch and placement.

The PyTorch counterpart of ``repro.runtime.config``, slimmed to the knobs
the port's paths read (fit, stream, serve, refresh). Three layers, last one wins:

  1. the built-in defaults of :class:`RuntimeConfig`;
  2. ``REPRO_TORCH_*`` environment variables, read once at import (this is
     the only module of the package that reads the environment);
  3. ``with configure(impl="ref"): ...`` — a thread-local override stack.

Explicit keyword arguments at a call site always win over all three.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Any, Dict, Iterator, Mapping, Optional

import torch

#: kernel dispatch policies. "auto": the hand-written CUDA kernels for CUDA
#: tensors ("fused" on the nearest/kNN ops, "cuda" elsewhere), the plain
#: PyTorch versions for CPU tensors. "ref": the plain versions everywhere.
#: "cuda": the kernel wrapper of each op (dense composition on nearest).
#: "fused": the streaming top-k on nearest/kNN. "fused_bf16" / "fused_int8":
#: the serve-side shortlist over an index's frozen bf16 / int8 prototype
#: buffer, rescored in exact f32. Ops without a fused path treat the fused
#: family as "auto".
IMPLS = ("auto", "ref", "cuda", "fused", "fused_bf16", "fused_int8")

#: tuning policies (:mod:`repro_torch.tune`)
TUNE_MODES = ("off", "cached", "onthefly")

#: "auto" and the fit executors of :mod:`repro_torch.core.plan` (which keeps
#: the registry; this tuple only gates the field, so a typo fails at import)
EXECUTORS = ("auto", "memory", "streaming", "sharded", "streaming_sharded")

#: the variables a ``torchrun`` launch sets in every rank
#: (:func:`torchrun_env`; ``repro_torch.core.distributed.make_data_mesh``
#: initializes the process group from them)
TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")

#: env var naming the tuning cache file (``python -m repro_torch.tune
#: --cache`` wins over it)
TUNE_CACHE_ENV = "REPRO_TORCH_TUNE_CACHE"


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Immutable snapshot of every dispatch knob.

    Fields:
      impl: kernel dispatch policy, one of :data:`IMPLS`.
      knn_block: query/key block of the blocked kNN driver; 0 = auto
        (one-shot up to ``repro_torch.core.knn.AUTO_KNN_BLOCK`` rows,
        blocks of that size above).
      block_q / block_k: query/key tiles of the plain streaming top-k fold
        (the CUDA kernels fix their tiles at compile time).
      n_blocks: width of the fixed left-fold reduction tree of every
        segment sum (the bit-reproducibility contract).
      precision: "float32" | "bfloat16" — the serve path's query/prototype
        cast before distances (which always fold in f32).
      device: where entry points put host data; "cuda" unless the caller
        asks for the CPU. A missing GPU raises, never falls back.
      chunk_n: static rows of each chunk buffer of the streaming fit; 0 =
        the first chunk's row count.
      reservoir_n: prototype reservoir capacity of the streaming fit; 0 =
        auto (four chunks' prototype budget, raised to the feasibility
        bound of ``repro_torch.core.streaming``).
      mesh: the default 1-D ``("data",)`` device mesh
        (``repro_torch.core.distributed.make_data_mesh``) of ``fit`` and
        ``ClusterIndex.assign``; None = one device unless a mesh is passed.
        A mesh turns the memory executor into "sharded" and the streaming
        one into "streaming_sharded".
      axis_name: the mesh dimension the rows are sharded over.
      prefetch_depth: chunks the streaming fit stages ahead of the device
        on a background thread (0 = the serial loop); every depth gives
        the same bits. The reference's ``donate_stream`` has no field
        here: the port's folds, cascades and compactions always write the
        reservoir in place, so there is nothing to switch.
      serve_queue_depth / serve_max_inflight / serve_max_wait_ms /
        serve_default_tenant: the async serve front-end's admission bound
        (points), concurrently dispatched batches, flush deadline (ms)
        and the tenant of a request that names none.
      refresh_max_points / refresh_max_cascades / refresh_drift_ratio:
        the online refresh triggers (points folded, cascades survived,
        drift proxy above 1 + ratio since the last install); 0 disables
        a trigger.
    """

    impl: str = "auto"
    knn_block: int = 0
    block_q: int = 256
    block_k: int = 512
    n_blocks: int = 8
    precision: str = "float32"
    device: str = "cuda"
    chunk_n: int = 0
    reservoir_n: int = 0
    prefetch_depth: int = 0
    mesh: Any = None
    axis_name: str = "data"
    executor: str = "auto"
    tune: str = "off"
    serve_queue_depth: int = 8192
    serve_max_inflight: int = 4
    serve_max_wait_ms: float = 5.0
    serve_default_tenant: str = "default"
    refresh_max_points: int = 0
    refresh_max_cascades: int = 0
    refresh_drift_ratio: float = 0.0

    def __post_init__(self) -> None:
        if self.impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {self.impl!r}")
        for name in ("knn_block", "chunk_n", "reservoir_n", "prefetch_depth"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0, got {getattr(self, name)}")
        for name in ("block_q", "block_k", "n_blocks"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got {getattr(self, name)}")
        if self.precision not in ("float32", "bfloat16"):
            raise ValueError(f"precision must be 'float32' or 'bfloat16', "
                             f"got {self.precision!r}")
        torch.device(self.device)  # unknown device strings fail here
        if not self.axis_name:
            raise ValueError("axis_name must be non-empty")
        if self.executor not in EXECUTORS:
            raise ValueError(
                f"executor must be one of {EXECUTORS}, got {self.executor!r}")
        if self.tune not in TUNE_MODES:
            raise ValueError(
                f"tune must be one of {TUNE_MODES}, got {self.tune!r}")
        for name in ("serve_queue_depth", "serve_max_inflight"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got {getattr(self, name)}")
        if self.serve_max_wait_ms < 0:
            raise ValueError(f"serve_max_wait_ms must be >= 0, "
                             f"got {self.serve_max_wait_ms}")
        if not self.serve_default_tenant:
            raise ValueError("serve_default_tenant must be non-empty")
        for name in ("refresh_max_points", "refresh_max_cascades",
                     "refresh_drift_ratio"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0 (0 disables the "
                                 f"trigger), got {getattr(self, name)}")

    def replace(self, **overrides: Any) -> "RuntimeConfig":
        return dataclasses.replace(self, **overrides)

    def dispatch_key(self) -> tuple:
        """Hashable fingerprint of every behaviour-determining field, in the
        reference's order: ``device``, ``precision``,
        ``serve_default_tenant``, ``mesh`` and ``axis_name`` are left out
        (resolved per call, as the reference leaves out ``mesh``,
        ``axis_name`` and ``precision``).
        With tuning on it carries ``(tune, cache_epoch())``, so a
        populate, prune or cache swap changes the key; with tuning off it
        carries ``"off"`` and cache churn costs nothing."""
        if self.tune == "off":
            tune_state: object = "off"
        else:
            from repro_torch.tune.cache import cache_epoch  # stdlib-only

            tune_state = (self.tune, cache_epoch())
        return (self.impl, self.knn_block, self.block_q, self.block_k,
                self.n_blocks, self.chunk_n, self.reservoir_n,
                self.prefetch_depth, self.executor, tune_state,
                self.serve_queue_depth, self.serve_max_inflight,
                self.serve_max_wait_ms, self.refresh_max_points,
                self.refresh_max_cascades, self.refresh_drift_ratio)


_ENV_FIELDS = {
    "REPRO_TORCH_IMPL": ("impl", str),
    "REPRO_TORCH_KNN_BLOCK": ("knn_block", int),
    "REPRO_TORCH_BLOCK_Q": ("block_q", int),
    "REPRO_TORCH_BLOCK_K": ("block_k", int),
    "REPRO_TORCH_N_BLOCKS": ("n_blocks", int),
    "REPRO_TORCH_PRECISION": ("precision", str),
    "REPRO_TORCH_DEVICE": ("device", str),
    "REPRO_TORCH_CHUNK_N": ("chunk_n", int),
    "REPRO_TORCH_RESERVOIR_N": ("reservoir_n", int),
    "REPRO_TORCH_PREFETCH_DEPTH": ("prefetch_depth", int),
    "REPRO_TORCH_EXECUTOR": ("executor", str),
    "REPRO_TORCH_TUNE": ("tune", str),
    "REPRO_TORCH_SERVE_QUEUE_DEPTH": ("serve_queue_depth", int),
    "REPRO_TORCH_SERVE_MAX_INFLIGHT": ("serve_max_inflight", int),
    "REPRO_TORCH_SERVE_MAX_WAIT_MS": ("serve_max_wait_ms", float),
    "REPRO_TORCH_SERVE_DEFAULT_TENANT": ("serve_default_tenant", str),
    "REPRO_TORCH_REFRESH_MAX_POINTS": ("refresh_max_points", int),
    "REPRO_TORCH_REFRESH_MAX_CASCADES": ("refresh_max_cascades", int),
    "REPRO_TORCH_REFRESH_DRIFT_RATIO": ("refresh_drift_ratio", float),
}


def config_from_env(env: Optional[Mapping[str, str]] = None) -> RuntimeConfig:
    """Built-in defaults overridden by any ``REPRO_TORCH_*`` variables."""
    env = os.environ if env is None else env
    overrides = {}
    for var, (field, parse) in _ENV_FIELDS.items():
        if env.get(var, "") != "":
            overrides[field] = parse(env[var])
    return RuntimeConfig(**overrides)


_default = config_from_env()


class _Stack(threading.local):
    def __init__(self) -> None:
        self.frames: list = []


_stack = _Stack()


def active() -> RuntimeConfig:
    """The config governing dispatch right now (innermost override wins)."""
    return _stack.frames[-1] if _stack.frames else _default


def dispatch_key() -> tuple:
    """``active().dispatch_key()``."""
    return active().dispatch_key()


def default_config() -> RuntimeConfig:
    """The process-global default (env-seeded; ignores ``configure`` scopes)."""
    return _default


def set_default(config: RuntimeConfig) -> RuntimeConfig:
    """Replace the process-global default; returns the previous one."""
    global _default
    if not isinstance(config, RuntimeConfig):
        raise TypeError(f"expected RuntimeConfig, got {type(config).__name__}")
    prev, _default = _default, config
    return prev


def update_default(**overrides: Any) -> RuntimeConfig:
    """Update fields of the process-global default (returns the new one)."""
    global _default
    _default = _default.replace(**overrides)
    return _default


def torchrun_env() -> Dict[str, str]:
    """The launch variables of :data:`TORCHRUN_VARS` that are set (read at
    each call; empty outside a ``torchrun`` launch)."""
    return {v: os.environ[v] for v in TORCHRUN_VARS if os.environ.get(v, "")}


def tune_cache_path() -> str:
    """Where the tuning cache lives, read at each call: ``$REPRO_TORCH_TUNE_CACHE``,
    else ``$XDG_CACHE_HOME`` (or ``~/.cache``) ``/repro_torch/tune_cache.json``
    — the port's own file, apart from the reference's."""
    env = os.environ.get(TUNE_CACHE_ENV, "")
    if env:
        return env
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(base, "repro_torch", "tune_cache.json")


@contextlib.contextmanager
def configure(**overrides: Any) -> Iterator[RuntimeConfig]:
    """Scoped override: ``with configure(impl="ref"): ...`` (nests, and
    unwinds on exceptions; thread-local)."""
    cfg = active().replace(**overrides)
    _stack.frames.append(cfg)
    try:
        yield cfg
    finally:
        _stack.frames.pop()


def resolve_device(device: Any = None) -> torch.device:
    """``device`` (or the configured default) as a ``torch.device``.

    Raises when a CUDA device is asked for and none is present: the port
    never drops to the CPU unless the caller asked for it.
    """
    dev = torch.device(active().device if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            f"pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev
