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
from typing import Any, Iterator, Mapping, Optional

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
