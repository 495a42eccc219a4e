"""Process-wide runtime configuration for kernel dispatch and placement.

The PyTorch counterpart of ``repro.runtime.config``, slimmed to the knobs
the fit → serve main path reads. Three layers, last one wins:

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
#: "fused": the streaming top-k on nearest/kNN (ops without a fused path
#: treat it as "auto").
IMPLS = ("auto", "ref", "cuda", "fused")


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
    """

    impl: str = "auto"
    knn_block: int = 0
    block_q: int = 256
    block_k: int = 512
    n_blocks: int = 8
    precision: str = "float32"
    device: str = "cuda"

    def __post_init__(self) -> None:
        if self.impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {self.impl!r}")
        if self.knn_block < 0:
            raise ValueError(f"knn_block must be >= 0, got {self.knn_block}")
        for name in ("block_q", "block_k", "n_blocks"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got {getattr(self, name)}")
        if self.precision not in ("float32", "bfloat16"):
            raise ValueError(f"precision must be 'float32' or 'bfloat16', "
                             f"got {self.precision!r}")
        torch.device(self.device)  # unknown device strings fail here

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
