"""Build and bind the hand-written CUDA kernels (``src/repro_torch/csrc``).

Each ``.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). Libraries go to ``build/repro_torch/``
at the root of the checkout, named by a hash of the source and the flags,
and are built at first use: all libraries at once, one ``nvcc`` process
each (``topk.cu`` is built three times, once per key type). Nothing here
runs at import time, so the CPU tests can import every module of the
package on a machine with no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

#: library name -> (source file under csrc/, extra nvcc flags); the three
#: top-k libraries are one source built once per key type
SOURCES = {
    "topk": ("topk.cu", ("-DREPRO_TOPK_KEYS=0",)),
    "topk_bf16": ("topk.cu", ("-DREPRO_TOPK_KEYS=1",)),
    "topk_int8": ("topk.cu", ("-DREPRO_TOPK_KEYS=2",)),
    "segment_sum": ("segment_sum.cu", ()),
    "pairwise_l2": ("pairwise_l2.cu", ()),
    "flash_attention": ("flash_attention.cu", ()),
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

#: C signatures (every function returns a cudaError_t as int)
_SIGNATURES = {
    "topk": ("repro_topk_f32", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P]),
    "topk_bf16": ("repro_topk_bf16",
                  [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P]),
    "topk_int8": ("repro_topk_int8",
                  [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P]),
    "segment_sum": ("repro_segment_sum_f32",
                    [_P, _P, _P, _I, _P, _P, _L, _I, _I, _L, _I, _I, _P, _P]),
    "pairwise_l2": ("repro_pairwise_sq_l2_f32", [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "flash_attention": ("repro_flash_attention",
                        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         _F, _F, _P, _P]),
}

#: the libraries' other C functions: name -> (argument types, result type)
_TOPK_HELPERS = {"repro_topk_scratch_bytes": ([_I, _I, _I, _I, _I], _L),
                 "repro_topk_route": ([_I, _I], _I),
                 "repro_topk_route_ok": ([_I, _I, _I], _I),
                 "repro_topk_split_count": ([_I, _I], _I)}
_HELPERS = {
    "topk": _TOPK_HELPERS, "topk_bf16": _TOPK_HELPERS, "topk_int8": _TOPK_HELPERS,
    "segment_sum": {"repro_segment_sum_scratch_bytes": ([_L, _I, _I, _I, _I], _L)},
    "pairwise_l2": {"repro_pairwise_sq_l2_route": ([_I, _I], _I)},
    "flash_attention": {
        "repro_flash_attention_route": ([_I, _I, _I, _I, _I], _I),
        "repro_flash_attention_split_keys": ([_I], _I),
        "repro_flash_attention_scratch_bytes": ([_I, _I, _I, _I, _I, _I], _L),
        "repro_flash_attention_lse": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                       _I, _I, _I, _F, _F, _P, _P], _I)},
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """``nvcc`` on the PATH, else under the toolkit PyTorch itself found."""
    from torch.utils.cpp_extension import CUDA_HOME  # finds the toolkit; builds nothing

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built from source at first use and need the CUDA "
                       "toolkit")


def library_path(name: str) -> Path:
    source, defines = SOURCES[name]
    src = (CSRC / source).read_bytes()
    flags = " ".join(NVCC_FLAGS + defines)
    tag = hashlib.sha256(src + flags.encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build_all() -> float:
    """Compile every missing library, all sources in parallel. Returns the
    wall seconds spent (0.0 when everything was built already)."""
    with _lock:
        todo = {n: library_path(n) for n in SOURCES}
        todo = {n: p for n, p in todo.items() if not p.exists()}
        if not todo:
            return 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        exe = nvcc()
        t0 = time.perf_counter()
        procs = {}
        for name, out in todo.items():
            tmp = out.parent / f"{out.name}.{os.getpid()}.tmp"
            source, defines = SOURCES[name]
            cmd = [exe, *NVCC_FLAGS, *defines, "-o", str(tmp), str(CSRC / source)]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            out.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{SOURCES[name][0]} {' '.join(SOURCES[name][1])} "
                              f"(exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    path = library_path(name)
    if not path.exists():
        build_all()
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(path))
            fn_name, argtypes = _SIGNATURES[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            for helper, (args, res) in _HELPERS.get(name, {}).items():
                getattr(lib, helper).argtypes = args
                getattr(lib, helper).restype = res
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return _libs[name]


def call(name: str, *args, entry: Optional[str] = None) -> None:
    """Launch through library ``name``'s C entry point (``entry``: another
    of its launching functions, one of its helpers); raise on a nonzero
    ``cudaGetLastError()``."""
    lib = library(name)
    fn = entry or _SIGNATURES[name][0]
    err = getattr(lib, fn)(*args)
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {fn} failed: error {err} ({msg})")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def on_card(t: torch.Tensor) -> bool:
    """Whether a wrapper takes its kernel's route for ``t`` (a CUDA tensor)
    rather than the plain version (a CPU tensor)."""
    return t.is_cuda


def forbid_grad(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise when a kernel is handed a tensor that requires grad while grad
    mode is on: the kernels have no backward pass, so their output would
    carry no gradient and training would silently lose it."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward pass and was handed a "
            f"tensor that requires grad; train with impl=\"ref\" (the plain "
            f"route under autograd), or call it under torch.no_grad()")


def require_cuda(name: str, *tensors: Optional[torch.Tensor]) -> torch.device:
    """Check that every given tensor lies on one CUDA device; return it."""
    dev = None
    for t in tensors:
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{name}: the CUDA kernel got a tensor on "
                             f"{t.device}")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
    if dev is None:
        raise ValueError(f"{name}: no tensor given")
    return dev


def f32(t: torch.Tensor) -> torch.Tensor:
    """A float tensor as contiguous f32 (the kernels fold in f32, as the
    Pallas kernels cast every input tile); anything else is refused."""
    if not t.is_floating_point():
        raise TypeError(f"the CUDA kernels take float tensors, got {t.dtype}")
    return t.to(torch.float32).contiguous()


def contiguous_as(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` contiguous and of exactly ``dtype`` (no conversion: a tensor of
    another type is refused, so no silent copy of a key set is made)."""
    if t.dtype != dtype:
        raise TypeError(f"the CUDA kernel takes {dtype} here, got {t.dtype}")
    return t.contiguous()


def index(t: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    """An integer index tensor as contiguous ``dtype``; floats are refused."""
    if t is None:
        return None
    if t.is_floating_point() or t.is_complex() or t.dtype == torch.bool:
        raise TypeError(f"index tensors must be integers, got {t.dtype}")
    return t.to(dtype).contiguous()


def u8(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.to(torch.bool).contiguous().view(torch.uint8)
