"""The kernels on the "meta" device: the dry run's stand-ins for K1–K5.

A kernel wrapper handed a meta tensor (``launch.dryrun`` traces a step on
the meta device) neither launches nor runs its plain version: it returns
outputs of the kernel's shapes and dtypes and reports the kernel's own
work to the active reckoner (:func:`reckoning`) — its FLOPs by operand
type and the bytes it must move, by the formulas of PERF.md §6's bound
column:

  * K1 / K2 (top-k): a (query, key) pair costs 2·d + 3 f32 operations on
    the CUDA-core routes; on "tc3xtf32" the cross term is three TF32
    products (3·2·d) and the add, subtract and max stay f32 (3). Bytes:
    the queries, the keys, the valid mask and the (nq, k) lists.
  * K3 (segment sum): a multiply-add per element and a weight per row,
    f32; the rows, ids and weights read, the sums and masses written.
  * K4 (distance matrix): 2·d + 3 f32 a pair and the norms; x and y
    read, the (n, m) matrix written.
  * K5 (flash attention): per visible (query, key) pair, on the
    tensor-core prefill route "tiled_mma" q·k and p·v twice as bf16
    products (6·dh) and 8 f32 softmax operations; on "split_kv" and
    "tiled" q·k in q's type (bf16 products where q is bf16), p·v and the
    softmax in f32. Bytes: q, k, v and the bias read, the output written;
    the lse entry ("split_kv") writes its output in f32 and the (b, hq, lq)
    f32 lse besides.

Launch counters do not move: a meta call launches nothing. The
conversions a wrapper makes before its launch (a bias to f32, a view made
contiguous) are not counted.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch

# the active reckoner: (kernel, route, {dtype: flops}, bytes) -> None
_RECKONER: Optional[Callable[[str, str, Dict[str, float], float], None]] = None


@contextlib.contextmanager
def reckoning(fn: Callable[[str, str, Dict[str, float], float], None]) -> Iterator[None]:
    """Report every meta call of a kernel wrapper to ``fn(kernel, route,
    flops_by_dtype, bytes)`` inside the block."""
    global _RECKONER
    prev, _RECKONER = _RECKONER, fn
    try:
        yield
    finally:
        _RECKONER = prev


def _report(kernel: str, route: str, flops: Dict[str, float], nbytes: float) -> None:
    if _RECKONER is not None:
        _RECKONER(kernel, route, flops, float(nbytes))


def _nbytes(*ts: Optional[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _empty(shape, dtype, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=like.device)


def topk_work(nq: int, p: int, d: int, route: str) -> Dict[str, float]:
    """FLOPs by type of a top-k of ``nq`` queries over ``p`` keys."""
    pairs = float(nq) * p
    if route == "tc3xtf32":
        return {"tf32": 3 * 2 * d * pairs, "float32": 3 * pairs}
    return {"float32": (2 * d + 3) * pairs}


def topk(kernel: str, q: torch.Tensor, keys: torch.Tensor, k: int, route: str,
         *extra: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 / K2: (dists (nq, k) f32, idx (nq, k) int32)."""
    nq, d = q.shape
    dists = _empty((nq, k), torch.float32, q)
    idx = _empty((nq, k), torch.int32, q)
    _report(kernel, route, topk_work(nq, keys.shape[0], d, route),
            _nbytes(q, keys, *extra, dists, idx))
    return dists, idx


def segment_sum(x: torch.Tensor, ids: torch.Tensor, num_segments: int,
                weights: Optional[torch.Tensor], route: str
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: (sums (S, d) f32, masses (S,) f32)."""
    n, d = x.shape
    sums = _empty((num_segments, d), torch.float32, x)
    mass = _empty((num_segments,), torch.float32, x)
    _report("K3", route, {"float32": float(n) * (2 * d + 1)},
            _nbytes(x, ids, weights, sums, mass))
    return sums, mass


def pairwise(x: torch.Tensor, y: torch.Tensor, y_valid: Optional[torch.Tensor],
             route: str) -> torch.Tensor:
    """K4: the (n, m) f32 matrix."""
    n, d = x.shape
    m = y.shape[0]
    out = _empty((n, m), torch.float32, x)
    flops = float(n) * m * (2 * d + 3) + float(n + m) * 2 * d
    _report("K4", route, {"float32": flops}, _nbytes(x, y, y_valid, out))
    return out


def visible_pairs(b: int, h: int, lq: int, lk: int, causal: bool) -> float:
    """(query, key) pairs a causal mask aligned to the end of kv leaves
    (all lq·lk without it), times b·h."""
    if not causal:
        return float(b) * h * lq * lk
    # row i sees min(lk, i + lk - lq + 1) keys (lq <= lk)
    first = lk - lq + 1
    return float(b) * h * (lq * first + lq * (lq - 1) / 2)


def attention_work(b: int, hq: int, lq: int, lk: int, dh: int, causal: bool,
                   dtype: torch.dtype, route: str) -> Dict[str, float]:
    """FLOPs by type of one K5 call on ``route``."""
    pairs = visible_pairs(b, hq, lq, lk, causal)
    if route == "tiled_mma":
        return {"bfloat16": pairs * 6 * dh, "float32": pairs * 8}
    qk = pairs * 2 * dh
    if dtype == torch.bfloat16:
        return {"bfloat16": qk, "float32": pairs * (2 * dh + 8)}
    return {"float32": qk + pairs * (2 * dh + 8)}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_bias: Optional[torch.Tensor], causal: bool,
                    route: str) -> torch.Tensor:
    """K5: the output, q's shape and dtype."""
    b, hq, lq, dh = q.shape
    out = torch.empty_like(q)
    elt = q.element_size()
    nbytes = (2 * q.numel() + 2 * k.numel()) * elt + (
        0 if kv_bias is None else kv_bias.numel() * 4)
    _report("K5", route, attention_work(b, hq, lq, k.shape[2], dh, causal, q.dtype,
                                        route), nbytes)
    return out


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_bias: Optional[torch.Tensor], causal: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's lse entry (the split-kv route): (o f32 of q's shape, lse (b, hq,
    lq) f32)."""
    b, hq, lq, dh = q.shape
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty((b, hq, lq), dtype=torch.float32, device=q.device)
    nbytes = (q.numel() + 2 * k.numel()) * q.element_size() + _nbytes(out, lse) + (
        0 if kv_bias is None else kv_bias.numel() * 4)
    _report("K5", "split_kv_lse", attention_work(b, hq, lq, k.shape[2], dh, causal,
                                                 q.dtype, "split_kv"), nbytes)
    return out, lse
