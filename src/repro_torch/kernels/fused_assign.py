"""Streaming k-nearest-keys (K1) — the assign and blocked-kNN hot path.

The serving assign and the TC inner loop both reduce to: distances of a
query block against a big key set, keep the k best. Two versions of one
function, with the reference's merge semantics (the earliest key index
wins a distance tie, unfilled slots are (inf, -1)):

  * :func:`fused_topk` — the wrapper of the CUDA kernel ``csrc/topk.cu``
    (the port of ``repro.kernels.fused_assign._fused_kernel``). It streams
    every key tile through shared memory against a best list held in
    registers, so the (nq, p) distance matrix never exists. For a CPU
    tensor it runs :func:`fused_topk_plain`.
  * :func:`fused_topk_plain` — the same streaming fold in plain PyTorch,
    one (block_q, block_k) tile at a time (the counterpart of
    ``fused_topk_xla``); peak memory O(block_q·block_k).

Keys are f32, bf16, or int8 with per-feature ``keys_scale``/``keys_zero``
(key value ``q8 * scale + zero``, a multiply then an add); queries f32,
or bf16 with bf16 keys. Distances always fold in f32. :func:`quantize_keys` freezes the int8
buffer of an index and :func:`rescore_top1` rescores a low-precision
shortlist in exact f32 — plain PyTorch, as the reference computes them
outside Pallas.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _cuda, ref
from repro_torch.runtime import active

#: shortlist length the quantized assign variants rescore in exact f32
RESCORE_K = 8

#: the tensor-core route of ``csrc/topk.cu`` (the cross term as 3xTF32
#: products): every key type, d <= TC_MAX_D, k <= TC_MAX_K; above TC_MAX_D
#: the same k take the CUDA-core split route
TC_MAX_D, TC_MAX_K = 32, 8

#: the CUDA-core split route's blocks: SPLIT_Q queries against whole
#: 64-key tiles of one key range, about SPLIT_BLOCKS_WANTED of them
SPLIT_Q, SPLIT_BLOCKS_WANTED = 64, 132 * 2


#: the routes of ``csrc/topk.cu`` by their C codes (``repro_topk_route``)
ROUTES = ("cuda_core", "tc3xtf32", "cuda_core_split")

#: the longest list the kernels keep (``repro_topk_max_k``)
MAX_K = 32


def route(q_dtype: torch.dtype, keys_dtype: torch.dtype, d: int, k: int) -> str:
    """Which kernel of ``csrc/topk.cu`` a launch takes by default, whatever
    the key type (f32, bf16 or int8; the queries are read as f32):
    "tc3xtf32" (the tensor-core cross term, keys split across blocks, an
    exact rescore; d <= 32, k <= 8), "cuda_core_split" (the
    register-tiled f32 FMA kernel, keys split across blocks; d > 32,
    k <= 8) or "cuda_core" (the f32 FMA pair loop; k > 8). Each key type
    is widened or dequantized to f32 as it is staged, so the route follows
    the shape alone."""
    if 1 <= k <= TC_MAX_K:
        if 1 <= d <= TC_MAX_D:
            return "tc3xtf32"
        if d > TC_MAX_D:
            return "cuda_core_split"
    return "cuda_core"


def route_ok(name: str, d: int, k: int) -> bool:
    """Whether route ``name`` can run (d, k) when asked for by name
    (``repro_topk_route_ok``): "tc3xtf32" at d <= 32, k <= 8;
    "cuda_core_split" at k <= 8, any d (its kernels stage 32 features at a
    time, zero-filled); "cuda_core" at k <= 32. Every bound is a power of
    two, so a route legal at a shape bucket's edge is legal in the bucket."""
    if d < 1 or k < 1:
        return False
    if name == "tc3xtf32":
        return d <= TC_MAX_D and k <= TC_MAX_K
    if name == "cuda_core_split":
        return k <= TC_MAX_K
    if name == "cuda_core":
        return k <= MAX_K
    return False


def check_route(name: Optional[str], d: int, k: int) -> str:
    """``name`` (None: the default rule) if it can run (d, k); raise
    ``ValueError`` otherwise — a route asked for is never rerouted."""
    if name is None:
        return route(torch.float32, torch.float32, d, k)
    if name not in ROUTES:
        raise ValueError(f"topk: unknown route {name!r}; routes {ROUTES}")
    if not route_ok(name, d, k):
        raise ValueError(f"topk: route {name!r} cannot run d={d}, k={k}")
    return name


#: kernel id of each key type -> (its library of csrc/topk.cu, the attribute
#: of fused_topk that counts its launches)
KEY_TYPES = {"K1": ("topk", "launches"), "K1-bf16": ("topk_bf16", "launches_bf16"),
             "K1-int8": ("topk_int8", "launches_int8")}


def key_type(keys_dtype: torch.dtype) -> str:
    """The kernel id of a key type (a key of KEY_TYPES): "K1" for float
    keys (widened to f32), "K1-bf16", "K1-int8"."""
    return {torch.bfloat16: "K1-bf16", torch.int8: "K1-int8"}.get(keys_dtype, "K1")


def split_plan(nq: int, p: int) -> Tuple[int, int]:
    """(key ranges, keys a range) of the CUDA-core split route for nq
    queries against p keys: about SPLIT_BLOCKS_WANTED (query tile, key
    range) blocks, each range whole 64-key tiles and none empty (the
    last may be short)."""
    qtiles, tiles = -(-nq // SPLIT_Q), -(-p // 64)
    if tiles < 1 or qtiles < 1:
        return 1, 64
    want = min(-(-SPLIT_BLOCKS_WANTED // qtiles), tiles)
    splits = -(-tiles // -(-tiles // want))
    return splits, -(-tiles // splits) * 64


def _check_key_types(q, keys, keys_scale, keys_zero) -> None:
    if keys.dtype == torch.bfloat16 and q.dtype != torch.bfloat16:
        raise ValueError(f"bf16 keys take bf16 queries, got {q.dtype} queries "
                         f"(cast them, as the fused_bf16 assign does)")
    if (keys_scale is None) != (keys_zero is None):
        raise ValueError("keys_scale and keys_zero come together")
    if keys_scale is None:
        if keys.dtype == torch.int8:
            raise ValueError("int8 keys need keys_scale and keys_zero")
        return
    if keys.dtype != torch.int8:
        raise ValueError(f"keys_scale/keys_zero dequantize int8 keys, got "
                         f"{keys.dtype} keys")
    d = keys.shape[1]
    for name, t in (("keys_scale", keys_scale), ("keys_zero", keys_zero)):
        if tuple(t.shape) != (d,):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want ({d},)")


def launch_topk(
    q: torch.Tensor,
    keys: torch.Tensor,
    k: int,
    key_valid: Optional[torch.Tensor],
    q_gidx: Optional[torch.Tensor],
    keys_scale: Optional[torch.Tensor] = None,
    keys_zero: Optional[torch.Tensor] = None,
    route_name: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/topk.cu`` (shared by the K1 and K2 wrappers): the f32,
    bf16 or int8 key instance, chosen by ``keys.dtype``, on ``route_name``
    (None: the rule of :func:`route`; an illegal route raises). The
    queries go in as f32 (bf16 widens exactly)."""
    dev = _cuda.require_cuda("topk", q, keys, key_valid, q_gidx, keys_scale,
                             keys_zero)
    name = KEY_TYPES[key_type(keys.dtype)][0]
    lib = _cuda.library(name)
    if q.ndim != 2 or keys.ndim != 2 or q.shape[1] != keys.shape[1]:
        raise ValueError(f"topk: want q (nq, d) and keys (p, d), got "
                         f"{tuple(q.shape)} and {tuple(keys.shape)}")
    nq, d = q.shape
    p = keys.shape[0]
    if not 1 <= k <= lib.repro_topk_max_k():
        raise ValueError(f"topk: k={k} outside the kernel's range "
                         f"[1, {lib.repro_topk_max_k()}]")
    if d < 1:
        raise ValueError(f"topk: d={d}; the kernel takes any d >= 1")
    if key_valid is not None and tuple(key_valid.shape) != (p,):
        raise ValueError(f"topk: key_valid has shape {tuple(key_valid.shape)}, "
                         f"want ({p},)")
    if q_gidx is not None and tuple(q_gidx.shape) != (nq,):
        raise ValueError(f"topk: q_gidx has shape {tuple(q_gidx.shape)}, "
                         f"want ({nq},)")
    _check_key_types(q, keys, keys_scale, keys_zero)
    code = ROUTES.index(check_route(route_name, d, k))
    v = _cuda.u8(key_valid)
    g = _cuda.index(q_gidx, torch.int32)
    out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    # bf16 queries widen to f32 exactly (every instance reads f32 queries)
    qf = _cuda.f32(q)
    kc = keys.contiguous() if name != "topk" else _cuda.f32(keys)
    scale_zero = ()
    if name == "topk_int8":
        scale_zero = (_cuda.ptr(_cuda.contiguous_as(keys_scale, torch.float32)),
                      _cuda.ptr(_cuda.contiguous_as(keys_zero, torch.float32)))
    # the tensor-core and split routes' per-split candidate lists (0 bytes
    # on the CUDA-core route)
    nbytes = lib.repro_topk_scratch_bytes(nq, p, d, k, code)
    scratch = (torch.empty((nbytes,), dtype=torch.uint8, device=dev)
               if nbytes else None)
    with torch.cuda.device(dev):
        _cuda.call(name, _cuda.ptr(qf), _cuda.ptr(kc), *scale_zero,
                   _cuda.ptr(v), _cuda.ptr(g), _cuda.ptr(out_d), _cuda.ptr(out_i),
                   nq, p, d, k, code, _cuda.ptr(scratch), _cuda.stream(dev))
    return out_d, out_i


def fused_topk(
    q: torch.Tensor,
    keys: torch.Tensor,
    k: int,
    key_valid: Optional[torch.Tensor] = None,
    *,
    q_gidx: Optional[torch.Tensor] = None,
    keys_scale: Optional[torch.Tensor] = None,
    keys_zero: Optional[torch.Tensor] = None,
    block_k: Optional[int] = None,
    route: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest valid keys of each query row (K1).

    Args:
      q: (nq, d) queries, f32, or bf16 with bf16 keys (distances fold
        in f32).
      keys: (p, d) keys: float (f32, bf16), or int8 with ``keys_scale`` /
        ``keys_zero`` (d,) per-feature dequantization (see
        :func:`quantize_keys`).
      k: best-list length (1 for assign, t−1 for TC, 8 for a shortlist).
      key_valid: optional (p,) mask; invalid keys never enter a list.
      q_gidx: optional (nq,) global index of each query among the keys;
        the matching key is excluded (the blocked-kNN self-match mask).
      block_k: key block of the plain fold (CPU tensors only).
      route: the kernel's route by name (:data:`ROUTES`; None: the rule
        of :func:`route`); one that cannot run (d, k) raises. Ignored for
        a CPU tensor.

    Returns:
      (dists (nq, k) f32 ascending, idx (nq, k) int32; unfilled slots
      inf/-1). Launches count per key type: ``fused_topk.launches`` (f32),
      ``.launches_bf16`` and ``.launches_int8``; and per key type and
      route in ``.route_launches`` ("K1-int8/tc3xtf32": n, ...).
    """
    if not _cuda.on_card(q):
        return fused_topk_plain(q, keys, k, key_valid, q_gidx=q_gidx,
                                keys_scale=keys_scale, keys_zero=keys_zero,
                                block_k=block_k)
    _cuda.forbid_grad("fused_topk", q, keys, keys_scale, keys_zero)
    out = launch_topk(q, keys, k, key_valid, q_gidx, keys_scale, keys_zero, route)
    way = check_route(route, q.shape[1], k)  # the shapes passed the launch's checks
    if q.shape[0]:
        kid = key_type(keys.dtype)
        attr = KEY_TYPES[kid][1]
        setattr(fused_topk, attr, getattr(fused_topk, attr) + 1)
        key = f"{kid}/{way}"
        fused_topk.route_launches[key] = fused_topk.route_launches.get(key, 0) + 1
    return out


fused_topk.launches = 0
fused_topk.launches_bf16 = 0
fused_topk.launches_int8 = 0
fused_topk.route_launches = {}


def fused_topk_plain(
    q: torch.Tensor,
    keys: torch.Tensor,
    k: int,
    key_valid: Optional[torch.Tensor] = None,
    *,
    q_gidx: Optional[torch.Tensor] = None,
    keys_scale: Optional[torch.Tensor] = None,
    keys_zero: Optional[torch.Tensor] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain streaming fold: dense distances of one (block_q, block_k)
    tile at a time, merged into the query block's running best list, so
    peak memory is O(block_q·block_k) whatever nq and p. An int8 key tile
    dequantizes as ``q8.float() * scale + zero`` (a multiply, then an add,
    each rounded), as the reference does."""
    _check_key_types(q, keys, keys_scale, keys_zero)
    cfg = active()
    block_q = cfg.block_q if block_q is None else block_q
    block_k = cfg.block_k if block_k is None else block_k
    nq, p = q.shape[0], keys.shape[0]
    bk = min(block_k, max(p, 1))
    out_d, out_i = [], []
    for q0 in range(0, nq, block_q):
        qb = q[q0:q0 + block_q]
        gb = None if q_gidx is None else q_gidx[q0:q0 + block_q].to(torch.int64)
        n = qb.shape[0]
        bd = torch.full((n, k), torch.inf, dtype=torch.float32, device=q.device)
        bi = torch.full((n, k), -1, dtype=torch.int32, device=q.device)
        for lo in range(0, p, bk):
            hi = min(lo + bk, p)
            v = None if key_valid is None else key_valid[lo:hi]
            y = keys[lo:hi]
            if keys_scale is not None:
                y = y.float() * keys_scale.float() + keys_zero.float()
            d = ref.pairwise_sq_l2(qb, y, y_valid=v)
            gidx = torch.arange(lo, hi, dtype=torch.int64, device=q.device)
            if gb is not None:
                d = torch.where(gb[:, None] == gidx[None, :], torch.inf, d)
            bd, bi = ref.merge_topk(bd, bi, d, gidx.expand(n, hi - lo), k)
        out_d.append(bd)
        out_i.append(bi)
    if not out_d:
        return (torch.empty((0, k), dtype=torch.float32, device=q.device),
                torch.empty((0, k), dtype=torch.int32, device=q.device))
    return torch.cat(out_d), torch.cat(out_i)


# ---------------------------------------------------------------------------
# quantization (freeze time) and exact-f32 shortlist rescore (serve time)
# ---------------------------------------------------------------------------


def quantize_keys(
    keys: torch.Tensor, valid: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-feature symmetric-range int8 quantization of a key set.

    Scale and zero point come from the valid rows only (padding rows must
    not widen the range); a constant feature gets a floor scale, so its
    zero point reproduces it. Returns ``(q8 (p, d) int8, scale (d,) f32,
    zero (d,) f32)``; a key dequantizes as ``q8 * scale + zero``. The same
    bits as ``repro.kernels.fused_assign.quantize_keys``.
    """
    k32 = keys.float()
    v = (torch.ones((keys.shape[0],), dtype=torch.bool, device=keys.device)
         if valid is None else valid.bool())
    any_valid = v.any()
    inf = torch.tensor(torch.inf, dtype=torch.float32, device=keys.device)
    if keys.shape[0] == 0:  # no rows: the empty reductions' identities
        lo = hi = torch.zeros((keys.shape[1],), dtype=torch.float32,
                              device=keys.device)
    else:
        lo = torch.where(v[:, None], k32, inf).amin(dim=0)
        hi = torch.where(v[:, None], k32, -inf).amax(dim=0)
    lo = torch.where(any_valid, lo, 0.0)
    hi = torch.where(any_valid, hi, 0.0)
    zero = 0.5 * (hi + lo)
    scale = torch.clamp_min((hi - lo) / 254.0, 1e-12)
    q8 = torch.clamp(torch.round((k32 - zero) / scale), -127.0, 127.0)
    return q8.to(torch.int8), scale, zero


def rescore_top1(
    queries: torch.Tensor,
    keys: torch.Tensor,
    valid: torch.Tensor,
    cand_idx: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact-f32 rescore of a shortlist: gather the candidate rows of the
    full-precision key buffer and return the true nearest.

    Args:
      queries: (nq, d); keys: (p, d) full-precision buffer.
      valid: (p,) mask; cand_idx: (nq, r) shortlist (int32, -1 = empty).

    Returns:
      (dist (nq,), idx (nq,) int32) — exact sq-L2 to the winner (the first
      of equal candidates), -1 if the shortlist holds no valid candidate.
    """
    q32 = queries.float()
    cand = cand_idx.to(torch.int64)
    safe = torch.where(cand >= 0, cand, 0)
    cp = keys.float()[safe]                          # (nq, r, d)
    d = torch.square(q32[:, None, :] - cp).sum(dim=-1)
    ok = (cand >= 0) & valid.bool()[safe]
    d = torch.where(ok, d, torch.inf)
    if d.shape[1] == 0:
        nq = d.shape[0]
        return (torch.full((nq,), torch.inf, device=d.device),
                torch.full((nq,), -1, dtype=torch.int32, device=d.device))
    j = torch.argmin(d, dim=1, keepdim=True)
    dist = torch.gather(d, 1, j)[:, 0]
    idx = torch.gather(cand_idx.to(torch.int32), 1, j)[:, 0]
    return dist, torch.where(torch.isfinite(dist), idx, -1)
