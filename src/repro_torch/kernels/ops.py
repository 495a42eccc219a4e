"""Public kernel entry points and their dispatch.

Dispatch policy (``impl=``), resolved by :func:`resolve`:

  * ``None``    — the active runtime config's policy;
  * ``"auto"``  — for a CUDA tensor the hand-written kernels (``"fused"``
    on the nearest/kNN ops, ``"cuda"`` elsewhere), for a CPU tensor the
    plain PyTorch versions (``"ref"``); a meta tensor takes the card's
    choice, and its wrappers reckon the kernel's work
    (:mod:`repro_torch.kernels.meta`, the dry run's);
  * ``"cuda"``  — each op's kernel wrapper (which runs its plain version
    when handed a CPU tensor); nearest composes the K4 distance matrix
    with the plain merge, as the reference's ``"pallas"`` does;
  * ``"fused"`` — the streaming top-k on nearest/kNN; ops without a fused
    path treat it as ``"auto"``;
  * ``"fused_bf16"`` / ``"fused_int8"`` — the quantized shortlist of
    :meth:`repro_torch.core.index.ClusterIndex.assign`, which holds the
    frozen low-precision buffers; the stateless ops here run them as
    ``"fused"``, and ops without a fused path as ``"auto"``;
  * ``"ref"``   — the plain versions, on any device (on the card only when
    asked for explicitly).

Unknown names raise. On a CUDA tensor a kernel either launches or raises:
nothing falls back to the plain version.

Tuning (``RuntimeConfig.tune``, :mod:`repro_torch.tune`): with the policy
on, each op looks up its cell at its own shape bucket and device kind at
call time. The measured impl decides only the ``"auto"`` case (an explicit
``impl=`` or a configured non-auto policy wins); the measured route (the
port's counterpart of the reference's tuned tiles) applies unless the
caller passes ``route=``. With the policy off an op reads the config once
and every route follows its kernel's shape rule.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_assign, knn_topk, pairwise_l2, ref
from repro_torch.kernels import segment_sum as _segsum
from repro_torch.runtime import IMPLS, active

#: the fused nearest/top-k dispatch family
FUSED_IMPLS = ("fused", "fused_bf16", "fused_int8")


def resolve(impl: Optional[str], device: torch.device, *,
            fused: bool = False, tuned: Optional[str] = None) -> str:
    """Dispatch policy → "ref" | "cuda" or one of :data:`FUSED_IMPLS` for
    a tensor on ``device``; ``fused`` marks the ops that have a streaming
    top-k (the others degrade the fused family to "auto"). ``tuned``, a
    measured winner, decides only the "auto" case."""
    if impl is None:
        impl = active().impl
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; registered impls: {list(IMPLS)}")
    if impl in FUSED_IMPLS and not fused:
        impl = "auto"
    if impl == "auto" and tuned is not None and (fused or tuned not in FUSED_IMPLS):
        impl = tuned
    if impl == "auto":
        if torch.device(device).type in ("cuda", "meta"):
            impl = "fused" if fused else "cuda"
        else:
            impl = "ref"
    return impl


def dtype_name(dtype: torch.dtype) -> str:
    """The tuning cache's name of a dtype: "float32", "bfloat16", "int8"."""
    return str(dtype).removeprefix("torch.")


def _tuned(kernel: str, dtype: torch.dtype, device: torch.device,
           **dims: int) -> dict:
    """Measured winners of ``kernel`` at this call's shape bucket on
    ``device`` (``{}`` unless the tuning policy is on and has, or
    measures, an entry)."""
    if active().tune == "off":
        return {}
    from repro_torch import tune  # the off path never imports it

    return tune.tuned_params(kernel, dtype=dtype_name(dtype), device=device, **dims)


def pairwise_sq_l2(
    x: torch.Tensor,
    y: torch.Tensor,
    *,
    y_valid: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
    route: Optional[str] = None,
) -> torch.Tensor:
    """K4 for a CUDA tensor on ``route`` ("small_m" | "tiled"; default:
    the tuned one, else the shape rule), the plain version otherwise."""
    tp = _tuned("pairwise_sq_l2", x.dtype, x.device, n=x.shape[0], m=y.shape[0],
                d=x.shape[1])
    if resolve(impl, x.device, tuned=tp.get("impl")) == "cuda":
        return pairwise_l2.pairwise_sq_l2(
            x, y, y_valid, route=route if route is not None else tp.get("route"))
    return ref.pairwise_sq_l2(x, y, y_valid=y_valid)


def knn(
    x: torch.Tensor,
    k: int,
    *,
    valid: Optional[torch.Tensor] = None,
    exclude_self: bool = True,
    impl: Optional[str] = None,
    route: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Self-kNN: K2 on the card (under "fused" and "cuda") on ``route``
    (default: the tuned one, else the shape rule); on the CPU the fused
    policy runs the plain streaming fold, the others the dense
    reference."""
    tp = _tuned("knn", x.dtype, x.device, n=x.shape[0], d=x.shape[1], k=k)
    r = resolve(impl, x.device, fused=True, tuned=tp.get("impl"))
    if r in FUSED_IMPLS and not (x.is_cuda or x.is_meta):
        gidx = (torch.arange(x.shape[0], dtype=torch.int32, device=x.device)
                if exclude_self else None)
        return fused_assign.fused_topk_plain(x, x, k, valid, q_gidx=gidx,
                                             block_k=tp.get("block_k"))
    if r in FUSED_IMPLS or r == "cuda":
        return knn_topk.knn_topk(
            x, k, valid, exclude_self=exclude_self,
            route=route if route is not None else tp.get("route"))
    return ref.knn(x, k, valid=valid, exclude_self=exclude_self)


def resolve_nearest(impl: Optional[str], *, dtype: torch.dtype, nq: int, p: int,
                    d: int, k: int = 1, device: torch.device) -> Tuple[str, dict]:
    """Resolve the nearest/top-k dispatch through the ``"assign"`` tuning
    cell: ``(resolved impl, tuned params)``; the tuned ``block_k`` and
    ``route`` apply where the caller passes none."""
    tp = _tuned("assign", dtype, device, nq=nq, p=p, d=d, k=k)
    return resolve(impl, device, fused=True, tuned=tp.get("impl")), tp


def nearest_topk(
    q: torch.Tensor,
    keys: torch.Tensor,
    k: int,
    *,
    key_valid: Optional[torch.Tensor] = None,
    q_gidx: Optional[torch.Tensor] = None,
    keys_scale: Optional[torch.Tensor] = None,
    keys_zero: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
    block_k: Optional[int] = None,
    route: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest valid keys of each query row (dists ascending, idx; -1 for
    unfillable slots) — the assign and blocked-kNN entry point. Every
    policy gives the same bits on exact inputs: they share the merge's tie
    rule. int8 keys (with ``keys_scale``/``keys_zero``) and bf16 keys go
    through the fused family's streaming fold (K1's int8/bf16 instances
    on the card); the composed policies dequantize or widen them first.
    ``route``: K1's route on the fused family (default: the ``"assign"``
    cell's tuned one, else K1's shape rule)."""
    r, tp = resolve_nearest(impl, dtype=q.dtype, nq=q.shape[0], p=keys.shape[0],
                            d=q.shape[1], k=k, device=q.device)
    if r in FUSED_IMPLS:
        return fused_assign.fused_topk(
            q, keys, k, key_valid, q_gidx=q_gidx, keys_scale=keys_scale,
            keys_zero=keys_zero,
            block_k=block_k if block_k is not None else tp.get("block_k"),
            route=route if route is not None else tp.get("route"))
    if keys_scale is not None:
        keys = keys.float() * keys_scale.float() + keys_zero.float()
    d = pairwise_sq_l2(q, keys, y_valid=key_valid, impl=r)
    kcols = torch.arange(keys.shape[0], dtype=torch.int64, device=q.device)
    if q_gidx is not None:
        d = torch.where(q_gidx.to(torch.int64)[:, None] == kcols[None, :],
                        torch.inf, d)
    nq = q.shape[0]
    init_d = torch.full((nq, k), torch.inf, dtype=torch.float32, device=q.device)
    init_i = torch.full((nq, k), -1, dtype=torch.int32, device=q.device)
    return ref.merge_topk(init_d, init_i, d, kcols.expand(nq, -1), k)


def segment_sum(
    x: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    weights: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
    route: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 with one block for a CUDA tensor on ``route`` ("few" | "many";
    default: the tuned one, else the segment-count rule)."""
    tp = _tuned("segment_sum", x.dtype, x.device, n=x.shape[0], d=x.shape[1],
                s=num_segments)
    if resolve(impl, x.device, tuned=tp.get("impl")) == "cuda":
        return _segsum.segment_sum(
            x, segment_ids, num_segments, weights,
            route=route if route is not None else tp.get("route"))
    return ref.segment_sum(x, segment_ids, num_segments, weights=weights)


def blocked_segment_sum(
    x: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    weights: Optional[torch.Tensor] = None,
    n_blocks: Optional[int] = None,
    impl: Optional[str] = None,
    route: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment sum with a fixed reduction tree: rows split into ``n_blocks``
    equal blocks (right-padded with dropped ids), one partial per block,
    partials added left to right in block order. The order is pinned by
    ``n_blocks`` alone, which is what makes the bits reproducible; it
    defaults to the runtime config (8). ``n_blocks <= 1`` is one plain
    segment sum. Under "cuda" the whole tree is one K3 call; "ref" runs
    the plain per-block loop. ``route`` as :func:`segment_sum`'s (the
    ``"segment_sum"`` cell, looked up at the whole call's shape)."""
    if n_blocks is None:
        n_blocks = active().n_blocks
    tp = _tuned("segment_sum", x.dtype, x.device, n=x.shape[0], d=x.shape[1],
                s=num_segments)
    if resolve(impl, x.device, tuned=tp.get("impl")) == "cuda":
        return _segsum.blocked_segment_sum(
            x, segment_ids, num_segments, weights, n_blocks=n_blocks,
            route=route if route is not None else tp.get("route"))
    return ref.blocked_segment_sum(x, segment_ids, num_segments,
                                   weights=weights, n_blocks=n_blocks)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    kv_bias: Optional[torch.Tensor] = None,
    logit_softcap: float = 0.0,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """GQA attention entry point: q (b, hq, lq, dh); k/v (b, hkv, lk, dh);
    kv_bias (b, hkv or hq, lk). K5 for a CUDA tensor, the plain version
    (kv heads repeated, dense softmax) for a CPU tensor or ``impl="ref"``."""
    if resolve(impl, q.device) == "cuda":
        return _fa.flash_attention(q, k, v, kv_bias, causal=causal, scale=scale,
                                   logit_softcap=logit_softcap)
    return _fa.flash_attention_plain(q, k, v, kv_bias, causal=causal,
                                     scale=scale, logit_softcap=logit_softcap)
