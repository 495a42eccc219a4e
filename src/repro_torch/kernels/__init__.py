"""Kernels of the port: hand-written CUDA (``csrc/``) beside plain PyTorch.

Each kernel wrapper counts its launches in a plain integer attribute,
``<wrapper>.launches`` (K1 counts its bf16 and int8 key instances apart,
in ``.launches_bf16`` and ``.launches_int8``; K5 counts every launch and,
apart, those of its split-kv decode route in ``.launches_decode``; its
lse entry, ``flash_attention_lse``, is "K5-lse");
:func:`launch_counts` reads them all, :func:`route_counts` the launches
of K1–K5 per route (K5's tensor-core prefill route is "K5/tiled_mma"
there, K4's instances "K4/small_m" and "K4/tiled", K3's paths "K3/few"
and "K3/many", K2's routes "K2/tc3xtf32" ...), and
:func:`reset_launch_counts` zeroes them all,
so a run can show which kernels the main path went through.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import flash_attention as _flash_attention
from repro_torch.kernels import fused_assign as _fused_assign
from repro_torch.kernels import knn_topk as _knn_topk
from repro_torch.kernels import pairwise_l2 as _pairwise_l2
from repro_torch.kernels import segment_sum as _segment_sum

#: kernel id -> (wrapper, the attribute that counts its launches)
COUNTERS = {
    "K1": (_fused_assign.fused_topk, "launches"),
    "K1-bf16": (_fused_assign.fused_topk, "launches_bf16"),
    "K1-int8": (_fused_assign.fused_topk, "launches_int8"),
    "K2": (_knn_topk.knn_topk, "launches"),
    "K3": (_segment_sum.blocked_segment_sum, "launches"),
    "K4": (_pairwise_l2.pairwise_sq_l2, "launches"),
    "K5": (_flash_attention.flash_attention, "launches"),
    "K5-decode": (_flash_attention.flash_attention, "launches_decode"),
    "K5-lse": (_flash_attention.flash_attention_lse, "launches"),
}

#: wrappers that count their launches per route in ``.route_launches``
_ROUTED = {"K1": _fused_assign.fused_topk, "K2": _knn_topk.knn_topk,
           "K3": _segment_sum.blocked_segment_sum,
           "K4": _pairwise_l2.pairwise_sq_l2, "K5": _flash_attention.flash_attention}


def launch_counts() -> Dict[str, int]:
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}


def route_counts() -> Dict[str, int]:
    """Launches per route: "K1-int8/tc3xtf32", "K2/cuda_core_split",
    "K3/many", "K4/tiled", "K5/tiled_mma", ..."""
    out = {}
    for kid, fn in _ROUTED.items():
        for key, n in fn.route_launches.items():
            out[key if "/" in key else f"{kid}/{key}"] = n
    return dict(sorted(out.items()))


def reset_launch_counts() -> None:
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)
    for fn in _ROUTED.values():
        fn.route_launches = {}
