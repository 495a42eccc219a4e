"""Kernels of the port: hand-written CUDA (``csrc/``) beside plain PyTorch.

Each kernel wrapper counts its launches in a plain integer attribute,
``<wrapper>.launches`` (K1 counts its bf16 and int8 key instances apart,
in ``.launches_bf16`` and ``.launches_int8``); :func:`launch_counts`
reads them all and :func:`reset_launch_counts` zeroes them, so a run can
show which kernels the main path went through.
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
    "K3": (_segment_sum.segment_sum, "launches"),
    "K4": (_pairwise_l2.pairwise_sq_l2, "launches"),
    "K5": (_flash_attention.flash_attention, "launches"),
}


def launch_counts() -> Dict[str, int]:
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}


def reset_launch_counts() -> None:
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)
