"""Kernels of the port: hand-written CUDA (``csrc/``) beside plain PyTorch.

Each kernel wrapper counts its launches in a plain integer attribute,
``<wrapper>.launches``; :func:`launch_counts` reads them all and
:func:`reset_launch_counts` zeroes them, so a run can show which kernels
the main path went through.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import fused_assign as _fused_assign
from repro_torch.kernels import knn_topk as _knn_topk
from repro_torch.kernels import pairwise_l2 as _pairwise_l2
from repro_torch.kernels import segment_sum as _segment_sum

#: kernel id -> wrapper whose ``launches`` counts it
WRAPPERS = {
    "K1": _fused_assign.fused_topk,
    "K2": _knn_topk.knn_topk,
    "K3": _segment_sum.segment_sum,
    "K4": _pairwise_l2.pairwise_sq_l2,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
