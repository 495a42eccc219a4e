"""Collective wire-byte accounting for the roofline — the port of
``repro.utils.hlo``, which parses a compiled program's HLO text. The port
has no HLO: its collectives are the calls of
:class:`~repro_torch.core._collectives.Axis` (and of the dry run's
:class:`~repro_torch.core._collectives.RecordingAxis`), which a traced
step records by op and group size (``_collectives.op_records()``:
``[{"op", "group", "calls", "bytes"}]``, bytes the tensors this rank handed
in). Each op is read as the HLO collective it stands for, under the
reference's ring cost model:

  all-gather         (k-1)/k × result_bytes   gather_rows, rank_sum
  reduce-scatter     (k-1)   × result_bytes   sum_scatter (operand = k × result)
  all-reduce         2(k-1)/k × result_bytes  psum, pmax, pmin
  all-to-all         (k-1)/k × result_bytes   all_to_all
  collective-permute 1       × result_bytes   ring_shift
  broadcast          (k-1)/k × result_bytes   broadcast: a pipelined chain
                                              delivers the buffer to k-1
                                              ranks, (k-1)·B over k chips

k = the record's group size; a group of one moves nothing. Returns
per-chip bytes (the roofline divides total bytes by chips; per-chip ×
chips = total keeps both views).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, Mapping

#: the port's collective ops -> the HLO collective each stands for
OP_KINDS = {
    "gather_rows": "all-gather",
    "rank_sum": "all-gather",
    "sum_scatter": "reduce-scatter",
    "psum": "all-reduce",
    "pmax": "all-reduce",
    "pmin": "all-reduce",
    "all_to_all": "all-to-all",
    "ring_shift": "collective-permute",
    "broadcast": "broadcast",
}


def _kind(op: str) -> str:
    if op not in OP_KINDS:
        raise ValueError(f"unknown collective {op!r}; have {sorted(OP_KINDS)}")
    return OP_KINDS[op]


def result_bytes(kind: str, sent: float, k: int) -> float:
    """The bytes of the collective's result on one rank, from the bytes it
    was handed (``sent``) and its group size ``k``."""
    if kind == "all-gather":
        return sent * k
    if kind == "reduce-scatter":
        return sent / k
    return sent


def wire_bytes(kind: str, result: float, k: int) -> float:
    """Per-chip wire bytes of one collective under the ring model."""
    if k <= 1:
        return 0.0
    if kind == "reduce-scatter":
        return result * (k - 1)
    if kind == "all-reduce":
        return 2 * result * (k - 1) / k
    if kind == "collective-permute":
        return result
    return result * (k - 1) / k  # all-gather, all-to-all, broadcast


def collective_bytes(records: Iterable[Mapping], *,
                     default_group: int = 1) -> Dict[str, float]:
    """Per-chip collective wire bytes by HLO kind (+ 'total'). A record
    without ``group`` takes ``default_group``; its ``bytes`` are the total
    over its ``calls``."""
    out: Dict[str, float] = defaultdict(float)
    for r in records:
        kind = _kind(r["op"])
        k = int(r.get("group", default_group))
        wire = wire_bytes(kind, result_bytes(kind, float(r["bytes"]), k), k)
        if wire:
            out[kind] += wire
            out["total"] += wire
    return dict(out)


def collective_op_counts(records: Iterable[Mapping]) -> Dict[str, int]:
    """Calls by HLO kind (singleton groups included, as the reference
    counts every op of the program)."""
    counts: Dict[str, int] = defaultdict(int)
    for r in records:
        counts[_kind(r["op"])] += int(r.get("calls", 1))
    return dict(counts)
