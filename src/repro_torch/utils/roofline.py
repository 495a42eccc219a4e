"""Roofline terms of a traced step — the port of ``repro.utils.roofline``.

Hardware model: one NVIDIA H100 SXM card, from NVIDIA's data sheet
(dense, no sparsity):

  tensor cores  989·10¹² FLOP/s bf16 (and f16), 495·10¹² tf32;
  CUDA cores     67·10¹² FLOP/s f32;
  HBM3          3.35·10¹² B/s;
  links         NVLink 4 within a node of eight cards, 450·10⁹ B/s a card
                each way (900 GB/s both ways); InfiniBand NDR across
                nodes, 400 Gb/s = 50·10⁹ B/s a card.

  compute_term    = Σ_dtype flops_dtype / (chips × PEAK_FLOPS_BY_DTYPE[dtype])
  memory_term     = bytes               / (chips × HBM_BW)
  collective_term = Σ_link per-chip wire bytes on that link / its rate

These are data-sheet peaks: a term built from them is a reckoning, not a
measurement. FLOPs come by the operand type of each product (the port's
products run in ``COMPUTE_DTYPE = torch.bfloat16``, some stay f32), so an
f32 step is not read against the bf16 peak; with every FLOP of one type
the compute term is the reference's ``flops / (chips × PEAK)``.

The link of a collective: a group of k ranks whose stride in the mesh (the
product of the sizes of the dimensions inside it, row-major) is s spans
k·s consecutive ranks, and stays on NVLink when k·s ≤ CARDS_PER_NODE
(nodes of eight consecutive ranks), else it crosses nodes over
InfiniBand. ``launch.mesh``'s production meshes put "model" innermost, so
its 16 ranks span two nodes; the data groups (stride 16) span sixteen.

MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) for a train step, 2·N·D
for a prefill or a decode step, D = tokens the step processes; the
MODEL/counted ratio flags remat- or dispatch-inflated compute. The MFU
bound reads the model FLOPs against the bf16 peak, as the reference reads
them against its one peak.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional

#: FLOP/s a card by operand type (dense, data sheet)
PEAK_FLOPS_BY_DTYPE = {
    "bfloat16": 989e12,
    "float16": 989e12,
    "tf32": 495e12,
    "float32": 67e12,
}
PEAK_FLOPS = PEAK_FLOPS_BY_DTYPE["bfloat16"]   # the MFU's peak
HBM_BW = 3.35e12          # B/s a card
NVLINK_BW = 450e9         # B/s a card, each way, within a node
IB_BW = 50e9              # B/s a card across nodes (NDR, 400 Gb/s)
LINK_BW = IB_BW           # one link for bytes whose groups are not known
CARDS_PER_NODE = 8

LINKS = {"nvlink": NVLINK_BW, "ib": IB_BW}


def link_for(group: int, stride: int = 1) -> str:
    """"nvlink" when a group of ``group`` ranks ``stride`` apart lies in
    one node of CARDS_PER_NODE consecutive ranks, else "ib"."""
    return "nvlink" if group * stride <= CARDS_PER_NODE else "ib"


def compute_seconds(flops_by_dtype: Mapping[str, float], chips: int = 1) -> float:
    """Σ flops_dtype / (chips × peak_dtype); an unknown type raises."""
    unknown = sorted(set(flops_by_dtype) - set(PEAK_FLOPS_BY_DTYPE))
    if unknown:
        raise ValueError(f"no peak for operand types {unknown}; have "
                         f"{sorted(PEAK_FLOPS_BY_DTYPE)}")
    return sum(f / (chips * PEAK_FLOPS_BY_DTYPE[t]) for t, f in flops_by_dtype.items())


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_gflops: float          # counted FLOPs, total across chips
    hlo_gbytes: float
    collective_gbytes: float   # per-chip wire bytes × chips
    compute_term_s: float
    memory_term_s: float
    collective_term_s: float
    dominant: str
    model_gflops: float
    useful_ratio: float        # MODEL_FLOPS / counted FLOPs
    bytes_per_chip_gb: float   # peak live memory a chip
    step_time_bound_s: float   # max of the three terms
    mfu_bound: float           # model_flops / (chips·peak·step_time_bound)

    def row(self) -> str:
        return (
            f"| {self.arch} | {self.shape} | {self.mesh} | "
            f"{self.compute_term_s:.2e} | {self.memory_term_s:.2e} | "
            f"{self.collective_term_s:.2e} | {self.dominant} | "
            f"{self.useful_ratio:.2f} | {self.mfu_bound*100:.1f}% | "
            f"{self.bytes_per_chip_gb:.2f} |"
        )


def build_report(
    *,
    arch: str,
    shape: str,
    mesh_name: str,
    chips: int,
    flops: float,
    hbm_bytes: float,
    collective_per_chip_bytes: float,
    model_flops: float,
    bytes_per_chip: float,
    flops_by_dtype: Optional[Mapping[str, float]] = None,
    collective_bytes_by_link: Optional[Mapping[str, float]] = None,
) -> RooflineReport:
    """The reference's report. ``flops_by_dtype`` (totals across chips,
    summing to ``flops``) sets the compute term per operand type; without
    it every FLOP is read at the bf16 peak, the reference's one peak.
    ``collective_bytes_by_link`` (per-chip wire bytes by :data:`LINKS`
    key) sets the collective term per link; without it every byte crosses
    :data:`LINK_BW`."""
    by_dtype: Dict[str, float] = dict(flops_by_dtype or {"bfloat16": flops})
    compute_term = compute_seconds(by_dtype, chips)
    memory_term = hbm_bytes / (chips * HBM_BW)
    if collective_bytes_by_link is None:
        collective_term = collective_per_chip_bytes / LINK_BW
    else:
        collective_term = sum(b / LINKS[k] for k, b in collective_bytes_by_link.items())
    terms = {
        "compute": compute_term,
        "memory": memory_term,
        "collective": collective_term,
    }
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    mfu = (model_flops / (chips * PEAK_FLOPS * bound)) if bound > 0 else 0.0
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_gflops=flops / 1e9, hlo_gbytes=hbm_bytes / 1e9,
        collective_gbytes=collective_per_chip_bytes * chips / 1e9,
        compute_term_s=compute_term, memory_term_s=memory_term,
        collective_term_s=collective_term, dominant=dominant,
        model_gflops=model_flops / 1e9,
        useful_ratio=(model_flops / flops) if flops else 0.0,
        bytes_per_chip_gb=bytes_per_chip / 1e9,
        step_time_bound_s=bound, mfu_bound=mfu,
    )


def model_flops_for(cfg, shape, n_active: Optional[int] = None) -> float:
    """6·N_active·D with D = tokens processed by the traced step."""
    n = n_active if n_active is not None else cfg.active_param_count()
    if shape.kind == "decode":
        d = shape.global_batch * 1
        return 2.0 * n * d  # inference fwd only
    d = shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * d
    return 6.0 * n * d  # train: fwd + bwd
