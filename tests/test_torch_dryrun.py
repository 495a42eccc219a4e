"""The port's dry run (``repro_torch.launch.dryrun``), roofline
(``repro_torch.utils.roofline``) and collective accounting
(``repro_torch.utils.hlo``) against the reference's
(``repro.launch.dryrun``, ``repro.utils.roofline``, ``repro.utils.hlo``).

* The reference's arithmetic: ``model_flops_for``, ``cell_is_baseline_runnable``
  and ``_active_params`` (the reference's on ``jax.eval_shape`` of the
  init, the port's on a model built on "meta") equal for every arch × shape.
* ``build_report`` equals the reference's once the reference's peaks are
  the port's (``monkeypatch`` on its module globals); with every FLOP of
  one dtype the per-dtype compute term is the reference's.
* The ring cost model: each port op read as the HLO collective it stands
  for gives the reference parser's wire bytes, singleton groups included.
* The counts: a narrow dense and a narrow VLM train step counted on "meta"
  equal the same step counted on the CPU with real tensors, and a forward
  pass's product FLOPs equal the Σ 2·m·n·k written out here.
* ``--all`` at ``smoke_config`` widths (a train step of one microbatch):
  every cell on pod1 and pod2 is ``ok`` or a policy ``skip`` (a MoE or
  Mamba cell records the expert gather and the norm's partial sums), the
  enc-dec's too.

The collectives of the (data 2, model 4) step, held op by op against what
each of 8 gloo ranks records, are checked beside the spawn that makes them
(``tests/test_torch_tp.py::test_the_dry_run_reckons_every_ranks_collectives``).
"""
import dataclasses
import functools
import os

import pytest
import torch

from repro_torch.configs import ARCHS, SHAPES, smoke_config
from repro_torch.configs.base import ParallelConfig, ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.models.registry import build
from repro_torch.utils import hlo, roofline

DENSE_VLM = ("gemma2-2b", "granite-20b", "minitron-8b", "qwen2.5-32b",
             "phi-3-vision-4.2b")


def _reference_dryrun():
    """``repro.launch.dryrun`` imported without its 512 host devices: it sets
    XLA_FLAGS at import (before jax starts its backend); the flag is put
    back before any backend starts, so the tests keep one device."""
    before = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as ref
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return ref


@functools.lru_cache(maxsize=None)
def _reference_active(arch: str) -> int:
    import jax

    from repro.configs import ARCHS as RARCHS
    from repro.models import build as rbuild

    abstract = jax.eval_shape(rbuild(RARCHS[arch]).init, jax.random.PRNGKey(0))
    return _reference_dryrun()._active_params(RARCHS[arch], abstract)


@functools.lru_cache(maxsize=None)
def _port_active(arch: str) -> int:
    cfg = ARCHS[arch]
    return dryrun._active_params(cfg, dryrun._model(cfg, trainable=False, mesh=None))


# ------------------------------------------------------------ arithmetic
@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_the_reference_arithmetic(arch, shape):
    from repro.configs import ARCHS as RARCHS
    from repro.configs import SHAPES as RSHAPES
    from repro.utils.roofline import model_flops_for as ref_flops

    ref = _reference_dryrun()
    cfg, rcfg = ARCHS[arch], RARCHS[arch]
    assert _port_active(arch) == _reference_active(arch)
    assert dryrun.cell_is_baseline_runnable(cfg, SHAPES[shape]) == \
        ref.cell_is_baseline_runnable(rcfg, RSHAPES[shape])
    n = _port_active(arch)
    assert roofline.model_flops_for(cfg, SHAPES[shape], n_active=n) == \
        ref_flops(rcfg, RSHAPES[shape], n_active=n)
    assert roofline.model_flops_for(cfg, SHAPES[shape]) == \
        ref_flops(rcfg, RSHAPES[shape])


def test_build_report_equals_the_reference(monkeypatch):
    import repro.utils.roofline as rr

    monkeypatch.setattr(rr, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(rr, "HBM_BW", roofline.HBM_BW)
    monkeypatch.setattr(rr, "LINK_BW", roofline.LINK_BW)
    kw = dict(arch="gemma2-2b", shape="train_4k", mesh_name="pod1", chips=256,
              flops=3.1e17, hbm_bytes=2.2e15, collective_per_chip_bytes=4.4e10,
              model_flops=1.6e16, bytes_per_chip=8.3e9)
    want = dataclasses.asdict(rr.build_report(**kw))
    assert dataclasses.asdict(roofline.build_report(**kw)) == want
    # every FLOP bf16: the per-dtype term is the reference's one-peak term
    got = roofline.build_report(**kw, flops_by_dtype={"bfloat16": kw["flops"]})
    assert dataclasses.asdict(got) == want
    # f32 products read against the f32 peak, not bf16's
    f32 = roofline.build_report(**kw, flops_by_dtype={"float32": kw["flops"]})
    assert f32.compute_term_s == pytest.approx(
        kw["flops"] / (kw["chips"] * roofline.PEAK_FLOPS_BY_DTYPE["float32"]))
    # bytes over NVLink read at its rate
    link = roofline.build_report(**kw, collective_bytes_by_link={"nvlink": 4.4e10})
    assert link.collective_term_s == pytest.approx(4.4e10 / roofline.NVLINK_BW)


def test_the_roofline_holds_h100_peaks_and_no_tpu_constant():
    assert roofline.PEAK_FLOPS_BY_DTYPE == {"bfloat16": 989e12, "float16": 989e12,
                                            "tf32": 495e12, "float32": 67e12}
    assert roofline.HBM_BW == 3.35e12
    assert (roofline.NVLINK_BW, roofline.IB_BW) == (450e9, 50e9)
    for tpu in (197e12, 819e9):
        assert tpu not in vars(roofline).values()
    # the model axis (innermost, 16 ranks) spans two nodes; 8 stay in one
    assert roofline.link_for(16, 1) == "ib"
    assert roofline.link_for(8, 1) == "nvlink"
    assert roofline.link_for(2, 16) == "ib"


# ------------------------------------------------------- the ring model
_HLO = {
    "gather_rows": "%ag = f32[{r}]{{0}} all-gather(f32[{s}]{{0}} %x), "
                   "replica_groups={{{{{g}}}}}, dimensions={{0}}",
    "sum_scatter": "%rs = f32[{r}]{{0}} reduce-scatter(f32[{s}]{{0}} %x), "
                   "replica_groups={{{{{g}}}}}, dimensions={{0}}",
    "psum": "%ar = f32[{r}]{{0}} all-reduce(f32[{s}]{{0}} %x), "
            "replica_groups={{{{{g}}}}}",
    "all_to_all": "%aa = f32[{r}]{{0}} all-to-all(f32[{s}]{{0}} %x), "
                  "replica_groups={{{{{g}}}}}, dimensions={{0}}",
    "ring_shift": "%cp = f32[{r}]{{0}} collective-permute(f32[{s}]{{0}} %x), "
                  "source_target_pairs={{{{0,1}},{{1,0}}}}",
}


#: (op, group size): every kind at 2 and 8 ranks, and the kinds with a
#: replica group at one (a permute has none; a one-rank ring_shift sends
#: nothing)
RING_CASES = [(op, k) for op in sorted(_HLO) for k in (1, 2, 8)
              if not (op == "ring_shift" and k == 1)]


@pytest.mark.parametrize("op,k", RING_CASES)
def test_the_ring_model_equals_the_reference_parser(op, k):
    from repro.utils.hlo import collective_bytes as ref_bytes

    sent = 64 * k  # elements this rank hands in
    result = {"gather_rows": sent * k, "sum_scatter": sent // k}.get(op, sent)
    line = _HLO[op].format(r=result, s=sent, g=",".join(map(str, range(k))))
    want = ref_bytes(line)
    got = hlo.collective_bytes([{"op": op, "group": k, "calls": 1, "bytes": sent * 4}])
    assert got == want
    assert hlo.collective_op_counts([{"op": op, "group": k, "calls": 3,
                                      "bytes": sent * 12}]) == {hlo.OP_KINDS[op]: 3}


def test_broadcast_and_the_rank_sum_rows():
    # broadcast: a pipelined chain, (k-1)/k of the buffer a chip
    got = hlo.collective_bytes([{"op": "broadcast", "group": 4, "bytes": 1024}])
    assert got == {"broadcast": 768.0, "total": 768.0}
    # pmax / pmin read as the all-reduce; rank_sum as the all-gather it is
    assert hlo.collective_bytes([{"op": "pmax", "group": 4, "bytes": 400}]) == \
        hlo.collective_bytes([{"op": "psum", "group": 4, "bytes": 400}])
    assert hlo.collective_bytes([{"op": "rank_sum", "group": 4, "bytes": 400}]) == \
        hlo.collective_bytes([{"op": "gather_rows", "group": 4, "bytes": 400}])
    with pytest.raises(ValueError, match="unknown collective"):
        hlo.collective_bytes([{"op": "all_reduce_float", "group": 2, "bytes": 4}])


# ------------------------------------------------------------- the counts
@pytest.mark.parametrize("arch", ["gemma2-2b", "phi-3-vision-4.2b"])
def test_counts_on_meta_equal_the_cpu_with_real_tensors(arch):
    cfg = dataclasses.replace(smoke_config(ARCHS[arch]), n_layers=2)
    shape = ShapeConfig("t", 16, 4, "train")
    par = ParallelConfig(remat="block", microbatches=2)
    on_meta = dryrun.trace_step(cfg, shape, None, parallel=par)
    on_cpu = dryrun.trace_step(cfg, shape, None, parallel=par, device="cpu")
    assert on_meta["flops_by_dtype"] == on_cpu["flops_by_dtype"]
    assert on_meta["bytes"] == on_cpu["bytes"]
    assert on_meta["flops_by_dtype"]["bfloat16"] > 0 and on_meta["bytes"] > 0
    assert on_meta["peak_bytes"] > on_meta["start_bytes"] > 0


def test_product_flops_equal_the_analytic_count():
    """A forward pass of the smoke gemma2 (b 2, s 8, one attention chunk):
    per layer the q, k, v and out projections and the three MLP products
    in bf16, q·k in f32 and p·v in bf16 (the plain chunked attention),
    then the tied unembedding."""
    cfg = smoke_config(ARCHS["gemma2-2b"])
    b, s = 2, 8
    bundle = build(cfg)
    model = dryrun._model(cfg, trainable=True, mesh=None)
    trace = dryrun.StepTrace()
    with trace, torch.no_grad():
        bundle.forward(model, {"tokens": torch.zeros((b, s), dtype=torch.int64,
                                                     device="meta")}, impl="ref")
    d, hq, hkv, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                          cfg.d_ff)
    t = b * s
    layer = (2 * t * d * hq * hd + 2 * 2 * t * d * hkv * hd + 2 * t * hq * hd * d
             + 3 * 2 * t * d * ff)
    attn = 2 * b * hq * s * s * hd
    want = {"bfloat16": cfg.n_layers * (layer + attn) + 2 * t * d * cfg.padded_vocab_size,
            "float32": cfg.n_layers * attn}
    assert trace.summary()["flops_by_dtype"] == want


def test_kernel_wrappers_reckon_on_meta():
    """On a meta tensor each wrapper returns its kernel's output shapes and
    reports its work; no launch is counted."""
    from repro_torch import kernels
    from repro_torch.kernels import fused_assign, knn_topk, pairwise_l2, segment_sum
    from repro_torch.kernels import flash_attention as fa

    meta = torch.device("meta")
    kernels.reset_launch_counts()
    got = []
    with dryrun.kernel_meta.reckoning(lambda *a: got.append(a)):
        q = torch.empty((4, 8, 128, 64), dtype=torch.bfloat16, device=meta)
        k = torch.empty((4, 2, 256, 64), dtype=torch.bfloat16, device=meta)
        out = fa.flash_attention(q, k, k)
        assert out.shape == q.shape and out.dtype == torch.bfloat16
        x = torch.empty((100, 6), device=meta)
        d, i = fused_assign.fused_topk(x, x, 2)
        assert d.shape == (100, 2) and i.dtype == torch.int32
        d, i = knn_topk.knn_topk(x, 1)
        assert d.shape == (100, 1)
        ids = torch.empty((100,), dtype=torch.int32, device=meta)
        sums, mass = segment_sum.blocked_segment_sum(x, ids, 7, n_blocks=8)
        assert sums.shape == (7, 6) and mass.shape == (7,)
        assert pairwise_l2.pairwise_sq_l2(x, x[:3]).shape == (100, 3)
    assert [g[:2] for g in got] == [("K5", "tiled_mma"), ("K1", "tc3xtf32"),
                                    ("K2", "tc3xtf32"), ("K3", "few"),
                                    ("K4", "small_m")]
    pairs = 4 * 8 * (128 * 129 + 128 * 127 / 2)  # causal, lq 128 at the end of lk 256
    assert got[0][2] == {"bfloat16": pairs * 6 * 64, "float32": pairs * 8}
    assert not any(kernels.launch_counts().values())


# ------------------------------------------------------------ every cell
@pytest.mark.parametrize("mesh", ["pod1", "pod2"])
def test_every_cell_at_smoke_widths(mesh):
    statuses = {}
    for arch in sorted(ARCHS):
        for shape in sorted(SHAPES):
            # one microbatch (the policy's 8 repeat the same ops 8 times)
            par = (ParallelConfig(remat="block", microbatches=1)
                   if SHAPES[shape].kind == "train" else None)
            res = dryrun.run_cell(arch, shape, mesh, verbose=False, parallel=par,
                                  cfg_override=smoke_config(ARCHS[arch]))
            statuses[(arch, shape)] = res["status"]
            family = ARCHS[arch].family
            if res["status"] == "skip":  # the 500k policy comes first
                assert shape == "long_500k" and family not in ("ssm", "hybrid")
            else:
                assert arch in DENSE_VLM or family in ("moe", "ssm", "hybrid",
                                                       "encdec-audio")
                assert res["status"] == "ok", res
                r = res["roofline"]
                assert r["chips"] == (256 if mesh == "pod1" else 512)
                assert 0 < r["mfu_bound"] <= 1 and r["compute_term_s"] > 0
                assert res["cost_method"].startswith("direct")
                # every model-axis exchange is a gather (rank_sum, the
                # experts' outputs, a replicated module's weights)
                assert res["collectives"]["calls"]["gather_rows"]["calls"] > 0
    # dense and VLM 5 x 3, deepseek and llama4-scout 2 x 3, mamba2 and jamba
    # 2 x 4, the enc-dec 1 x 3
    assert sum(s == "ok" for s in statuses.values()) == 15 + 6 + 8 + 3
