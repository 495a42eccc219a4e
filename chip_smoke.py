#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU and check it.

    python3 chip_smoke.py                      # every phase (the full check)
    python3 chip_smoke.py --phases device,build,kernels

Phases, each printing one JSON line:

  device       the card, from nvidia-smi (its raw line is printed too);
  build        compile the CUDA kernels (csrc/*.cu, one nvcc each, in
               parallel) into build/repro_torch/;
  kernels      every kernel against its plain PyTorch version on the card,
               at the shapes the main path gives it: error within the
               stated tolerance, indices equal except at distance near-ties,
               and times (CUDA events, median of 10 after a warm-up; the
               plain version at the fit's largest K1 shape, one call); then
               awkward shapes on a dyadic grid, where kernel and plain
               version must agree bit for bit, tie-breaking included;
  fit          the main path: repro_torch.fit on a covertype-sized
               Gaussian-mixture analog (n = 581,012, d = 6, 7 components,
               standardized), t = 3, m = 5, k-means k = 7;
  serve        the main path, continued: ClusterIndex.build on that fit,
               ClusterService with buckets (32, 128, 512, 2048), requests of
               1, 100, 2048 and 5000 points, held against the plain path;
  headline     the paper's GMM at n = 1,000,000, t = 2, m = 3, k = 3:
               accuracy must be >= 0.90;
  determinism  n = 65,536: the kernel path twice (bitwise equal labels) and
               the plain path once (label agreement >= 0.999);
  online       the online loop: a 10,485,760-point blobs stream (d = 6, 7
               blobs, 80 chunks of 131,072) folded by an OnlineFitter
               (t = 3, m = 4, k-means k = 7, prefetch depth 2), its snapshot
               packed into an index, saved to and loaded from an
               IndexStore, served by an AsyncClusterService on an asyncio
               loop under fused, fused_bf16 and fused_int8 (requests of 1,
               100, 2048, 5000 points), then a RefreshDriver folding a
               drifted stream refreshes once under live traffic (snapshot,
               pack, save, warmup, hot-swap); the fit's prototypes,
               clustered under 16 k-means seedings, must match the
               generating blobs (accuracy >= 0.97); then a determinism
               check on the first 8 chunks (prefetch depth 0 vs 2 bitwise,
               kernel path vs plain path level-0 maps agreement >= 0.999,
               both paths' prototypes as above, lowest inertias within
               5 %);
  lm           the LM serving path at the full gemma2-2b config (random
               weights from a seeded generator): ServeEngine.generate with
               batch 4, prompt 2048, 160 new tokens, IHTC KV compression
               t = 2, m = 1, tail 128 (one in-flight recompression); then the
               kernel path against two plain paths (prefill, compress, 8
               teacher-forced decode steps), the same arithmetic (K5's
               plain version) and the reference's chunked route, within
               LOGIT_ULPS, with a planted fault (K5's bias dropped for one
               step) that must exceed it; then a second
               kernel-path run (bitwise equal tokens);
  profile      (only when asked for) the fit, the headline fit, (after
               the lm phase) one generate and (after the online phase) the
               stream's first 16 chunks again under torch.profiler: kernel
               time by name and the device busy share;
  basins       (only when asked for) which k-means optimum the kernel and
               the plain path reach on the online stream's first 8 chunks,
               under 6 keys and on data scaled by 1 + 2^-22; then k-means
               alone on each path's prototypes under 12 keys.

The kernel launch counts are set to 0 just before the fit and read after
the fit and after the serve phase, set to 0 again just before the online
phase's stream and read after its refresh, and again just before the lm
phase's generate and read right after it; every kernel of each path must
have launched (K1-K4 in fit and serve; K1 and its bf16 and int8 key
instances, K3 and K4 in online; K2, K3 and K5 in lm, K5 once per
global layer of the prefill and once per layer of every decode step).
Then one JSON line lists every kernel and variant (launches summed over
the paths),
the card's name and power limit are printed, and the last line is
``{"ok": true, "device": {...}}``. Any
failure raises and the script exits nonzero without that line; so does a
machine without a GPU, or a directory without the repository's ``src/``.
It imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DEFAULT_PHASES = ("device", "build", "kernels", "fit", "serve", "headline",
                  "determinism", "online", "lm")
#: "profile" (not run by default): the fit and the headline fit once more
#: under torch.profiler — device time by kernel and the device's busy share
ALL_PHASES = DEFAULT_PHASES + ("profile", "basins")

# H100 SXM published peaks (NVIDIA data sheet, dense): f32 on the CUDA
# cores, bf16 on the tensor cores (f32 accumulation), HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# distance tolerance, kernel vs plain version, both f32 on the card: they
# round |x|²+|y|²−2x·y in other orders (sequential fma vs cuBLAS and
# torch.sum), a few ulps of values up to ~100 on standardized data
DIST_TOL = dict(rtol=1e-5, atol=1e-4)
# segment sums: the plain version uses float atomics (any order) on the card
SUM_TOL = dict(rtol=1e-5, atol=1e-4)
# attention, kernel vs plain version: both fold in f32 (online vs dense
# softmax, sums over up to 2208 keys in other orders); in bf16 both round
# the output once, so they may land one bf16 ulp (2^-7 relative) apart
ATTN_TOL_F32 = dict(rtol=1e-5, atol=3e-5)
ATTN_TOL_BF16 = dict(rtol=2 ** -7, atol=1e-5)
# LM logits, the kernel path against two plain paths, each compressing its
# own cache: the same arithmetic (K5's plain version, f32 probabilities
# times v; plain K2/K3) and the reference's "xla" route (chunked attention,
# bf16 P·V products; plain K2/K3). Both within LOGIT_ULPS bf16 ulps of the
# largest |logit|, top-1 agreement >= 0.9: the route bound
# tests/test_torch_lm.py states, and on the card the readings of PERF.md
# section 2 (at most 23.3 ulps on either path) stay below it, while one
# decode step with K5's bias dropped (72 ulps) must exceed it
LOGIT_ULPS, MIN_TOP1 = 32, 0.9
# compressed caches, kernel vs plain compression of one cache: prototype
# slots within one bf16 ulp; TC may split a distance near-tie another way,
# which moves a few clusters, so >= 0.999 of the slots must agree
MIN_SLOT_AGREEMENT = 0.999

#: where the script runs and at what sizes (the main path's; a rehearsal
#: elsewhere may shrink them)
DEV = "cuda"
SIZES = dict(covertype=581_012, segments=193_670, blocked_q=8192,
             assign_q=2048, protos=2390, knn_n=7172, centres=7,
             gmm=1_000_000, det=65_536)
#: the lm phase: gemma2-2b served at batch 4, prompt 2048, 160 new tokens,
#: compressed at t = 2, m = 1 with a 128-slot tail (cache 2208 slots, 1232
#: after the first compress), 8 teacher-forced steps in the parity check
LM = dict(arch="gemma2-2b", batch=4, prompt=2048, new_tokens=160, t=2, m=1,
          tail=128, forced_steps=8)
#: the online phase: the blobs stream, its fit, the serve ladder and
#: request sizes, the refresh (a drifted stream: the shift of
#: benchmarks/bench_lifecycle.py), the open-loop traffic around it, and the
#: stand-in final index (its buffer rows) of the kernels phase's K1-variant
#: rows, which the online phase measures again on the real index
ONLINE = dict(n=10_485_760, d=6, k=7, chunk=131_072, t=3, m=4, depth=2,
              buckets=(32, 128, 512, 2048), sizes=(1, 100, 2048, 5000),
              reps={1: 40, 100: 40, 2048: 20, 5000: 20},
              refresh_points=1_048_576, drift_shift=6.0, qps=100.0,
              traffic_s=3.0, det_chunks=8, protos=5393, shortlist=8,
              basin_keys=6)
#: quantized vs exact labels, and kernel path vs plain path, both online
MIN_QUANT_AGREEMENT = 0.999
#: the online fits' quality, with the k-means seeding taken out: each fit's
#: final prototypes are clustered under SEED_RESTARTS keys and the lowest
#: inertia kept (one seeding lands the blob mixture in a worse optimum for
#: about half of all keys, on either path). Its labels must match the
#: generating blobs on >= MIN_BLOB_ACCURACY of the points (readings
#: 0.982-0.989 in the best optimum, the 80-chunk fit lowest, and at most
#: 0.792 in the others; PERF.md, PR 13), and the kernel path's lowest
#: inertia must lie within MAX_INERTIA_GAP of the plain path's (reading
#: -1.3 %; the next optimum is 27 % higher)
SEED_RESTARTS = 16
MIN_BLOB_ACCURACY = 0.97
MAX_INERTIA_GAP = 0.05

KERNEL_META = {
    "K1": ("fused_topk", "src/repro_torch/csrc/topk.cu",
           "src/repro/kernels/fused_assign.py:61"),
    "K2": ("knn_topk", "src/repro_torch/csrc/topk.cu",
           "src/repro/kernels/knn_topk.py:25"),
    "K3": ("segment_sum", "src/repro_torch/csrc/segment_sum.cu",
           "src/repro/kernels/segment_sum.py:20"),
    "K4": ("pairwise_sq_l2", "src/repro_torch/csrc/pairwise_l2.cu",
           "src/repro/kernels/pairwise_l2.py:22"),
    "K5": ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
           "src/repro/kernels/flash_attention.py:23"),
    "K1-bf16": ("fused_topk_bf16", "src/repro_torch/csrc/topk.cu",
                "src/repro/kernels/fused_assign.py:61"),
    "K1-int8": ("fused_topk_int8", "src/repro_torch/csrc/topk.cu",
                "src/repro/kernels/fused_assign.py:61"),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def sync() -> None:
    torch.cuda.synchronize()


def dev(a) -> torch.Tensor:
    return torch.as_tensor(a).to(DEV)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` between CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    sync()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops: float, nbytes: float, bf16_flops: float = 0.0):
    """(bound_ms, bound_by): the larger of the operations' time (``flops``
    at the f32 peak plus ``bf16_flops``, products of bf16 operands, at the
    bf16 tensor-core peak) and bytes at the memory rate."""
    t_ops = flops / PEAK_F32_FLOPS + bf16_flops / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def topk_mismatches(q, keys, got_d, got_i, ref_d, ref_i):
    """(index mismatches, of which not near-ties). A mismatch is a near-tie
    when the distance of the kernel's pick, recomputed in float64, is
    within DIST_TOL of the plain version's distance at that slot."""
    mism = (got_i != ref_i).nonzero()
    if mism.numel() == 0:
        return 0, 0
    r, s = mism[:, 0], mism[:, 1]
    gi = got_i[r, s].long()
    qd = q[r].double()
    kd = keys[gi.clamp_min(0)].double()
    true_d = ((qd - kd) ** 2).sum(1)
    ok = (gi >= 0) & torch.isclose(true_d, ref_d[r, s].double(),
                                   rtol=DIST_TOL["rtol"], atol=DIST_TOL["atol"])
    return int(mism.shape[0]), int((~ok).sum())


# ---------------------------------------------------------------- phases


def phase_device() -> dict:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    line = out.stdout.strip().splitlines()[0]
    print(line, flush=True)
    info = {"name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": line,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit("device", **info)
    return info


def phase_build() -> None:
    from repro_torch.kernels import _cuda

    t0 = time.perf_counter()
    compile_s = _cuda.build_all()
    for name in _cuda.SOURCES:
        _cuda.library(name)
    spills = {}
    for name in _cuda.SOURCES:
        log = _cuda.library_path(name).with_suffix(".log")
        text = log.read_text() if log.exists() else ""
        # ptxas -v: "... N bytes spill stores, M bytes spill loads" per function
        spills[name] = sum(int(v) > 0 for v in
                           re.findall(r"(\d+) bytes spill stores", text))
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         compile_seconds=round(compile_s, 3),
         functions_with_spills=spills)
    # registers and spills of the any-d top-k kernel (each key type) and of
    # K5, per instance
    for name, marker in (("topk", "topk_chunked_kernel"),
                         ("topk_bf16", "topk_chunked_kernel"),
                         ("topk_int8", "topk_chunked_kernel"),
                         ("flash_attention", "flash_kernel")):
        text = _cuda.library_path(name).with_suffix(".log").read_text()
        emit("ptxas", library=name, functions=_ptxas_usage(text, marker))


def _ptxas_usage(log: str, marker: str) -> list:
    """(mangled name, registers, spill store bytes) of each entry function
    whose name holds ``marker``, from ``ptxas -v`` output."""
    out = []
    for block in log.split("Compiling entry function '")[1:]:
        fn = block.split("'", 1)[0]
        if marker not in fn:
            continue
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        out.append({"function": fn, "registers": int(regs.group(1)) if regs else None,
                    "spill_store_bytes": int(spill.group(1)) if spill else None})
    return out


def _analog(n: int, seed: int = 0):
    """(standardized covertype analog (n, 6) on the device, components)."""
    from repro_torch.core.prototypes import standardize
    from repro_torch.data import PAPER_DATASETS, dataset_analog

    spec = next(s for s in PAPER_DATASETS if s.name == "covertype")
    x, comp = dataset_analog(spec, seed=seed, max_n=n, return_components=True)
    return standardize(dev(x)), comp


def phase_kernels(results: dict) -> None:
    from repro_torch.kernels import fused_assign, knn_topk, ops, ref
    from repro_torch.kernels import pairwise_l2 as pw

    t0 = time.perf_counter()
    gen = np.random.default_rng(1)
    x, _ = _analog(SIZES["covertype"])
    bq, aq, npro = SIZES["blocked_q"], SIZES["assign_q"], SIZES["protos"]

    # K1 at the shapes the main path gives it. Level 0 of the fit launches
    # it with one 8192-row query block against all 581,632 rows of the
    # padded key set (pad rows invalid, self-excluded through q_gidx): take
    # a block from the middle, k = t - 1 = 2. That case dominates the fit;
    # its plain version, seconds a call, is timed on one call. Then 8192
    # queries against 8192 keys (k = 1, 2), and the assign shape (2048
    # queries against 2390 prototypes, k = 1).
    n_all = x.shape[0]
    n_pad = -(-n_all // bq) * bq
    xp = torch.nn.functional.pad(x, (0, 0, 0, n_pad - n_all))
    vp = torch.arange(n_pad, device=DEV) < n_all
    q0 = (n_pad // bq // 2) * bq
    mid_gidx = torch.arange(q0, q0 + bq, dtype=torch.int32, device=DEV)
    cases = [(xp[q0:q0 + bq], xp, vp, mid_gidx, 2, 1)]
    for nq, p, k, self_excl in ((bq, bq, 1, True), (bq, bq, 2, True),
                                (aq, npro, 1, False)):
        keys = x[:p].contiguous() if self_excl else x[-p:].contiguous()
        gidx = (torch.arange(nq, dtype=torch.int32, device=DEV)
                if self_excl else None)
        cases.append((x[:nq].contiguous(), keys, dev(gen.random(p) > 0.05),
                      gidx, k, 10))
    for q, keys, valid, gidx, k, plain_reps in cases:
        nq, p = q.shape[0], keys.shape[0]
        gd, gi = fused_assign.fused_topk(q, keys, k, valid, q_gidx=gidx)
        rd, ri = fused_assign.fused_topk_plain(q, keys, k, valid, q_gidx=gidx)
        sync()
        err = float((gd - rd).abs().max())
        mism, bad = topk_mismatches(q, keys, gd, gi, rd, ri)
        check(torch.allclose(gd, rd, **DIST_TOL), f"K1 distances off: {err}")
        check(bad == 0, f"K1: {bad} index mismatches that are not near-ties")
        ms = cuda_ms(lambda: fused_assign.fused_topk(q, keys, k, valid, q_gidx=gidx))
        plain = cuda_ms(lambda: fused_assign.fused_topk_plain(
            q, keys, k, valid, q_gidx=gidx), reps=plain_reps,
            warmup=2 if plain_reps > 1 else 0)
        # per pair: 6 fma of the cross term + add, subtract, max; bytes:
        # queries, keys, valid, q_gidx in; distances and indices out
        b_ms, b_by = bound(nq * p * (2 * 6 + 3),
                           (nq + p) * 6 * 4 + p + (0 if gidx is None else nq * 4)
                           + nq * k * 8)
        row = dict(kernel="K1", nq=nq, p=p, d=6, k=k, max_abs_err=err,
                   index_mismatches=mism, ms=ms, plain_ms=plain,
                   plain_reps=plain_reps, bound_ms=b_ms, bound_by=b_by,
                   library_ms=None)
        emit("kernels", **row)
        results.setdefault("K1", row)

    _k1_variants(results, *_standin_index())

    # K2: the one-shot TC graph (level 4 of the fit: 7172 rows, under the
    # 8192-row blocking threshold)
    n, k = SIZES["knn_n"], 2
    xs = x[:n].contiguous()
    gd, gi = knn_topk.knn_topk(xs, k)
    rd, ri = ref.knn(xs, k)
    sync()
    err = float((gd - rd).abs().max())
    mism, bad = topk_mismatches(xs, xs, gd, gi, rd, ri)
    check(torch.allclose(gd, rd, **DIST_TOL), f"K2 distances off: {err}")
    check(bad == 0, f"K2: {bad} index mismatches that are not near-ties")
    ms = cuda_ms(lambda: knn_topk.knn_topk(xs, k))
    plain = cuda_ms(lambda: ref.knn(xs, k))
    b_ms, b_by = bound(n * n * (2 * 6 + 3), n * 6 * 4 + n * k * 8)
    emit("kernels", kernel="K2", path="fit", n=n, d=6, k=k, max_abs_err=err,
         index_mismatches=mism, ms=ms, plain_ms=plain, bound_ms=b_ms,
         bound_by=b_by, library_ms=None)
    _k2_compression(results)

    # K3: the level-0 prototype reduce, 8 blocks of 72,627 rows into
    # 193,670 segments (ids include dropped ones)
    n, S = x.shape[0], SIZES["segments"]
    ids = dev(gen.integers(-1, S, size=n).astype(np.int32))
    w = dev(gen.integers(1, 4, size=n).astype(np.float32))
    gs, gm = ops.blocked_segment_sum(x, ids, S, weights=w, impl="cuda")
    rs, rm = ops.blocked_segment_sum(x, ids, S, weights=w, impl="ref")
    sync()
    err = max(float((gs - rs).abs().max()), float((gm - rm).abs().max()))
    check(torch.allclose(gs, rs, **SUM_TOL) and torch.allclose(gm, rm, **SUM_TOL),
          f"K3 sums off: {err}")
    # the plain version on the CPU folds each segment in row order, as the
    # kernel does: are the bits equal?
    cs, cm = ops.blocked_segment_sum(x.cpu(), ids.cpu(), S, weights=w.cpu(),
                                     impl="ref")
    bit_equal = bool(torch.equal(gs.cpu(), cs) and torch.equal(gm.cpu(), cm))
    ms = cuda_ms(lambda: ops.blocked_segment_sum(x, ids, S, weights=w, impl="cuda"))
    plain = cuda_ms(lambda: ops.blocked_segment_sum(x, ids, S, weights=w, impl="ref"))
    keep = (ids >= 0) & (ids < S)
    lib_ids = torch.where(keep, ids, S)
    src = torch.cat([x * w[:, None], w[:, None]], dim=1).contiguous()
    lib_out = torch.zeros((S + 1, 7), device=DEV)
    library = cuda_ms(lambda: lib_out.index_add_(0, lib_ids, src))
    # per row: d products and d + 1 sums; bytes: x, i32 ids, weights in,
    # (S, d) sums and (S,) masses out
    b_ms, b_by = bound(n * (2 * 6 + 1), n * 6 * 4 + n * 4 + n * 4 + S * 7 * 4)
    results["K3"] = dict(kernel="K3", n=n, d=6, segments=S, blocks=8,
                         max_abs_err=err, bit_equal_to_cpu_plain=bit_equal,
                         ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                         library_ms=library)
    emit("kernels", **results["K3"])

    # K4: k-means++/Lloyd distances, 2390 prototypes against 7 centres
    n, m = npro, SIZES["centres"]
    xs = x[:n].contiguous()
    cs_ = x[n:n + m].contiguous()
    got = pw.pairwise_sq_l2(xs, cs_)
    want = ref.pairwise_sq_l2(xs, cs_)
    sync()
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, **DIST_TOL), f"K4 distances off: {err}")
    ms = cuda_ms(lambda: pw.pairwise_sq_l2(xs, cs_))
    plain = cuda_ms(lambda: ref.pairwise_sq_l2(xs, cs_))
    b_ms, b_by = bound(n * m * (2 * 6 + 3) + 2 * (n + m) * 6,
                       (n + m) * 6 * 4 + n * m * 4)
    results["K4"] = dict(kernel="K4", n=n, m=m, d=6, max_abs_err=err, ms=ms,
                         plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                         library_ms=None)
    emit("kernels", **results["K4"])
    _k3_compression()
    _k5_path_shapes(results)
    _edge_checks(gen)
    _attention_edges()
    emit("kernels_done", seconds=round(time.perf_counter() - t0, 3))


def _standin_index():
    """(protos, valid, queries) shaped as the online phase's final index and
    its largest request: ONLINE["protos"] rows from the blobs stream, 5000
    queries from later in it."""
    from repro_torch.data import PointStreamConfig, point_chunk

    cfg = PointStreamConfig(n=ONLINE["n"], d=ONLINE["d"], chunk=ONLINE["chunk"],
                            seed=0, kind="blobs", k=ONLINE["k"])
    protos = dev(point_chunk(cfg, 0)[:ONLINE["protos"]])
    valid = torch.ones(protos.shape[0], dtype=torch.bool, device=DEV)
    queries = dev(point_chunk(cfg, 1)[:max(ONLINE["sizes"])])
    return protos, valid, queries


def _k1_variants(results: dict, protos, valid, queries, path="kernels") -> None:
    """K1's bf16 and int8 key instances at the serve shape (the largest
    request against the final index, the k = 8 shortlist), each against
    its plain version on the same packed buffer: distances within
    DIST_TOL, indices equal except at near-ties."""
    from repro_torch.kernels import fused_assign as fa

    nq, p, d, k = queries.shape[0], protos.shape[0], protos.shape[1], ONLINE["shortlist"]
    q8, scale, zero = fa.quantize_keys(protos, valid)
    cases = {
        "K1-bf16": (queries.bfloat16(), protos.bfloat16(), {}, 2, 2),
        "K1-int8": (queries, q8, dict(keys_scale=scale, keys_zero=zero), 4, 1),
    }
    for kid, (q, keys, kw, q_bytes, k_bytes) in cases.items():
        gd, gi = fa.fused_topk(q, keys, k, valid, **kw)
        rd, ri = fa.fused_topk_plain(q, keys, k, valid, **kw)
        sync()
        err = float((gd - rd).abs().max())
        # near-ties judged on the keys as the kernel sees them (widened or
        # dequantized), in float64
        keys_f = (keys.float() * scale + zero) if kw else keys.float()
        mism, bad = topk_mismatches(q.float(), keys_f, gd, gi, rd, ri)
        check(torch.allclose(gd, rd, **DIST_TOL), f"{kid} distances off: {err}")
        check(bad == 0, f"{kid}: {bad} index mismatches that are not near-ties")
        ms = cuda_ms(lambda: fa.fused_topk(q, keys, k, valid, **kw))
        plain = cuda_ms(lambda: fa.fused_topk_plain(q, keys, k, valid, **kw))
        # operations as for K1 f32 (the widening or dequantization is per
        # key element, not per pair); bytes: keys at their width, queries,
        # valid, scale and zero in, distances and indices out
        b_ms, b_by = bound(nq * p * (2 * d + 3),
                           p * d * k_bytes + nq * d * q_bytes + p
                           + (2 * d * 4 if kw else 0) + nq * k * 8)
        row = dict(kernel=kid, path=path, nq=nq, p=p, d=d, k=k, max_abs_err=err,
                   index_mismatches=mism, ms=ms, plain_ms=plain, bound_ms=b_ms,
                   bound_by=b_by, library_ms=None)
        emit("kernels", **row)
        results[kid] = row


def _head_keys(n: int, d: int, seed: int) -> torch.Tensor:
    """(n, d) f32 keys as one KV head holds them: bf16 values."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    return torch.randn((n, d), generator=g, device=DEV).bfloat16().float()


def _k2_compression(results: dict) -> None:
    """K2 at the lm phase's compression shape: one (batch, kv-head) cache
    of 2208 slots of width head_dim = 256, the first 2048 written (valid),
    k = t - 1 = 1. This is K2's entry in the kernels line."""
    from repro_torch.kernels import knn_topk, ref

    n, d, k = LM["prompt"] + LM["new_tokens"], 256, LM["t"] - 1
    x = _head_keys(n, d, 3)
    valid = torch.arange(n, device=DEV) < LM["prompt"]
    gd, gi = knn_topk.knn_topk(x, k, valid)
    rd, ri = ref.knn(x, k, valid=valid)
    sync()
    ok = torch.isfinite(rd)
    err = float((gd[ok] - rd[ok]).abs().max())
    mism, bad = topk_mismatches(x, x, gd, gi, rd, ri)
    check(torch.equal(torch.isfinite(gd), ok), "K2 (d 256): filled slots differ")
    check(torch.allclose(gd[ok], rd[ok], rtol=1e-5, atol=1e-3),
          f"K2 (d 256) distances off: {err}")
    check(bad == 0, f"K2 (d 256): {bad} index mismatches that are not near-ties")
    ms = cuda_ms(lambda: knn_topk.knn_topk(x, k, valid))
    plain = cuda_ms(lambda: ref.knn(x, k, valid=valid))
    # per pair: d fma of the cross term + add, subtract, max; bytes: x and
    # valid in, distances and indices out
    b_ms, b_by = bound(n * n * (2 * d + 3), n * d * 4 + n + n * k * 8)
    results["K2"] = dict(kernel="K2", path="lm", n=n, d=d, k=k, max_abs_err=err,
                         index_mismatches=mism, ms=ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by, library_ms=None)
    emit("kernels", **results["K2"])


def _k3_compression() -> None:
    """K3 at the lm phase's compression shapes: the keys (d 256) and the
    [k||v] payload (d 512) of one head, 2208 rows into 1104 prototypes,
    through the 8-block fold."""
    from repro_torch.kernels import ops

    gen = np.random.default_rng(4)
    n, S = LM["prompt"] + LM["new_tokens"], (LM["prompt"] + LM["new_tokens"]) // LM["t"]
    ids = dev(np.where(np.arange(n) < LM["prompt"], gen.integers(0, S, size=n), -1)
              .astype(np.int32))
    w = torch.ones(n, device=DEV)
    for d in (256, 512):
        x = _head_keys(n, d, d)
        gs, gm = ops.blocked_segment_sum(x, ids, S, weights=w, impl="cuda")
        rs, rm = ops.blocked_segment_sum(x, ids, S, weights=w, impl="ref")
        sync()
        err = max(float((gs - rs).abs().max()), float((gm - rm).abs().max()))
        check(torch.allclose(gs, rs, **SUM_TOL) and torch.allclose(gm, rm, **SUM_TOL),
              f"K3 (d {d}) sums off: {err}")
        # the row-order fold of the plain version on the CPU: the same bits
        cs, cm = ops.blocked_segment_sum(x.cpu(), ids.cpu(), S, weights=w.cpu(),
                                         impl="ref")
        check(torch.equal(gs.cpu(), cs) and torch.equal(gm.cpu(), cm),
              f"K3 (d {d}) differs from the CPU plain version's bits")
        ms = cuda_ms(lambda: ops.blocked_segment_sum(x, ids, S, weights=w, impl="cuda"))
        plain = cuda_ms(lambda: ops.blocked_segment_sum(x, ids, S, weights=w,
                                                        impl="ref"))
        b_ms, b_by = bound(n * (2 * d + 1), n * d * 4 + n * 8 + S * (d + 1) * 4)
        emit("kernels", kernel="K3", path="lm", n=n, d=d, segments=S, blocks=8,
             max_abs_err=err, bit_equal_to_cpu_plain=True, ms=ms, plain_ms=plain,
             bound_ms=b_ms, bound_by=b_by)


def _attention_work(b, hq, hkv, lq, lk, dh, causal, elt, bias_heads):
    """(f32 flops, bf16 flops, bytes) attention needs per visible (query,
    key) pair: 2·dh for q·k, 2·dh for p·v and 8 for the logit's scale,
    softcap, bias, max, exp and sum; with ``causal`` the masked future half
    is not counted. With bf16 q and k (``elt`` 2) q·k is a product of bf16
    operands, exact in f32, so the card could run it on its bf16 tensor
    cores; p is f32, so p·v and the softmax count at the f32 peak. Bytes:
    q, k, v and the bias read once, the output written once."""
    i = np.arange(lq)
    visible = (np.clip(i + lk - lq + 1, 0, lk).sum() if causal else lq * lk)
    pairs = float(b * hq * visible)
    qk = pairs * 2 * dh
    f32 = pairs * (2 * dh + 8) + (0.0 if elt == 2 else qk)
    nbytes = (2 * b * hq * lq * dh + 2 * b * hkv * lk * dh) * elt + b * bias_heads * lk * 4
    return f32, (qk if elt == 2 else 0.0), nbytes


def _attn_inputs(b, hq, hkv, lq, lk, dh, dtype, seed, bias=None):
    g = torch.Generator(device=DEV).manual_seed(seed)
    q = (torch.randn((b, hq, lq, dh), generator=g, device=DEV) * 4).to(dtype)
    k = torch.randn((b, hkv, lk, dh), generator=g, device=DEV).to(dtype)
    v = torch.randn((b, hkv, lk, dh), generator=g, device=DEV).to(dtype)
    kb = None
    if bias is not None:
        hb = hq if bias == "q_heads" else hkv
        kb = torch.randn((b, hb, lk), generator=g, device=DEV)
        if bias == "masked":   # -1e30 entries scattered through the keys
            kb = torch.where(torch.rand((b, hb, lk), generator=g, device=DEV) < 0.1,
                             -1e30, kb)
        if bias == "first_tile":  # every key of the first 40 masked
            kb[..., :40] = -1e30
    return q, k, v, kb


def _k5_path_shapes(results: dict) -> None:
    """K5 at the lm phase's shapes, in its working type (bf16): prefill of
    a global layer (causal, no bias) and one decode step over the
    compressed cache (P = 1104 prototypes with log-mass bias, one written
    tail slot, the rest of the tail masked by the position mask)."""
    from repro_torch.kernels import flash_attention as fa

    B, hq, hkv, dh = LM["batch"], 8, 4, 256
    S, P = LM["prompt"], (LM["prompt"] + LM["new_tokens"]) // LM["t"]
    lk_dec = P + LM["tail"]
    bias = torch.full((B, hkv, lk_dec), -1e30, device=DEV)
    g = torch.Generator(device=DEV).manual_seed(7)
    bias[..., :P] = torch.log(torch.randint(1, 5, (B, hkv, P), generator=g,
                                            device=DEV).float())
    bias[..., P] = 0.0
    shapes = (("prefill", (B, hq, hkv, S, S, dh), True, None),
              ("decode", (B, hq, hkv, 1, lk_dec, dh), False, bias))
    for label, (b, hq_, hkv_, lq, lk, d), causal, kb in shapes:
        q, k, v, _ = _attn_inputs(b, hq_, hkv_, lq, lk, d, torch.bfloat16, 8)
        kw = dict(causal=causal, scale=1.0 / 16, logit_softcap=50.0)
        got = fa.flash_attention(q, k, v, kb, **kw)
        want = fa.flash_attention_plain(q, k, v, kb, **kw)
        sync()
        err = float((got.float() - want.float()).abs().max())
        check(bool(torch.isfinite(got.float()).all()), f"K5 {label}: non-finite")
        check(torch.allclose(got.float(), want.float(), **ATTN_TOL_BF16),
              f"K5 {label} (bf16) off: {err}")
        # the same call in f32, held to the f32 tolerance
        q32, k32, v32 = q.float(), k.float(), v.float()
        got32 = fa.flash_attention(q32, k32, v32, kb, **kw)
        want32 = fa.flash_attention_plain(q32, k32, v32, kb, **kw)
        err32 = float((got32 - want32).abs().max())
        check(torch.allclose(got32, want32, **ATTN_TOL_F32),
              f"K5 {label} (f32) off: {err32}")
        del got32, want32
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, kb, **kw))
        plain = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, kb, **kw))
        flops, tc_flops, nbytes = _attention_work(
            b, hq_, hkv_, lq, lk, d, causal, 2, 0 if kb is None else kb.shape[1])
        b_ms, b_by = bound(flops, nbytes, bf16_flops=tc_flops)
        row = dict(kernel="K5", path="lm", shape=label, q=list(q.shape),
                   kv=list(k.shape), causal=causal, bias=kb is not None,
                   dtype="bf16", max_abs_err=err, max_abs_err_f32=err32, ms=ms,
                   plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                   causal_half_counted=False, library_ms=None)
        emit("kernels", **row)
        if label == "prefill":
            results["K5"] = row


def _edge_checks(gen) -> None:
    """Every kernel against its plain version on awkward shapes with
    dyadic-grid data (multiples of 1/4: every distance and partial sum is
    exact in f32, and ties are common), where the two must agree bit for
    bit, tie-breaking included: d = 1 and d > 32, k = 1 and k = 32, k > p,
    masked keys, self-exclusion, out-of-range segment ids."""
    from repro_torch.kernels import fused_assign, knn_topk, ops, ref
    from repro_torch.kernels import pairwise_l2 as pw

    def grid(*shape):
        return dev((gen.integers(-16, 17, size=shape) * 0.25).astype(np.float32))

    cases = 0
    for nq, p, d, k in ((7, 33, 1, 1), (33, 17, 5, 3), (9, 9, 2, 9),
                        (40, 70, 33, 32), (300, 1000, 6, 2), (5, 3, 4, 8),
                        (40, 130, 256, 2), (33, 65, 512, 32), (70, 200, 300, 1)):
        q, keys = grid(nq, d), grid(p, d)
        valid = dev(gen.random(p) > 0.3)
        gidx = dev(gen.integers(0, 2 * p, size=nq).astype(np.int32))
        for v, g in ((None, None), (valid, gidx)):
            got = fused_assign.fused_topk(q, keys, k, v, q_gidx=g)
            want = fused_assign.fused_topk_plain(q, keys, k, v, q_gidx=g)
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"K1 differs from its plain version at {(nq, p, d, k)}")
            cases += 1
    cases += _variant_edges(gen, grid)
    for n, d, k in ((17, 1, 16), (200, 6, 2), (64, 40, 5), (300, 256, 1),
                    (100, 512, 3)):
        x = grid(n, d)
        valid = dev(gen.random(n) > 0.2)
        for v in (None, valid):
            got, want = knn_topk.knn_topk(x, k, v), ref.knn(x, k, valid=v)
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"K2 differs from its plain version at {(n, d, k)}")
            cases += 1
    for n, d, s in ((7, 1, 1), (1000, 6, 37), (333, 3, 500), (500, 40, 37),
                    (300, 512, 20)):
        x = grid(n, d)
        ids = dev(gen.integers(-1, s + 1, size=n))
        w = dev((gen.integers(1, 5, size=n) * 0.5).astype(np.float32))
        got = ops.blocked_segment_sum(x, ids, s, weights=w, impl="cuda")
        want = ops.blocked_segment_sum(x, ids, s, weights=w, impl="ref")
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"K3 differs from its plain version at {(n, d, s)}")
        cases += 1
    for n, m, d in ((7, 9, 1), (100, 7, 6), (33, 65, 40)):
        x, y = grid(n, d), grid(m, d)
        valid = dev(gen.random(m) > 0.3)
        check(torch.equal(pw.pairwise_sq_l2(x, y, valid),
                          ref.pairwise_sq_l2(x, y, y_valid=valid)),
              f"K4 differs from its plain version at {(n, m, d)}")
        cases += 1
    sync()
    emit("kernels_edges", cases=cases, bitwise=True)


def _variant_edges(gen, grid) -> int:
    """K1's bf16 and int8 instances against their plain versions, bit for
    bit, at d = 6 (register instance), 130 and 256 (chunked): dyadic keys
    and queries (exact in bf16; int8 values in [-16, 16] with scales 1/4
    or 1/2 and dyadic zero points, so every dequantized value, product and
    sum of 256 squares is exact in f32), coarse grids that force distance
    ties, masks and self-exclusion, k in {1, 3, 8, 20}; and
    the FMA case: q8 = 127 with scale 1 + 2^-23 and zero -127 gives 2^-16
    by a rounded multiply then an add, 127·2^-23 by one fused
    multiply-add, so a zero query must see every valid key at d·2^-32."""
    from repro_torch.kernels import fused_assign

    cases = 0
    for d in (6, 130, 256):
        for nq, p, k in ((33, 70, 1), (40, 129, 3), (9, 300, 8), (70, 65, 20)):
            valid = dev(gen.random(p) > 0.3)
            gidx = dev(gen.integers(0, 2 * p, size=nq).astype(np.int32))
            lim = 2 if k >= 8 else 16  # a coarse grid: many exact ties
            qb = dev((gen.integers(-lim, lim + 1, size=(nq, d)) * 0.25)
                     .astype(np.float32))
            kb = dev((gen.integers(-lim, lim + 1, size=(p, d)) * 0.25)
                     .astype(np.float32))
            q8 = dev(gen.integers(-16, 17, size=(p, d)).astype(np.int8))
            scale = dev((2.0 ** -gen.integers(1, 3, size=d)).astype(np.float32))
            zero = dev((gen.integers(-8, 9, size=d) * 0.25).astype(np.float32))
            runs = [(qb.bfloat16(), kb.bfloat16(), {}),
                    (qb, q8, dict(keys_scale=scale, keys_zero=zero))]
            for q, keys, kw in runs:
                for v, g in ((None, None), (valid, gidx)):
                    got = fused_assign.fused_topk(q, keys, k, v, q_gidx=g, **kw)
                    want = fused_assign.fused_topk_plain(q, keys, k, v,
                                                         q_gidx=g, **kw)
                    check(all(torch.equal(a, b) for a, b in zip(got, want)),
                          f"K1 ({keys.dtype}, q {q.dtype}) differs from its "
                          f"plain version at {(nq, p, d, k)}")
                    cases += 1
        # the FMA case
        p, k = 50, 8
        q8 = torch.full((p, d), 127, dtype=torch.int8, device=DEV)
        scale = torch.full((d,), 1 + 2.0 ** -23, device=DEV)
        zero = torch.full((d,), -127.0, device=DEV)
        valid = dev(gen.random(p) > 0.5)
        q = torch.zeros((5, d), device=DEV)
        got = fused_assign.fused_topk(q, q8, k, valid, keys_scale=scale,
                                      keys_zero=zero)
        want = fused_assign.fused_topk_plain(q, q8, k, valid, keys_scale=scale,
                                             keys_zero=zero)
        first = valid.nonzero()[:k, 0].to(torch.int32)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"K1 int8 FMA case differs from its plain version at d {d}")
        check(bool((got[0] == d * 2.0 ** -32).all())
              and torch.equal(got[1], first.expand(5, -1)),
              f"K1 int8 at d {d}: dequantization is not a rounded multiply "
              f"then an add, or the tie order is off")
        cases += 1
    return cases


def _attention_edges() -> None:
    """K5 against its plain version on awkward shapes: rows that fill no
    whole tile, lq < lk, head_dim 16, 64 and 256, one kv head, a bias per
    query head, -1e30 bias entries scattered, and every key of the first
    kv tile masked. Within the stated tolerance, and no NaN."""
    from repro_torch.kernels import flash_attention as fa

    cases = (
        # b, hq, hkv, lq, lk, dh, causal, bias, softcap, dtype
        (1, 4, 2, 100, 100, 64, True, None, 50.0, torch.float32),
        (2, 4, 2, 37, 300, 64, True, "kv", 50.0, torch.float32),
        (1, 2, 1, 5, 77, 16, True, "masked", 0.0, torch.float32),
        (1, 8, 1, 70, 70, 16, True, None, 30.0, torch.float32),
        (2, 8, 4, 1, 1232, 256, False, "masked", 50.0, torch.float32),
        (1, 2, 1, 1, 90, 16, False, "first_tile", 50.0, torch.float32),
        (1, 2, 1, 20, 90, 16, True, "first_tile", 50.0, torch.float32),
        (1, 4, 2, 9, 33, 256, True, "q_heads", 50.0, torch.float32),
        (2, 8, 4, 65, 129, 256, True, "kv", 50.0, torch.bfloat16),
    )
    worst = 0.0
    for i, (b, hq, hkv, lq, lk, dh, causal, bias, cap, dt) in enumerate(cases):
        q, k, v, kb = _attn_inputs(b, hq, hkv, lq, lk, dh, dt, 20 + i, bias)
        kw = dict(causal=causal, scale=1.0 / 16, logit_softcap=cap)
        got = fa.flash_attention(q, k, v, kb, **kw).float()
        want = fa.flash_attention_plain(q, k, v, kb, **kw).float()
        sync()
        tol = ATTN_TOL_F32 if dt == torch.float32 else ATTN_TOL_BF16
        err = float((got - want).abs().max())
        check(bool(torch.isfinite(got).all()), f"K5 edge {i}: non-finite")
        check(torch.allclose(got, want, **tol), f"K5 edge {i} off: {err}")
        worst = max(worst, err)
    emit("kernels_edges", kernel="K5", cases=len(cases), max_abs_err=worst)


def phase_fit(state: dict) -> None:
    import repro_torch
    from repro_torch import kernels, prng
    from repro_torch.cluster.metrics import clustering_accuracy

    n = SIZES["covertype"]
    x, comp = _analog(n)
    sync()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = repro_torch.fit(x, 3, 5, "kmeans", k=7, key=prng.PRNGKey(0),
                          device=DEV)
    sync()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    labels = res.labels
    check(labels.shape == (n,) and labels.dtype == torch.int32, "labels shape")
    check(bool(((labels >= 0) & (labels < 7)).all()), "labels outside [0, 7)")
    check(bool(torch.isfinite(res.protos).all()), "non-finite prototypes")
    sizes = torch.bincount(labels.long(), minlength=7)
    nonempty = sizes[sizes > 0]
    check(int(nonempty.min()) >= 3 ** 5, "a final cluster below t^m units")
    for name in ("K1", "K2", "K3", "K4"):
        check(counts[name] > 0, f"{name} was not launched by the fit")
    state.update(fit=res, x=x, fit_counts=counts)
    emit("fit", n=n, d=x.shape[1], t=3, m=5, k=7, seconds=round(wall, 3),
         level_sizes=res.info["level_sizes"], n_valid=res.info["n_valid"],
         mis_rounds=res.info["mis_rounds"], n_prototypes=int(res.n_prototypes),
         lloyd_iters=res.backend_result.iters,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         accuracy_vs_components=clustering_accuracy(comp, labels, 7),
         launches=counts)


def phase_serve(state: dict) -> None:
    from repro_torch import kernels
    from repro_torch.core.index import ClusterIndex
    from repro_torch.serve import ClusterService

    t0 = time.perf_counter()
    x = state["x"]
    idx = ClusterIndex.build(state["fit"]).check_servable(expect_dim=6)
    svc = ClusterService(idx, buckets=(32, 128, 512, 2048))
    svc.warmup()
    k1_before = kernels.launch_counts()["K1"]
    gen = np.random.default_rng(2)
    latencies, agree, total, mism_total, not_ties = {}, 0, 0, 0, 0
    for size in (1, 100, 2048, 5000):
        rows = dev(gen.integers(0, x.shape[0], size=size))
        noise = dev(gen.normal(scale=0.05, size=(size, 6)).astype(np.float32))
        q = x[rows] + noise
        sync()
        t1 = time.perf_counter()
        got = svc.assign(q)
        sync()
        latencies[str(size)] = round((time.perf_counter() - t1) * 1e3, 3)
        want = idx.assign(q, impl="ref")
        check(got.shape == (size,), "serve output shape")
        diff = (got != want).nonzero()[:, 0]
        agree += int((got == want).sum())
        total += size
        mism_total += int(diff.numel())
        if diff.numel():
            # a mismatch must be a near-tie: the two owners' prototypes are
            # (almost) equally near in float64
            _, pk = _owner(idx, q[diff], "fused")
            _, pr = _owner(idx, q[diff], "ref")
            dk = ((q[diff].double() - idx.protos[pk].double()) ** 2).sum(1)
            dr = ((q[diff].double() - idx.protos[pr].double()) ** 2).sum(1)
            not_ties += int((~torch.isclose(dk, dr, **DIST_TOL)).sum())
    counts = kernels.launch_counts()
    state["main_counts"] = counts
    check(counts["K1"] > k1_before, "K1 did not launch while serving")
    rate = agree / total
    check(rate >= 0.999, f"serve agreement with the plain path {rate} < 0.999")
    check(not_ties == 0, f"{not_ties} serve mismatches are not near-ties")
    emit("serve", buckets=list(svc.buckets), request_ms=latencies,
         agreement_with_plain=rate, mismatches=mism_total,
         stats=svc.stats, k1_launches_while_serving=counts["K1"] - k1_before,
         seconds=round(time.perf_counter() - t0, 3), launches=counts)


def _owner(idx, q, impl):
    from repro_torch.core.index import nearest_valid_prototype

    d, i = nearest_valid_prototype(q, idx.protos, idx.proto_valid, impl=impl)
    return d, i.long()


def phase_headline() -> None:
    import repro_torch
    from repro_torch import prng
    from repro_torch.cluster.metrics import clustering_accuracy
    from repro_torch.data import gmm_sample

    n = SIZES["gmm"]
    x, comp = gmm_sample(n, seed=0)
    t0 = time.perf_counter()
    res = repro_torch.fit(x, 2, 3, "kmeans", k=3, key=prng.PRNGKey(0),
                          device=DEV)
    sync()
    wall = time.perf_counter() - t0
    acc = clustering_accuracy(comp, res.labels, 3)
    check(acc >= 0.90, f"GMM accuracy {acc} < 0.90 (the paper reports 0.9239)")
    emit("headline", n=n, t=2, m=3, k=3, accuracy=acc,
         seconds=round(wall, 3), mis_rounds=res.info["mis_rounds"],
         lloyd_iters=res.backend_result.iters)


def phase_determinism() -> None:
    import repro_torch
    from repro_torch import prng
    from repro_torch.cluster.metrics import clustering_accuracy

    t0 = time.perf_counter()
    n = SIZES["det"]
    x, _ = _analog(n)
    runs = [repro_torch.fit(x, 3, 5, "kmeans", k=7, key=prng.PRNGKey(0),
                            device=DEV) for _ in range(2)]
    check(torch.equal(runs[0].labels, runs[1].labels)
          and torch.equal(runs[0].protos, runs[1].protos),
          "two kernel-path fits differ")
    plain = repro_torch.fit(x, 3, 5, "kmeans", k=7, key=prng.PRNGKey(0),
                            device=DEV, impl="ref")
    a, b = runs[0].labels, plain.labels
    raw = float((a == b).float().mean())
    renamed = clustering_accuracy(b, a, 7)
    check(max(raw, renamed) >= 0.999,
          f"kernel vs plain path label agreement {max(raw, renamed)} < 0.999")
    emit("determinism", n=n, bitwise_repeat=True,
         agreement_with_plain=raw, agreement_with_plain_renamed=renamed,
         assignments_equal=[bool(torch.equal(p, q)) for p, q in
                            zip(runs[0].assignments, plain.assignments)],
         seconds=round(time.perf_counter() - t0, 3))


def _pct(values, q) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


async def _closed_loop(svc, queries, reps: int) -> list:
    """``reps`` requests one after another (each awaited): latencies, ms."""
    loop = asyncio.get_running_loop()
    out = []
    for _ in range(reps):
        t0 = loop.time()
        await svc.submit(queries)
        out.append((loop.time() - t0) * 1e3)
    return out


async def _open_loop(svc, pool, *, qps, duration, sizes, fire_at, fire):
    """Open-loop traffic at ``qps`` for ``duration`` seconds, request sizes
    cycling through ``sizes``; ``fire()`` (loop-blocking: the refresh)
    runs at ``fire_at``. Returns (records, errors, swap window)."""
    loop = asyncio.get_running_loop()
    rng = np.random.default_rng(5)
    records, errors, window = [], [], None
    t0 = loop.time()
    next_t, i = 0.0, 0
    while next_t < duration:
        if window is None and next_t >= fire_at:
            w0 = loop.time()
            fire()
            window = (w0, loop.time())
        gap = t0 + next_t - loop.time()
        if gap > 0:
            await asyncio.sleep(gap)
        n = sizes[i % len(sizes)]
        lo = int(rng.integers(0, pool.shape[0] - n))
        rec = {"n": n, "t_submit": loop.time(), "t_done": None}
        fut = svc.submit(pool[lo:lo + n])

        def done(f, rec=rec):
            rec["t_done"] = loop.time()
            if f.cancelled() or f.exception() is not None:
                errors.append(repr(f.exception()))
        fut.add_done_callback(done)
        records.append(rec)
        i += 1
        next_t += 1.0 / qps
    while any(r["t_done"] is None for r in records):
        await asyncio.sleep(0.002)
    return records, errors, window


def phase_online(results: dict, state: dict) -> None:
    """The online loop at full size: stream → fit → pack → store → async
    serve under the three fused impls → refresh under live traffic."""
    from repro_torch import kernels, prng
    from repro_torch.core.index import ClusterIndex, nearest_valid_prototype
    from repro_torch.data import PointStreamConfig, point_chunk, point_chunks
    from repro_torch.serve import (AsyncClusterService, IndexStore,
                                   OnlineFitter, RefreshDriver, RefreshPolicy)

    o = ONLINE
    t_phase = time.perf_counter()
    cfg = PointStreamConfig(n=o["n"], d=o["d"], chunk=o["chunk"], seed=0,
                            kind="blobs", k=o["k"])
    n_chunks = -(-o["n"] // o["chunk"])
    # the same generator further on: points the fit never saw (100,000
    # for serving, then the drifted stream)
    n_home = -(-100_000 // o["chunk"])
    n_drift = o["refresh_points"] // o["chunk"]
    beyond = PointStreamConfig(n=(n_chunks + n_home + n_drift) * o["chunk"],
                               d=o["d"], chunk=o["chunk"], seed=0,
                               kind="blobs", k=o["k"])
    store_dir = ROOT / "build" / "online_store"
    shutil.rmtree(store_dir, ignore_errors=True)
    sync()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()

    # ---- stream → fit
    t0 = time.perf_counter()
    fitter = OnlineFitter(point_chunks(cfg), o["t"], o["m"], "kmeans",
                          k=o["k"], prefetch_depth=o["depth"],
                          key=prng.PRNGKey(0), device=DEV)
    sync()
    stream_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    snap = fitter.snapshot()
    sync()
    snapshot_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    st = snap.spill.ingest_stats
    check(fitter.n_points == o["n"] and fitter.n_chunks == n_chunks,
          f"stream folded {fitter.n_points} points in {fitter.n_chunks} chunks")
    check(bool(torch.isfinite(snap.protos).all()), "non-finite prototypes")
    mass = float(snap.proto_mass[snap.proto_valid].double().sum())
    check(abs(mass - o["n"]) < 1e-3 * o["n"], f"prototype mass {mass} != n")

    # ---- pack → store → load
    t0 = time.perf_counter()
    index = ClusterIndex.build(snap, pack=True).check_servable(expect_dim=o["d"])
    store = IndexStore(store_dir)
    v1 = store.save(index, metadata={"n_points": fitter.n_points})
    loaded = store.load(v1, expect_dim=o["d"], device=DEV)
    sync()
    store_s = time.perf_counter() - t0
    for f in ("protos", "proto_valid", "proto_labels", "protos_bf16",
              "protos_q8", "q8_scale", "q8_zero"):
        check(torch.equal(getattr(loaded, f), getattr(index, f)),
              f"IndexStore round trip changed {f}")

    # ---- serve under the three fused impls
    gen = np.random.default_rng(3)
    home = np.concatenate([point_chunk(beyond, n_chunks + j)
                           for j in range(n_home)])[:100_000]
    assign_ms, agreement, services = {}, {}, {}

    async def serve_all():
        for impl in ("fused", "fused_bf16", "fused_int8"):
            # no flush deadline: a request dispatches at once, so a closed
            # loop times the serve path, not the batching wait
            svc = AsyncClusterService(loaded, buckets=o["buckets"], impl=impl,
                                      max_wait=0.0, queue_depth=1 << 22)
            services[impl] = svc
            lat = {}
            for n in o["sizes"]:
                lo = int(gen.integers(0, home.shape[0] - n))
                lat[str(n)] = await _closed_loop(svc, home[lo:lo + n],
                                                 o["reps"][n])
            assign_ms[impl] = {n: {"p50": _pct(v, 50), "p99": _pct(v, 99)}
                               for n, v in lat.items()}
            agreement[impl] = await svc.submit(home)
    asyncio.run(serve_all())
    exact = agreement["fused"]
    plain = loaded.assign(home, impl="ref").cpu().numpy()
    agree = {impl: float((lab == exact).mean()) for impl, lab in agreement.items()}
    agree["plain_vs_fused"] = float((plain == exact).mean())
    for name, a in agree.items():
        check(a >= MIN_QUANT_AGREEMENT, f"online label agreement {name}: {a}")

    # ---- refresh under live traffic (the drifted stream)
    svc = services["fused_int8"]
    drifted = [point_chunk(beyond, n_chunks + n_home + i) + o["drift_shift"]
               for i in range(n_drift)]
    pool = np.concatenate(drifted[:2])
    driver = RefreshDriver(svc, fitter, store=store,
                           policy=RefreshPolicy(max_points=o["refresh_points"]))
    t0 = time.perf_counter()
    for c in drifted[:-1]:  # evidence ahead of the timed window
        check(driver.observe(c) is None, "refresh fired before the window")
    sync()
    observe_s = time.perf_counter() - t0
    stale = svc.current_index()
    fired = []
    records, errors, window = asyncio.run(_open_loop(
        svc, pool, qps=o["qps"], duration=o["traffic_s"], sizes=o["sizes"],
        fire_at=o["traffic_s"] / 2,
        fire=lambda: fired.append(driver.observe(drifted[-1]))))
    sched = svc.stats_snapshot()["scheduler"]
    check(fired == [2] and svc.version() == 2,
          f"the refresh did not install version 2 ({fired})")
    check(not errors and sched["failed"] == 0 and sched["rejected"] == 0,
          f"requests failed across the swap: {errors[:3]} {sched}")
    swap_ms = (window[1] - window[0]) * 1e3
    lat = [(r["t_done"] - r["t_submit"]) * 1e3 for r in records]
    stalled = [(r["t_done"] - r["t_submit"]) * 1e3 for r in records
               if r["t_submit"] <= window[1] and r["t_done"] >= window[0]]
    fresh = svc.current_index()
    saved = store.load(store.latest(), device=DEV)
    for f in ("protos", "protos_q8", "q8_scale", "protos_bf16", "proto_labels"):
        check(torch.equal(getattr(saved, f), getattr(fresh, f)),
              f"the stored refresh differs from the installed index in {f}")

    def mean_dist(idx, x):
        dd, _ = nearest_valid_prototype(dev(x), idx.protos, idx.proto_valid)
        return float(torch.sqrt(torch.clamp_min(dd, 0.0)).mean())
    ratio = mean_dist(fresh, pool) / max(mean_dist(stale, pool), 1e-12)
    check(ratio < 1.0, f"the refresh did not move the index toward the "
                       f"drifted traffic (distance ratio {ratio})")
    asyncio.run(_drain_all(services))
    counts = kernels.launch_counts()
    state["online_counts"] = counts
    # every level of this path has more than 8192 rows (the smallest TC
    # input is the finalize's 3rd level, about 19,400), so K2 is not on it
    for kid in ("K1", "K1-bf16", "K1-int8", "K3", "K4"):
        check(counts[kid] > 0, f"{kid} was not launched by the online path")

    # the whole stream's prototypes, seeding taken out (see _restarted),
    # against the generating blobs on every 10th chunk
    sample = range(0, n_chunks, 10)
    truth = np.concatenate([point_chunk(cfg, c, with_labels=True)[1]
                            for c in sample])
    quality = _restarted(snap, sample, truth)
    check(quality["accuracy"] >= MIN_BLOB_ACCURACY,
          f"online fit: accuracy {quality['accuracy']} against the "
          f"generating blobs")

    # the K1 variants at the serve shape, on the real final index
    _k1_variants(results, loaded.protos, loaded.proto_valid,
                 dev(home[:max(o["sizes"])]), path="online")

    emit("online", n=o["n"], d=o["d"], chunks=n_chunks, chunk=o["chunk"],
         t=o["t"], m=o["m"], k=o["k"], prefetch_depth=o["depth"],
         stream_s=stream_s, stream_points_per_s=o["n"] / stream_s,
         snapshot_s=snapshot_s, ingest_wait_s=st["ingest_wait_s"],
         cascades=fitter.n_cascades, reservoir_n=st["reservoir_n"],
         finalize_level_sizes=st["finalize_level_sizes"],
         n_prototypes=int(index.n_prototypes), index_rows=index.protos.shape[0],
         quality=quality,
         max_memory_allocated=peak, store_s=store_s, assign_ms=assign_ms,
         label_agreement=agree, refresh={
             "observe_s": observe_s, "swap_ms": swap_ms,
             "stall_p99_ms": _pct(stalled, 99) if stalled else 0.0,
             "stalled_requests": len(stalled), "requests": len(records),
             "p50_ms": _pct(lat, 50), "p99_ms": _pct(lat, 99),
             "failed": sched["failed"] + len(errors), "swaps": sched["swaps"],
             "distance_ratio": ratio, "history": driver.history},
         launches={kid: counts[kid] for kid in
                   ("K1", "K1-bf16", "K1-int8", "K2", "K3", "K4", "K5")},
         seconds=time.perf_counter() - t_phase)
    _online_determinism(cfg)


async def _drain_all(services) -> None:
    for svc in services.values():
        await svc.drain()


def _partition_agreement(a: np.ndarray, b: np.ndarray) -> float:
    """Share of points whose cluster in ``a`` maps onto their cluster in
    ``b`` (each cluster of one labelling matched to the cluster of the
    other that holds most of its points; the smaller of both directions).
    Invariant to renumbering: TC numbers its clusters by seed rank, so one
    extra seed renumbers every later cluster."""
    def one_way(x, y):
        keep = (x >= 0) & (y >= 0)
        x, y = x[keep].astype(np.int64), y[keep].astype(np.int64)
        pairs, counts = np.unique(x * (int(y.max()) + 1) + y, return_counts=True)
        best = np.zeros(int(x.max()) + 1, np.int64)
        np.maximum.at(best, pairs // (int(y.max()) + 1), counts)
        return float(best.sum()) / max(x.size, 1)
    return min(one_way(a, b), one_way(b, a))


def _restarted(r, chunk_ids, truth) -> dict:
    """k-means alone on a fit's final prototypes (mass-weighted) under
    SEED_RESTARTS keys; the lowest-inertia run's labels backed out through
    the fit's spill to the points of ``chunk_ids`` and held against their
    generating components. One k-means++ seeding lands this blob mixture
    in a worse local optimum for about half of all keys, on either path
    (PERF.md, PR 13), so the restarts take the seeding out of what is
    compared and leave the levels that built the prototypes."""
    from repro_torch import prng
    from repro_torch.cluster.kmeans import kmeans
    from repro_torch.cluster.metrics import clustering_accuracy

    o = ONLINE
    t0 = time.perf_counter()
    runs = [kmeans(r.protos, o["k"], valid=r.proto_valid, weights=r.proto_mass,
                   key=prng.PRNGKey(s)) for s in range(SEED_RESTARTS)]
    best = min(runs, key=lambda x: float(x.inertia))
    plab = best.labels.cpu().numpy()
    lab = np.concatenate([r.spill.labels_for(c, plab) for c in chunk_ids])
    own = np.concatenate([r.labels_for(c) for c in chunk_ids])
    return {"inertia": float(best.inertia),
            "accuracy": clustering_accuracy(truth, lab, o["k"]),
            "own_inertia": float(r.backend_result.inertia),
            "own_accuracy": clustering_accuracy(truth, own, o["k"]),
            "seconds": time.perf_counter() - t0}


def _online_determinism(cfg) -> None:
    """The first chunks of the stream through the streaming executor:
    prefetch depth 0 and 2 must give the same bits; the plain path
    (impl="ref") must agree with the kernel path on >= 0.999 of every
    chunk's level-0 partition (compared up to renumbering, see
    _partition_agreement); and each path's final prototypes, clustered
    with SEED_RESTARTS k-means seedings, must label the points as the
    generating blobs do (accuracy >= MIN_BLOB_ACCURACY) at a lowest
    inertia within MAX_INERTIA_GAP of the other path's. The fits' own
    labels (one seeding each) and their agreement are reported."""
    import repro_torch
    from repro_torch import prng
    from repro_torch.cluster.metrics import clustering_accuracy
    from repro_torch.data import point_chunk

    o = ONLINE
    t0 = time.perf_counter()
    pairs = [point_chunk(cfg, i, with_labels=True) for i in range(o["det_chunks"])]
    chunks = [c for c, _ in pairs]
    truth = np.concatenate([comp for _, comp in pairs])
    kw = dict(k=o["k"], key=prng.PRNGKey(0), device=DEV)
    runs = {depth: repro_torch.fit(iter(chunks), o["t"], o["m"], "kmeans",
                                   prefetch_depth=depth, **kw)
            for depth in (0, 2)}
    a, b = runs[0], runs[2]
    la, lb = np.asarray(a.labels), np.asarray(b.labels)
    check(np.array_equal(la, lb) and torch.equal(a.protos, b.protos),
          "prefetch depth 0 and 2 streams differ")
    plain = repro_torch.fit(iter(chunks), o["t"], o["m"], "kmeans", impl="ref",
                            **kw)
    maps = [_partition_agreement(x, y) for x, y in
            zip(a.spill.chunk_assign, plain.spill.chunk_assign)]
    ids = range(o["det_chunks"])
    quality = {"kernel": _restarted(a, ids, truth),
               "plain": _restarted(plain, ids, truth)}
    gap = quality["kernel"]["inertia"] / quality["plain"]["inertia"] - 1.0
    emit("online_determinism", chunks=o["det_chunks"], depth0_vs_depth2_bitwise=True,
         level0_partition_agreement=maps,
         final_label_agreement_renamed=clustering_accuracy(
             np.asarray(plain.labels), la, o["k"]),
         restarts=SEED_RESTARTS, quality=quality, inertia_gap=gap,
         cascades=[a.n_cascades, plain.n_cascades],
         n_prototypes=[int(a.n_prototypes), int(plain.n_prototypes)],
         seconds=time.perf_counter() - t0)
    check(min(maps) >= MIN_QUANT_AGREEMENT,
          f"stream kernel vs plain path: level-0 partition agreement {min(maps)}")
    for path, q in quality.items():
        check(q["accuracy"] >= MIN_BLOB_ACCURACY,
              f"stream {path} path: accuracy {q['accuracy']} against the "
              f"generating blobs")
    check(abs(gap) <= MAX_INERTIA_GAP,
          f"stream kernel vs plain path: lowest k-means inertia {gap:+.4f} apart")


def _point_sse(x: torch.Tensor, labels: np.ndarray, k: int) -> float:
    """Within-cluster sum of squares of the points under ``labels``
    (centres are the label means; float64 on the device)."""
    lab = torch.as_tensor(labels, device=x.device).long()
    keep = lab >= 0
    xd, lab = x[keep].double(), lab[keep]
    sums = torch.zeros((k, x.shape[1]), dtype=torch.float64, device=x.device)
    sums.index_add_(0, lab, xd)
    cnt = torch.bincount(lab, minlength=k).double().clamp_min(1.0)
    return float(((xd - (sums / cnt[:, None])[lab]) ** 2).sum())


def phase_basins() -> None:
    """Which k-means optimum the kernel path and the plain path reach on
    the online stream's first 8 chunks: both paths under several PRNG
    keys, on the data and on the data scaled by 1 + 2^-22, each with its
    prototype-level inertia, the points' within-cluster sum of squares and
    its accuracy against the generating components; then k-means alone
    (both impls, the same keys) on each path's final prototypes, which
    separates the prototypes from the seeding."""
    import repro_torch
    from repro_torch import prng
    from repro_torch.cluster.kmeans import kmeans
    from repro_torch.cluster.metrics import clustering_accuracy
    from repro_torch.data import PointStreamConfig, point_chunk

    o = ONLINE
    t0 = time.perf_counter()
    cfg = PointStreamConfig(n=o["n"], d=o["d"], chunk=o["chunk"], seed=0,
                            kind="blobs", k=o["k"])
    pairs = [point_chunk(cfg, i, with_labels=True) for i in range(o["det_chunks"])]
    chunks = [c for c, _ in pairs]
    truth = np.concatenate([comp for _, comp in pairs])
    x = dev(np.concatenate(chunks))
    emit("basins", run="truth", point_sse=_point_sse(x, truth, o["k"]))
    keep = {}
    for scale in (1.0, 1 + 2.0 ** -22):
        data = chunks if scale == 1.0 else [c * np.float32(scale) for c in chunks]
        for seed in range(o["basin_keys"] if scale == 1.0 else 1):
            for path, impl in (("kernel", None), ("plain", "ref")):
                r = repro_torch.fit(iter(data), o["t"], o["m"], "kmeans",
                                    k=o["k"], key=prng.PRNGKey(seed),
                                    impl=impl, device=DEV)
                lab = np.asarray(r.labels)
                if seed == 0 and scale == 1.0:
                    keep[path] = r
                emit("basins", run="fit", path=path, key=seed, scale=scale,
                     n_prototypes=int(r.n_prototypes),
                     inertia=float(r.backend_result.inertia),
                     lloyd_iters=int(r.backend_result.iters),
                     point_sse=_point_sse(x, lab, o["k"]),
                     accuracy=clustering_accuracy(truth, lab, o["k"]))
    for path, r in keep.items():
        for impl in (None, "ref"):
            inert = [float(kmeans(r.protos, o["k"], valid=r.proto_valid,
                                  weights=r.proto_mass, key=prng.PRNGKey(s),
                                  impl=impl).inertia)
                     for s in range(2 * o["basin_keys"])]
            emit("basins", run="kmeans_on_prototypes", prototypes=path,
                 impl=impl or "auto", inertia=inert)
    emit("basins", run="done", seconds=time.perf_counter() - t0)


def _logit_diff(got: torch.Tensor, want: torch.Tensor) -> dict:
    """(b, vocab) logits of two paths: max |Δlogit|, its bound (LOGIT_ULPS
    bf16 ulps of the largest |logit|), top-1 agreement."""
    top = float(want.abs().max())
    return {"err": float((got - want).abs().max()),
            "bound": LOGIT_ULPS * 2.0 ** (np.floor(np.log2(top)) - 7),
            "top1": float((got.argmax(-1) == want.argmax(-1)).float().mean()),
            "finite": bool(torch.isfinite(got).all())}


def _slot_agreement(a: dict, b: dict) -> float:
    """Share of (layer, batch, head, prototype slot) entries whose key,
    value (bf16: within one ulp) and mass (SUM_TOL) agree in two compressed
    caches of the same model."""
    agree = total = 0
    for ca, cb in zip(a["layers"], b["layers"], strict=True):
        P = ca["pos"]
        check(P == cb["pos"], "compressed caches of different sizes")
        ok = torch.isclose(ca["mass"][..., :P], cb["mass"][..., :P], **SUM_TOL)
        for name in ("k", "v"):
            x, y = ca[name][:, :, :P].float(), cb[name][:, :, :P].float()
            ok &= torch.isclose(x, y, rtol=2 ** -7, atol=1e-5).all(-1)
        agree += int(ok.sum())
        total += ok.numel()
    return agree / total


@contextlib.contextmanager
def _attention_as(fn):
    """While the block runs, the model's windowless attention (its calls to
    ``ops.flash_attention``, K5 on the card) goes to ``fn(q, k, v, kv_bias,
    causal=, scale=, logit_softcap=)``; ``None`` leaves it alone."""
    from repro_torch.kernels import ops

    real = ops.flash_attention
    if fn is not None:
        ops.flash_attention = (lambda q, k, v, *, kv_bias=None, impl=None, **kw:
                               fn(q, k, v, kv_bias, **kw))
    try:
        yield
    finally:
        ops.flash_attention = real


def _forced_route(bundle, model, tok, steps, *, impl, compress_impl,
                  attention=None):
    """One route through prefill, compression and teacher-forced decode:
    (last-position f32 logits of the prefill and of each step, the prefill
    caches, a copy of the compressed caches as the steps found them)."""
    from repro_torch.serve.kv_compression import compress_model_caches

    B, S = tok.shape
    with torch.inference_mode(), _attention_as(attention):
        raw = bundle.init_caches(B, S + LM["new_tokens"], device=DEV)
        logits, raw = bundle.prefill(model, raw, {"tokens": tok}, impl=impl)
        out = [logits[:, -1].float()]
        comp = compress_model_caches(raw, LM["t"], LM["m"], tail=LM["tail"],
                                     impl=compress_impl)
        start = {**comp, "layers": [{n: (a.clone() if torch.is_tensor(a) else a)
                                     for n, a in c.items()}
                                    for c in comp["layers"]]}
        for i in range(steps.shape[1]):
            logits, comp = bundle.decode_step(model, comp,
                                              {"tokens": steps[:, i:i + 1]},
                                              impl=impl)
            out.append(logits[:, -1].float())
    return out, raw, start


def phase_lm(state: dict) -> None:
    """Serve the full gemma2-2b with IHTC KV compression, then hold the
    kernel path against two plain paths and against itself."""
    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.serve.kv_compression import compress_model_caches

    t0 = time.perf_counter()
    cfg = ARCHS[LM["arch"]]
    bundle = build(cfg)
    model = bundle.init(torch.Generator(device=DEV).manual_seed(0), device=DEV)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(LM["batch"], LM["prompt"]))
    engine = ServeEngine(bundle, model, ServeConfig(
        max_new_tokens=LM["new_tokens"], compress=True, compress_t=LM["t"],
        compress_m=LM["m"], compress_tail=LM["tail"], impl="auto"))
    sync()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out = engine.generate({"tokens": prompts})
    sync()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tm = out["timings"]
    n_global = sum(cfg.attn_type(l) == "global" for l in range(cfg.n_layers))
    want_k5 = n_global + cfg.n_layers * LM["new_tokens"]
    heads = cfg.n_layers * LM["batch"] * cfg.n_kv_heads
    check(out["compressions"] >= 1, "no in-flight recompression")
    check(tuple(out["tokens"].shape) == (LM["batch"], LM["new_tokens"]),
          "lm output shape")
    check(bool(((out["tokens"] >= 0) & (out["tokens"] < cfg.vocab_size)).all()),
          "tokens outside the vocabulary")
    check(counts["K5"] == want_k5,
          f"K5 launched {counts['K5']} times, want {want_k5} ({n_global} "
          f"global prefill layers + {cfg.n_layers} per decode step)")
    check(counts["K2"] == heads * len(tm["compress"]),
          f"K2 launched {counts['K2']} times, want one per head and compress")
    check(counts["K3"] > 0, "K3 was not launched by the lm phase")
    state["lm_counts"] = counts
    state["lm_engine"] = (engine, prompts)
    n_tok = LM["batch"] * out["n_steps"]
    emit("lm", arch=cfg.name, batch=LM["batch"], prompt=LM["prompt"],
         new_tokens=out["n_steps"], init_s=round(init_s, 3),
         prefill_ms=tm["prefill_s"] * 1e3,
         compress=[{"ms": c["seconds"] * 1e3, "slots_before": c["slots_before"],
                    "slots_after": c["slots_after"]} for c in tm["compress"]],
         decode_s=tm["decode_s"], decode_tok_per_s=n_tok / tm["decode_s"],
         compressions=out["compressions"], max_memory_allocated=peak,
         launches={k: counts[k] for k in ("K2", "K3", "K5")},
         k5_expected=want_k5)

    # the kernel path against the plain paths: prefill, each path
    # compresses its own cache, then teacher-forced decode steps fed the
    # tokens the kernel path generated
    t1 = time.perf_counter()
    tok = torch.from_numpy(prompts).to(DEV)
    steps = out["tokens"][:, :LM["forced_steps"]].to(DEV, torch.int64)
    kern, raw, start = _forced_route(bundle, model, tok, steps, impl="auto",
                                     compress_impl="auto")
    with torch.inference_mode():
        # one cache compressed by both paths
        slots = _slot_agreement(start, compress_model_caches(
            raw, LM["t"], LM["m"], tail=LM["tail"], impl="ref"))
        del raw
        # the planted fault: the first step again with K5's bias dropped
        with _attention_as(lambda q, k, v, kv_bias, **kw:
                           fa.flash_attention(q, k, v, None, **kw)):
            fault, _ = bundle.decode_step(model, start, {"tokens": steps[:, :1]},
                                          impl="auto")
        del start
    plain = _forced_route(bundle, model, tok, steps, impl="auto",
                          compress_impl="ref",
                          attention=fa.flash_attention_plain)[0]
    route = _forced_route(bundle, model, tok, steps, impl="ref",
                          compress_impl="ref")[0]
    sync()
    errs = {"plain": [_logit_diff(a, b) for a, b in zip(kern, plain)],
            "route": [_logit_diff(a, b) for a, b in zip(kern, route)]}
    planted = _logit_diff(fault[:, -1].float(), plain[1])
    parity_s = time.perf_counter() - t1

    # the kernel path again: the same tokens, bit for bit
    again = engine.generate({"tokens": prompts})
    repeat = bool(torch.equal(again["tokens"], out["tokens"]))

    def rounded(e):
        return {k: round(v, 6) if isinstance(v, float) else v for k, v in e.items()}

    emit("lm_parity", logit_ulps=LOGIT_ULPS,
         steps={name: [rounded(e) for e in es] for name, es in errs.items()},
         planted_fault=rounded(planted), compressed_slot_agreement=slots,
         bitwise_repeat=repeat, parity_s=round(parity_s, 3),
         seconds=round(time.perf_counter() - t0, 3))
    for name, es in errs.items():
        for i, e in enumerate(es):  # step 0 is the prefill
            check(e["finite"], f"{name} step {i}: non-finite logits")
            check(e["err"] <= e["bound"],
                  f"{name} step {i}: max |dlogit| {e['err']} > {e['bound']}")
            check(e["top1"] >= MIN_TOP1,
                  f"{name} step {i}: top-1 agreement {e['top1']}")
    check(planted["err"] > planted["bound"],
          f"K5 with its bias dropped stays within the logit bound "
          f"({planted['err']} <= {planted['bound']})")
    check(slots >= MIN_SLOT_AGREEMENT,
          f"kernel vs plain compression: slot agreement {slots}")
    check(repeat, "two kernel-path generations differ")


def _profiled(label: str, fn) -> None:
    """Run ``fn`` under torch.profiler; emit wall time, total kernel time,
    the busy share and the kernels that took most of the device time."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    emit("profile", cell=label, profiled_wall_s=round(wall, 4),
         device_busy_s=round(busy_us / 1e6, 4),
         busy_share=round(busy_us / 1e6 / wall, 4),
         top=[{"kernel": e.key[:90], "count": e.count,
               "ms": round(e.self_device_time_total / 1e3, 3)} for e in top])


def phase_profile(state: dict) -> None:
    import repro_torch
    from repro_torch import prng
    from repro_torch.data import gmm_sample

    x = state["x"] if "x" in state else _analog(SIZES["covertype"])[0]
    _profiled("fit_covertype", lambda: repro_torch.fit(
        x, 3, 5, "kmeans", k=7, key=prng.PRNGKey(0), device=DEV))
    g, _ = gmm_sample(SIZES["gmm"], seed=0)
    _profiled("fit_gmm_headline", lambda: repro_torch.fit(
        g, 2, 3, "kmeans", k=3, key=prng.PRNGKey(0), device=DEV))
    if "lm_engine" in state:  # the lm phase's generate, once more
        engine, prompts = state["lm_engine"]
        _profiled("lm_gemma2", lambda: engine.generate({"tokens": prompts}))
    if "online_counts" in state:  # the online stream's first 16 chunks
        from repro_torch.data import PointStreamConfig, point_chunks

        o = ONLINE
        cfg = PointStreamConfig(n=16 * o["chunk"], d=o["d"], chunk=o["chunk"],
                                seed=0, kind="blobs", k=o["k"])
        _profiled("online_stream_16_chunks", lambda: repro_torch.fit(
            point_chunks(cfg), o["t"], o["m"], "kmeans", k=o["k"],
            prefetch_depth=o["depth"], key=prng.PRNGKey(0), device=DEV))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(DEFAULT_PHASES),
                    help="comma-separated subset of " + ",".join(ALL_PHASES))
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(ALL_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on a GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found; run "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions: full f32
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    device = phase_device() if "device" in phases else None
    if "build" in phases:
        phase_build()
    results, state = {}, {}
    if "kernels" in phases:
        phase_kernels(results)
    if "fit" in phases:
        phase_fit(state)
        if "serve" in phases:
            phase_serve(state)
    if "headline" in phases:
        phase_headline()
    if "determinism" in phases:
        phase_determinism()
    if "online" in phases:
        phase_online(results, state)
    if "lm" in phases:
        phase_lm(state)
    if "profile" in phases:
        phase_profile(state)
    if "basins" in phases:
        phase_basins()
    if results:
        paths = {"fit_serve": state.get("main_counts", state.get("fit_counts", {})),
                 "online": state.get("online_counts", {}),
                 "lm": state.get("lm_counts", {})}
        line = []
        for kid in ("K1", "K1-bf16", "K1-int8", "K2", "K3", "K4", "K5"):
            if kid not in results:  # a run without the kernels phase
                continue
            r = results[kid]
            name, source, replaces = KERNEL_META[kid]
            by_path = {p: c.get(kid, 0) for p, c in paths.items() if c}
            line.append({"name": name, "route": "cuda", "source": source,
                         "replaces": replaces,
                         "launches": sum(by_path.values()) if by_path else None,
                         "launches_by_path": by_path,
                         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                         "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
        print(json.dumps({"kernels": line}), flush=True)
    emit("total", seconds=round(time.perf_counter() - t_start, 3))
    if device is None:
        device = {"name": torch.cuda.get_device_name(0),
                  "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": device["name"],
                                             "count": device["count"]}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
