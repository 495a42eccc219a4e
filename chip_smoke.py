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
  profile      (only when asked for) the fit and the headline fit again under
               torch.profiler: kernel time by name and the device busy share.

The kernel launch counts are set to 0 just before the fit and read after
the fit and after the serve phase; every kernel must have launched. Then
one JSON line lists every kernel, the card's name and power limit are
printed, and the last line is ``{"ok": true, "device": {...}}``. Any
failure raises and the script exits nonzero without that line; so does a
machine without a GPU, or a directory without the repository's ``src/``.
It imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DEFAULT_PHASES = ("device", "build", "kernels", "fit", "serve", "headline",
                  "determinism")
#: "profile" (not run by default): the fit and the headline fit once more
#: under torch.profiler — device time by kernel and the device's busy share
ALL_PHASES = DEFAULT_PHASES + ("profile",)

# H100 SXM published peaks (NVIDIA data sheet): f32 on the CUDA cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# distance tolerance, kernel vs plain version, both f32 on the card: they
# round |x|²+|y|²−2x·y in other orders (sequential fma vs cuBLAS and
# torch.sum), a few ulps of values up to ~100 on standardized data
DIST_TOL = dict(rtol=1e-5, atol=1e-4)
# segment sums: the plain version uses float atomics (any order) on the card
SUM_TOL = dict(rtol=1e-5, atol=1e-4)

#: where the script runs and at what sizes (the main path's; a rehearsal
#: elsewhere may shrink them)
DEV = "cuda"
SIZES = dict(covertype=581_012, segments=193_670, blocked_q=8192,
             assign_q=2048, protos=2390, knn_n=7172, centres=7,
             gmm=1_000_000, det=65_536)

KERNEL_META = {
    "K1": ("fused_topk", "src/repro_torch/csrc/topk.cu",
           "src/repro/kernels/fused_assign.py:61"),
    "K2": ("knn_topk", "src/repro_torch/csrc/topk.cu",
           "src/repro/kernels/knn_topk.py:25"),
    "K3": ("segment_sum", "src/repro_torch/csrc/segment_sum.cu",
           "src/repro/kernels/segment_sum.py:20"),
    "K4": ("pairwise_sq_l2", "src/repro_torch/csrc/pairwise_l2.cu",
           "src/repro/kernels/pairwise_l2.py:22"),
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


def bound(flops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of flops at the f32 peak and bytes
    at the memory rate."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
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
    results["K2"] = dict(kernel="K2", n=n, d=6, k=k, max_abs_err=err,
                         index_mismatches=mism, ms=ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by, library_ms=None)
    emit("kernels", **results["K2"])

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
    _edge_checks(gen)
    emit("kernels_done", seconds=round(time.perf_counter() - t0, 3))


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
                        (40, 70, 33, 32), (300, 1000, 6, 2), (5, 3, 4, 8)):
        q, keys = grid(nq, d), grid(p, d)
        valid = dev(gen.random(p) > 0.3)
        gidx = dev(gen.integers(0, 2 * p, size=nq).astype(np.int32))
        for v, g in ((None, None), (valid, gidx)):
            got = fused_assign.fused_topk(q, keys, k, v, q_gidx=g)
            want = fused_assign.fused_topk_plain(q, keys, k, v, q_gidx=g)
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"K1 differs from its plain version at {(nq, p, d, k)}")
            cases += 1
    for n, d, k in ((17, 1, 16), (200, 6, 2), (64, 40, 5)):
        x = grid(n, d)
        valid = dev(gen.random(n) > 0.2)
        for v in (None, valid):
            got, want = knn_topk.knn_topk(x, k, v), ref.knn(x, k, valid=v)
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"K2 differs from its plain version at {(n, d, k)}")
            cases += 1
    for n, d, s in ((7, 1, 1), (1000, 6, 37), (333, 3, 500)):
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
    if "profile" in phases:
        phase_profile(state)
    if results:
        launches = state.get("main_counts", state.get("fit_counts", {}))
        line = []
        for kid in ("K1", "K2", "K3", "K4"):
            r = results[kid]
            name, source, replaces = KERNEL_META[kid]
            line.append({"name": name, "route": "cuda", "source": source,
                         "replaces": replaces, "launches": launches.get(kid),
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
