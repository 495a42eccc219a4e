"""Empirical measurement of dispatch candidates — the autotuner proper.

The port of ``repro.tune.autotune``. Each cell maps to a candidate list
and a runner that times one candidate on synthetic inputs **at the bucket
edge** (dims rounded up by :func:`repro_torch.tune.cache.pow2_bucket`), so
the recorded winner is measured at the worst case of the bucket it serves.

On the CPU the candidates are exactly the reference's without Pallas
(``candidates_for(..., include_pallas=False)``): the plain versions, the
row blocks, the stream grid and the fused family's fold tiles. On the
card they are the CUDA routes that exist (a route is the port's
counterpart of a Pallas tile; the tiles themselves are fixed when a
kernel is compiled), never the plain versions:

  * ``knn`` (n, d, k)            — K2's routes that run (d, k);
  * ``pairwise_sq_l2`` (n, m, d) — K4 ``tiled``, and ``small_m`` where it runs;
  * ``segment_sum`` (n, d, s)    — K3 ``many``, and ``few`` where it runs;
  * ``knn_block`` (n, d, k)      — the blocked kNN's row block, as on the CPU;
  * ``stream``                   — the online phase's chunk sizes x prefetch
    depth 0 / 2;
  * ``assign`` (nq, p, d, k)     — ``fused`` on each K1 route that runs
    (d, k), ``fused_bf16``, ``fused_int8``, and ``cuda`` (the K4 matrix and
    the plain merge) where its (nq, p) f32 matrix fits
    :data:`ASSIGN_MATRIX_SHARE` of the free memory.

Deliberately not tuned: ``n_blocks``, which pins the summation order and
so the bits (as in the reference).

Timing: the first call discarded (it builds or loads the kernels), then
the median of ``repeats`` runs, each on the host clock around a
``torch.cuda.synchronize()`` on the card. The sweep runs under
``tune="off"``.
"""
from __future__ import annotations

import statistics
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import runtime
from repro_torch.tune.cache import (
    TuningCache,
    get_cache,
    pow2_bucket,
    shape_bucket,
)

#: the cells the autotuner measures (``populate``'s default set)
KERNELS = ("knn", "pairwise_sq_l2", "segment_sum", "knn_block", "stream",
           "assign")

_KNN_BLOCKS = (2048, 4096, 8192, 16384)
_CHUNKS = (1024, 2048, 4096)
#: the stream cell's chunks on the card, up to the online phase's 131,072
_CARD_CHUNKS = (32768, 65536, 131072)
_PREFETCH_DEPTHS = (0, 2)  # serial vs pipelined ingest; the same bits
_ASSIGN_BKS = (512, 1024, 2048)  # the plain fused fold's key blocks

#: share of the card's free memory the composed assign candidate's (nq, p)
#: f32 distance matrix may take; beyond it the candidate is skipped
ASSIGN_MATRIX_SHARE = 0.25

#: synthetic dims a cell is measured at when the caller gives none
DEFAULT_DIMS: Dict[str, Dict[str, int]] = {
    "knn": {"n": 8192, "d": 8, "k": 3},
    "pairwise_sq_l2": {"n": 4096, "m": 4096, "d": 8},
    "segment_sum": {"n": 8192, "d": 8, "s": 1024},
    "knn_block": {"n": 16384, "d": 8, "k": 3},
    "stream": {},
    "assign": {"nq": 1024, "p": 8192, "d": 8, "k": 1},
}


def _device(device: Any = None) -> torch.device:
    return torch.device(runtime.active().device if device is None else device)


def current_device_kind(device: Any = None) -> str:
    """``torch.cuda.get_device_name()`` of ``device`` (default: the
    configured one) when it is a CUDA device, else ``"cpu"``. A CUDA device
    without a card raises; it never falls back."""
    dev = _device(device)
    if dev.type != "cuda":
        return "cpu"
    dev = runtime.resolve_device(dev)
    return _device_name(dev.index if dev.index is not None
                        else torch.cuda.current_device())


_names: Dict[int, str] = {}


def _device_name(index: int) -> str:
    name = _names.get(index)
    if name is None:
        name = _names[index] = torch.cuda.get_device_name(index)
    return name


def _free_bytes(device: Any = None) -> int:
    dev = _device(device)
    with torch.cuda.device(dev):
        return int(torch.cuda.mem_get_info()[0])


def _edges(dims: Dict[str, int], names: str) -> List[int]:
    return [pow2_bucket(dims[a]) for a in names]


def card_candidates(kernel: str, dims: Dict[str, int], free_bytes: int
                    ) -> Tuple[List[Dict[str, Any]], List[Tuple[Dict[str, Any], str]]]:
    """(candidates, skipped (params, reason)) of one cell on the card: only
    routes that run at the bucket's edge, never a plain version."""
    from repro_torch.kernels import fused_assign, pairwise_l2
    from repro_torch.kernels import segment_sum as segsum

    e = {a: pow2_bucket(v) for a, v in dims.items()}
    if kernel == "knn":
        return [{"impl": "cuda", "route": r} for r in fused_assign.ROUTES
                if fused_assign.route_ok(r, e["d"], e["k"])], []
    if kernel == "pairwise_sq_l2":
        return [{"impl": "cuda", "route": r} for r in ("tiled", "small_m")
                if pairwise_l2.route_ok(r, e["m"], e["d"])], []
    if kernel == "segment_sum":
        return [{"impl": "cuda", "route": r} for r in ("many", "few")
                if segsum.route_ok(r, e["s"])], []
    if kernel == "stream":
        return [{"chunk_n": c, "prefetch_depth": p}
                for c in _CARD_CHUNKS for p in _PREFETCH_DEPTHS], []
    if kernel == "assign":
        cands: List[Dict[str, Any]] = [
            {"impl": "fused", "route": r} for r in fused_assign.ROUTES
            if fused_assign.route_ok(r, e["d"], e["k"])]
        cands += [{"impl": "fused_bf16"}, {"impl": "fused_int8"}]
        composed = {"impl": "cuda"}
        need = 4 * e["nq"] * e["p"]
        if need <= ASSIGN_MATRIX_SHARE * free_bytes:
            cands.append(composed)
            return cands, []
        return cands, [(composed, f"its (nq, p) f32 matrix takes {need} bytes, "
                                  f"over {ASSIGN_MATRIX_SHARE} of the "
                                  f"{free_bytes} free")]
    return candidates_for(kernel, dims), []


def candidates_for(kernel: str, dims: Dict[str, int]) -> List[Dict[str, Any]]:
    """The candidate parameter dicts swept for one cell on the CPU: the
    reference's ``candidates_for(kernel, dims, include_pallas=False)``
    (on the card: :func:`card_candidates`)."""
    if kernel in ("knn", "pairwise_sq_l2", "segment_sum"):
        return [{"impl": "ref"}]
    if kernel == "knn_block":
        ceiling = pow2_bucket(dims.get("n", _KNN_BLOCKS[-1]))
        blocks = [b for b in _KNN_BLOCKS if b <= ceiling] or [ceiling]
        return [{"knn_block": b} for b in blocks]
    if kernel == "stream":
        return [{"chunk_n": c, "prefetch_depth": p}
                for c in _CHUNKS for p in _PREFETCH_DEPTHS]
    if kernel == "assign":
        cands: List[Dict[str, Any]] = [{"impl": "ref"}]
        for impl in ("fused", "fused_bf16", "fused_int8"):
            cands += [{"impl": impl, "block_k": bk} for bk in _ASSIGN_BKS]
        return cands
    raise ValueError(f"unknown tunable kernel {kernel!r}; have {KERNELS}")


def _median_seconds(fn, repeats: int, on_card: bool) -> float:
    def synced():
        out = fn()
        if on_card:
            torch.cuda.synchronize()
        return out

    synced()  # builds or loads the kernels, warms the caches: not timed
    times = []
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        synced()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def make_runner(kernel: str, dims: Dict[str, int], dtype: str = "float32",
                device: Any = None):
    """Build synthetic bucket-edge inputs once (a seeded generator) on
    ``device``; return ``run(params)``, which runs one candidate through
    the op the main path calls."""
    from repro_torch.kernels import ops

    dev = _device(device)
    rng = np.random.default_rng(0)
    tdt = getattr(torch, dtype)

    def normal(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                               device=dev).to(tdt)

    if kernel == "knn":
        n, d, k = _edges(dims, "ndk")
        x = normal(n, d)

        def run(params):
            return ops.knn(x, k, impl=params.get("impl"), route=params.get("route"))

        return run

    if kernel == "pairwise_sq_l2":
        n, m, d = _edges(dims, "nmd")
        x, y = normal(n, d), normal(m, d)

        def run(params):
            return ops.pairwise_sq_l2(x, y, impl=params.get("impl"),
                                      route=params.get("route"))

        return run

    if kernel == "segment_sum":
        n, d, s = _edges(dims, "nds")
        x = normal(n, d)
        ids = torch.as_tensor(rng.integers(0, s, size=n), device=dev)

        def run(params):
            return ops.blocked_segment_sum(x, ids, s, impl=params.get("impl"),
                                           route=params.get("route"))

        return run

    if kernel == "knn_block":
        from repro_torch.core.knn import knn_graph_blocked

        n, d, k = _edges(dims, "ndk")
        x = normal(n, d)

        def run(params):
            return knn_graph_blocked(x, k, block=params["knn_block"])

        return run

    if kernel == "assign":
        from repro_torch.core.index import ClusterIndex

        nq, p, d = _edges(dims, ("nq", "p", "d"))
        protos = normal(p, d).float()
        idx = ClusterIndex.build(ClusterIndex(
            protos=protos,
            proto_mass=torch.ones((p,), dtype=torch.float32, device=dev),
            proto_valid=torch.ones((p,), dtype=torch.bool, device=dev),
            proto_labels=torch.arange(p, dtype=torch.int32, device=dev) % 16,
            n_prototypes=torch.tensor(p, dtype=torch.int32, device=dev)))
        q = normal(nq, d)

        def run(params):
            return idx.assign(q, impl=params["impl"],
                              block_k=params.get("block_k"),
                              route=params.get("route"))

        return run

    if kernel == "stream":
        import repro_torch

        d = pow2_bucket(dims.get("d", 8))
        chunks = _CARD_CHUNKS if dev.type == "cuda" else _CHUNKS
        n = 4 * max(chunks)
        x = rng.normal(size=(n, d)).astype(dtype)

        def run(params):
            c = params["chunk_n"]
            res = repro_torch.fit((x[i:i + c] for i in range(0, n, c)), 2, 1,
                                  "kmeans", k=3, executor="streaming",
                                  chunk_n=c, prefetch_depth=params["prefetch_depth"],
                                  device=dev)
            return res.proto_labels

        return run

    raise ValueError(f"unknown tunable kernel {kernel!r}; have {KERNELS}")


def autotune_cell(
    kernel: str,
    dims: Optional[Dict[str, int]] = None,
    *,
    dtype: str = "float32",
    cache: Optional[TuningCache] = None,
    repeats: int = 3,
    device: Any = None,
    save: bool = True,
    verbose: bool = False,
) -> Tuple[Dict[str, Any], float]:
    """Measure every candidate of one cell on ``device`` (default: the
    configured one); record and return the winner as ``(params, median
    seconds)``. Candidates the card cannot hold are skipped and printed."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown tunable kernel {kernel!r}; have {KERNELS}")
    dims = dict(DEFAULT_DIMS[kernel] if dims is None else dims)
    dev = _device(device)
    kind = current_device_kind(dev)
    cache = get_cache() if cache is None else cache
    on_card = dev.type == "cuda"
    if on_card:
        cands, skipped = card_candidates(kernel, dims, _free_bytes(dev))
    else:
        cands, skipped = candidates_for(kernel, dims), []
    for params, why in skipped:
        print(f"# skipped {kernel} {params}: {why}", flush=True)
    if not cands:
        raise ValueError(f"{kernel}: no candidate can run the bucket "
                         f"{shape_bucket(**dims)} on {kind}")

    best: Optional[Dict[str, Any]] = None
    best_sec = float("inf")
    with runtime.configure(tune="off"):
        run = make_runner(kernel, dims, dtype, dev)
        for params in cands:
            sec = _median_seconds(lambda params=params: run(params), repeats,
                                  on_card)
            if verbose:
                print(f"#   {kernel} {params} -> {sec * 1e3:.3f} ms", flush=True)
            if sec < best_sec:
                best, best_sec = params, sec
    assert best is not None
    cache.record(kind, kernel, shape_bucket(**dims), best, dtype=dtype,
                 seconds=round(best_sec, 6), candidates=len(cands), save=save)
    return best, best_sec
