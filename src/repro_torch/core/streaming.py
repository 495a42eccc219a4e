"""Out-of-core streaming IHTC — the single-device half of
``repro.core.streaming``: clustering data that never fits on the card at
once.

Every host chunk is collapsed to weighted prototypes by one ITIS level,
the prototypes fold into a bounded device-side **reservoir**, and the
reservoir cascades through a further ITIS level whenever it fills. Peak
device memory is O(chunk + reservoir), whatever n.

  * **level 0, per chunk** — every chunk is padded to the static
    ``chunk_n`` rows and reduced by one ITIS level; its chunk→prototype
    map spills to the host for the back-out.
  * **reservoir fold** — each chunk's prototype slab is written at the
    reservoir's frontier, in place; the frontier advances by host
    arithmetic, so the loop never waits for the device to place a slab.
  * **cascade** — when the next fold would overflow, one ITIS level over
    the whole reservoir compacts it to ``reservoir_n // t`` slots (with
    too few valid prototypes to reduce, an identity hole-compaction); the
    reservoir-wide map spills.
  * **finalize** — after the stream, the occupied reservoir prefix runs
    the remaining ``m - 1`` levels; the planner's epilogue labels them.

Ingest pipeline: ``prefetch_depth >= 1`` starts a background thread that
normalises and validates chunk N+1..N+depth and writes them into a
rotating pool of preallocated, pinned host buffers while chunk N runs on
the card; the host→device copy of a staged chunk is asynchronous and a
CUDA event fences the buffer's reuse. At depth ≥ 1 the per-chunk map
spills are also deferred: each is copied to pinned host memory on the
stream, fenced by an event, and drained in batches. These are scheduling
changes only: the chunk key schedule is bound to the chunk *index*
(``fold_in(key_level0, chunk_idx)``), never to arrival order, so every
depth gives the bits of ``prefetch_depth=0``.

The reservoir is always written in place (folds, cascades, compactions):
the reference's ``donate_stream`` switch has nothing to switch here. A
snapshot therefore clones the occupied prefix before it runs levels on
it, so a later fold cannot change it.

Parity: a stream that presents the dataset as one chunk with
``chunk_n == n`` (and a reservoir that never overflows) runs every level
in the buffers and with the keys of the memory executor, so it gives its
bits. Multi-chunk streams are another estimator of the same family.

Two placements share the loop: one device (``streaming``), and the mesh
(``streaming_sharded``, :class:`_MeshPlacement`): the chunk buffers and
the reservoir are row-sharded over the ranks, levels run through the
sharded level step, and a slab folds in as each rank's masked write of its
own rows. Under a mesh every static size (chunk buffer, per-chunk and
cascade outputs, reservoir, the finalize levels) is rounded up to the
plan's shard multiple; where those sizes already divide by it, the
sharded stream gives the ``streaming`` executor's bits.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import prng
from repro_torch.cluster.registry import BackendFn
from repro_torch.core.itis import (ITISLevelOut, itis_step, level_sizes,
                                   round_up, validate_reduction_params)
from repro_torch.core.plan import (FitPlan, FitResult, LabelSpill, Reduction,
                                   fit, register_executor)

# fold_in tag separating the cascade key stream from the per-chunk stream
#: deprecated alias: the streaming executors return a FitResult
StreamingIHTCResult = FitResult

_CASCADE_KEY_TAG = 0x7FFFFFFF

# deferred spill maps kept in flight before one batched host drain: bounds
# the backlog to a constant whatever the stream length
_SPILL_DRAIN_BATCH = 16

# thread name of the background prefetcher (the fault tests key on it)
_PREFETCH_THREAD_NAME = "repro-torch-ingest-prefetch"


def _normalize_chunk(item, driver: str) -> Tuple[np.ndarray, int]:
    """Accept bare (c, d) arrays or ``(chunk, n_valid)`` pairs (host data:
    a tensor anywhere is brought to the host once, here)."""
    if isinstance(item, (tuple, list)) and len(item) == 2:
        arr, n_valid = item
        arr = _host_f32(arr)
        n_valid = int(n_valid)
        if not 0 <= n_valid <= arr.shape[0]:
            raise ValueError(
                f"{driver}: chunk n_valid={n_valid} outside "
                f"[0, {arr.shape[0]}]")
        return arr, n_valid
    arr = _host_f32(item)
    return arr, arr.shape[0]


def _host_f32(a: Any) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        # repro_torch: allow[HS201]: the stream's chunks are host data; a tensor chunk comes to the host once
        a = a.detach().cpu().numpy()
    # repro_torch: allow[HS201]: the stream's chunks are host data; a tensor chunk comes to the host once
    return np.asarray(a, np.float32)


def _validate_chunk(arr: np.ndarray, chunk_idx: int, chunk_n: int, d: int,
                    driver: str) -> None:
    """Shape checks every chunk passes in stream order — inline in the
    serial loop, on the prefetch thread when pipelined (the error then
    travels the queue and is raised at the chunk's stream position, so
    both modes fail with the same exception)."""
    if arr.shape[0] > chunk_n:
        raise ValueError(
            f"{driver}: chunk {chunk_idx} has {arr.shape[0]} rows "
            f"> chunk_n={chunk_n}; re-chunk the stream or raise chunk_n")
    if arr.ndim != 2 or arr.shape[1] != d:
        raise ValueError(
            f"{driver}: chunk {chunk_idx} has shape {arr.shape}, "
            f"expected (<= {chunk_n}, {d})")


# ---------------------------------------------------------------------------
# host staging pool + background prefetcher
# ---------------------------------------------------------------------------


class _PoolClosed(Exception):
    """Raised inside the prefetch thread when the consumer shut the pool
    down mid-stage — a silent exit signal, never user-visible."""


class _StagingPool:
    """Rotating pool of preallocated host staging buffers, pinned when the
    stream feeds a CUDA device (so a chunk's host→device copy runs
    asynchronously).

    Ownership: a buffer index travels stage → (queue) → consumer →
    ``release`` → back to the free list; one owner writes a buffer at a
    time. ``stage`` takes a free buffer, waits for the event its last
    tenant's copy recorded (the copy must have read the buffer before it
    is overwritten), then writes rows [0, r), re-zeroes the stale tail
    [r, prev_fill) and leaves the rest (still zero) alone: the contents
    equal a fresh ``zeros`` + fill.
    """

    def __init__(self, n_bufs: int, rows: int, d: int, pin: bool):
        self._bufs = [torch.zeros((rows, d), dtype=torch.float32,
                                  pin_memory=pin) for _ in range(n_bufs)]
        self._fill = [0] * n_bufs
        self._free: queue.Queue = queue.Queue()
        for i in range(n_bufs):
            self._free.put((i, None))

    def stage(self, arr: np.ndarray,
              stop: Optional[threading.Event] = None) -> int:
        """Copy ``arr`` into a free buffer; returns the buffer index."""
        while True:
            try:
                i, dep = self._free.get(timeout=0.05)
                break
            except queue.Empty:
                if stop is not None and stop.is_set():
                    raise _PoolClosed() from None
        if dep is not None:
            dep.synchronize()  # the last tenant's host→device copy landed
        # repro_torch: allow[HS201]: a pinned host buffer's view (no card read)
        buf = self._bufs[i].numpy()  # the same (pinned) memory
        r = arr.shape[0]
        if r:
            buf[:r] = arr
        if self._fill[i] > r:
            buf[r:self._fill[i]] = 0.0
        self._fill[i] = r
        return i

    def buffer(self, i: int) -> torch.Tensor:
        return self._bufs[i]

    def release(self, i: int, dep=None) -> None:
        """Hand a buffer back; ``dep`` is the CUDA event recorded after the
        copy that read it (None on the CPU, where reads are synchronous)."""
        self._free.put((i, dep))


class _Prefetcher:
    """Bounded background ingest: normalises and validates chunks in
    stream order, stages them into the pool, and hands ``(tag, chunk_idx,
    buf_idx, n_valid)`` records to the consumer through a depth-limited
    queue. Errors travel in-band at their stream position. ``close()`` is
    idempotent: it stops the thread (unblocking a pending put or stage)
    and joins it."""

    def __init__(self, it, pool: _StagingPool, *, driver: str, chunk_n: int,
                 d: int, depth: int, start_idx: int):
        self._pool = pool
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(it, driver, chunk_n, d, start_idx),
            name=_PREFETCH_THREAD_NAME, daemon=True)
        self._thread.start()

    def _run(self, it, driver: str, chunk_n: int, d: int, idx: int) -> None:
        try:
            for item in it:
                if self._stop.is_set():
                    return
                arr, n_valid = _normalize_chunk(item, driver)
                _validate_chunk(arr, idx, chunk_n, d, driver)
                buf_i = (self._pool.stage(arr, stop=self._stop)
                         if n_valid > 0 else None)
                self._put(("chunk", idx, buf_i, n_valid))
                idx += 1
            self._put(("end", None, None, None))
        except _PoolClosed:
            pass  # the consumer shut us down; nothing to deliver
        except BaseException as exc:  # noqa: BLE001 — delivered in-band
            self._put(("err", exc, None, None))

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return
            except queue.Full:
                continue

    def get(self):
        """Next record, in stream order (the thread always ends the stream
        with an ``end`` or ``err`` record while it is alive)."""
        return self._q.get()

    def close(self) -> None:
        self._stop.set()
        while True:  # unblock a producer stuck on a full queue
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=10.0)


class _PendingSpill:
    """A map on its way to the host: a pinned copy enqueued on the stream
    and the event that fences it."""

    __slots__ = ("host", "event")

    def __init__(self, t: torch.Tensor):
        self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self.host.copy_(t, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()

    def numpy(self) -> np.ndarray:
        self.event.synchronize()
        # repro_torch: allow[HS201]: the spill point: an owning host copy after the event the copy recorded
        return np.array(self.host.numpy())  # an owning copy; the pin returns


def _spill(t: torch.Tensor) -> np.ndarray:
    """A forced host copy (never a view) of a level map."""
    # repro_torch: allow[HS201]: the spill point: a forced host copy of a level map
    return np.array(t.cpu().numpy())


# ---------------------------------------------------------------------------
# the placement strategy (single device)
# ---------------------------------------------------------------------------


class _DevicePlacement:
    """Buffers live on the plan's device; levels run through
    :func:`repro_torch.core.itis.itis_step`; the reservoir is written in
    place."""

    mult = 1  # no shard padding

    def __init__(self, plan: FitPlan, d: int):
        self.plan = plan
        self.d = d
        self.device = plan.device

    def reservoir(self, n: int):
        dev = self.device
        return (torch.zeros((n, self.d), dtype=torch.float32, device=dev),
                torch.zeros((n,), dtype=torch.float32, device=dev),
                torch.zeros((n,), dtype=torch.bool, device=dev))

    def _to_device(self, t: torch.Tensor):
        """(device copy, the event fencing the host buffer's reuse)."""
        if self.device.type != "cuda":
            return t, None  # CPU reads are synchronous: no fence needed
        out = t.to(self.device, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return out, ev

    def place_chunk(self, buf: torch.Tensor, n_valid: int):
        xj, ev = self._to_device(buf)
        vj = torch.arange(buf.shape[0], device=self.device) < n_valid
        return xj, vj.float(), vj, ev

    def place_slab(self, px: torch.Tensor, n_valid: int):
        """A raw host slab (the valid prefix of a small chunk) → device."""
        xj, ev = self._to_device(px)
        vj = torch.arange(px.shape[0], device=self.device) < n_valid
        return xj, vj.float(), vj, ev

    def level_step(self, x, mass, valid, key, n_out: int) -> ITISLevelOut:
        p = self.plan
        return itis_step(x, mass, valid, p.t, key=key, weighted=p.weighted,
                         impl=p.impl, knn_block=p.knn_block, n_out=n_out,
                         n_blocks=p.n_blocks, knn_route=p.knn_route)

    def fold(self, res, px, pm, pv, offset: int) -> None:
        """Write one prototype slab at the frontier, in place."""
        n = px.shape[0]
        for buf, part in zip(res, (px, pm, pv)):
            buf[offset:offset + n].copy_(part)

    @staticmethod
    def compact(res) -> torch.Tensor:
        """Gather the valid reservoir rows to the front, in place (an
        identity level: no reduction, just squeezing out the masked holes
        between slabs). Returns the old-slot → new-slot map, in the format
        an ITIS level emits."""
        res_x, res_m, res_v = res
        rank = torch.cumsum(res_v.to(torch.int64), 0) - 1
        assignment = torch.where(res_v, rank, -1).to(torch.int32)
        keep = res_v.nonzero()[:, 0]
        k = keep.shape[0]
        new_x, new_m = res_x[keep], res_m[keep]  # gathered copies
        res_x[:k], res_m[:k] = new_x, new_m
        res_x[k:] = 0.0
        res_m[k:] = 0.0
        res_v[:k] = True
        res_v[k:] = False
        return assignment

    def absorb(self, out: ITISLevelOut, res) -> None:
        """The cascade's reduced slab written back over the reservoir, the
        rest zeroed (in place)."""
        n = out.protos.shape[0]
        for buf, part in zip(res, (out.protos, out.mass, out.valid)):
            buf[:n].copy_(part)
            buf[n:] = 0

    @staticmethod
    def prefix(res, frontier: int, size0: int):
        """The occupied prefix (``size0 == frontier`` on one device)."""
        return tuple(b[:size0] for b in res)

    @staticmethod
    def clone(bufs):
        """Fresh buffers: a prefix is a view of the live reservoir, which
        later folds write in place."""
        return tuple(b.clone() for b in bufs)

    @staticmethod
    def n_valid(v: torch.Tensor) -> int:
        """Valid rows of a level buffer (a host decision: syncs)."""
        # repro_torch: allow[HS202]: one read a level, the buffer's valid rows (a host decision, as the reference's)
        return int(v.sum())

    @staticmethod
    def rows(bufs):
        """A level's output as the next level's input (the same buffers)."""
        return bufs

    @staticmethod
    def whole(bufs):
        """A level buffer as the epilogue takes it (the same buffers)."""
        return bufs


class _MeshPlacement:
    """The ``streaming_sharded`` placement: each rank holds its contiguous
    block of the rows of every chunk buffer and of the reservoir; levels
    run through :func:`repro_torch.core.distributed.itis_level_sharded`,
    whose outputs are replicated, and a slab folds in as each rank's write
    of the rows of ``[offset, offset + slab)`` it owns. The rare steps that
    move rows across ranks (the hole compaction, the finalize prefix)
    all-gather the reservoir, which holds prototypes only."""

    def __init__(self, plan: FitPlan, d: int):
        from repro_torch.core.distributed import _axis

        self.plan = plan
        self.d = d
        self.device = plan.device
        self.mult = plan.shard_multiple()
        self.axis = _axis(plan.mesh, plan.axis_name)

    def _block(self, n: int):
        per = n // self.axis.size
        return self.axis.index * per, per

    def reservoir(self, n: int):
        _, per = self._block(n)
        dev = self.device
        return (torch.zeros((per, self.d), dtype=torch.float32, device=dev),
                torch.zeros((per,), dtype=torch.float32, device=dev),
                torch.zeros((per,), dtype=torch.bool, device=dev))

    def place_chunk(self, buf: torch.Tensor, n_valid: int):
        lo, per = self._block(buf.shape[0])
        part = buf[lo:lo + per]
        if self.device.type == "cuda":
            xj = part.to(self.device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
        else:
            xj, ev = part, None
        vj = (lo + torch.arange(per, device=self.device)) < n_valid
        return xj, vj.float(), vj, ev

    def place_slab(self, px: torch.Tensor, n_valid: int):
        """A raw host slab, replicated on every rank (it folds as a slab)."""
        xj = px.to(self.device)  # a synchronous copy: the buffer is free after
        vj = torch.arange(px.shape[0], device=self.device) < n_valid
        return xj, vj.float(), vj, None

    def level_step(self, x, mass, valid, key, n_out: int) -> ITISLevelOut:
        from repro_torch.core.distributed import itis_level_sharded

        p = self.plan
        return itis_level_sharded(x, mass, valid, key, t=p.t, n_out=n_out,
                                  weighted=p.weighted, axis=self.axis,
                                  n_blocks=self.mult, impl=p.impl,
                                  knn_route=p.knn_route)

    def fold(self, res, px, pm, pv, offset: int) -> None:
        """Each rank writes the rows of [offset, offset + slab) it owns,
        from the replicated slab."""
        row0, per = self._block(res[0].shape[0] * self.axis.size)
        lo, hi = max(offset, row0), min(offset + px.shape[0], row0 + per)
        if hi > lo:
            for buf, part in zip(res, (px, pm, pv)):
                buf[lo - row0:hi - row0].copy_(part[lo - offset:hi - offset])

    def _gathered(self, res):
        return tuple(self.axis.gather_rows(b) for b in res)

    def _keep(self, res, full) -> None:
        row0, per = self._block(full[0].shape[0])
        for buf, part in zip(res, full):
            buf.copy_(part[row0:row0 + per])

    def compact(self, res) -> torch.Tensor:
        """The single-device compaction on the gathered reservoir; each
        rank keeps its block. Returns the replicated old → new slot map."""
        full = self._gathered(res)
        assignment = _DevicePlacement.compact(full)
        self._keep(res, full)
        return assignment

    def absorb(self, out: ITISLevelOut, res) -> None:
        """The cascade's replicated slab, zero-padded to the reservoir;
        each rank keeps its block."""
        n_res = res[0].shape[0] * self.axis.size
        pad = n_res - out.protos.shape[0]
        full = (torch.nn.functional.pad(out.protos, (0, 0, 0, pad)),
                torch.nn.functional.pad(out.mass, (0, pad)),
                torch.nn.functional.pad(out.valid, (0, pad)))
        self._keep(res, full)

    def prefix(self, res, frontier: int, size0: int):
        """The occupied prefix zero-padded to ``size0`` (a multiple of the
        shard multiple), re-blocked over the ranks."""
        full = self._gathered(res)
        pad = size0 - frontier
        full = (torch.nn.functional.pad(full[0][:frontier], (0, 0, 0, pad)),
                torch.nn.functional.pad(full[1][:frontier], (0, pad)),
                torch.nn.functional.pad(full[2][:frontier], (0, pad)))
        return self.rows(full)

    @staticmethod
    def clone(bufs):
        return tuple(b.clone() for b in bufs)

    def n_valid(self, v: torch.Tensor) -> int:
        return int(self.axis.psum(v.sum().reshape(1).to(torch.int64))[0])

    def rows(self, bufs):
        """This rank's block of replicated level buffers."""
        row0, per = self._block(bufs[0].shape[0])
        return tuple(b[row0:row0 + per] for b in bufs)

    def whole(self, bufs):
        """Row-sharded level buffers, gathered (replicated)."""
        return self._gathered(bufs)


#: executor name -> placement
_PLACEMENTS = {"streaming": _DevicePlacement, "streaming_sharded": _MeshPlacement}


# ---------------------------------------------------------------------------
# the stream loop as a long-lived machine
# ---------------------------------------------------------------------------


class _StreamMachine:
    """The stream loop as a long-lived object: its state (reservoir,
    frontier, spill lists, the index-bound key schedule) and transitions
    (``consume`` / ``process`` / ``fold`` / ``cascade`` / ``finalize``).
    The batch executor runs it once; :class:`repro_torch.serve.lifecycle.
    OnlineFitter` keeps feeding it for the life of a deployment.

    ``finalize(snapshot=False)`` is the end-of-stream epilogue.
    ``finalize(snapshot=True)`` leaves the machine as it was: it drains the
    spill backlog, composes the back-out state over copies of the spill
    lists, clones the occupied reservoir prefix, and runs levels 1..m-1
    from the stored level-1 chain key, re-split on every finalize. So a
    snapshot after no further chunks equals the batch fit's result bit
    for bit, and ingestion goes on as if it never happened.
    """

    def __init__(self, plan: FitPlan, first_arr: np.ndarray):
        driver = plan.driver
        self.plan = plan
        self.driver = driver
        self.t, self.m = plan.t, plan.m
        self.floor = plan.reduction_floor()
        self.depth = plan.prefetch_depth
        key_itis, _ = plan.split_keys()
        # the in-memory key schedule: one split per level, level 0 first;
        # key_chain seeds levels 1..m-1 and is re-split on every finalize
        self.key_chain, self.key_level0 = prng.split(key_itis)
        self.key_cascade = prng.fold_in(self.key_level0, _CASCADE_KEY_TAG)

        chunk_n = plan.chunk_n
        if not chunk_n:
            chunk_n = first_arr.shape[0]
            if chunk_n == 0:
                raise ValueError(
                    f"{driver}: cannot infer chunk_n from an empty first "
                    f"chunk; pass chunk_n= or configure runtime chunk_n")
        if first_arr.ndim != 2:
            raise ValueError(f"{driver}: chunks must be 2-D (rows, d)")
        d = first_arr.shape[1]
        validate_reduction_params(self.t, self.m, n=chunk_n, min_m=1,
                                  driver=driver)
        self.chunk_n = chunk_n
        self.d = d

        self.placement = _PLACEMENTS[plan.executor](plan, d)
        mult = self.mult = self.placement.mult
        # under a mesh every static size is a multiple of the shard multiple
        self.chunk_buf_n = round_up(chunk_n, mult)
        self.chunk_out = round_up(max(self.chunk_buf_n // self.t, 1), mult)
        # raw-fold slab of chunks too small to reduce (the early-stop rule,
        # per chunk): their valid prefix is copied verbatim
        self.raw_len = min(chunk_n, self.floor)
        reservoir_n = plan.reservoir_n
        if not reservoir_n:
            # meets the feasibility bound below by construction, the
            # compaction case included
            reservoir_n = max(4 * self.chunk_out, 2 * self.raw_len,
                              self.floor - 1 + max(self.chunk_out,
                                                   self.raw_len))
        reservoir_n = round_up(reservoir_n, mult)
        self.reservoir_n = reservoir_n
        self.cascade_out = round_up(max(reservoir_n // self.t, 1), mult)
        # feasibility up front, before the stream is consumed: an overflow
        # frees down to cascade_out (reduction) or, degraded, to at most
        # floor - 1 valid rows (compaction); the next slab may be a full
        # chunk reduce (chunk_out rows) or a raw tail (raw_len)
        post_overflow = max(self.cascade_out, self.floor - 1)
        if reservoir_n - post_overflow < max(self.chunk_out, self.raw_len):
            raise ValueError(
                f"{driver}: reservoir_n={reservoir_n} cannot absorb a "
                f"{max(self.chunk_out, self.raw_len)}-row slab right after "
                f"an overflow (which frees down to at most {post_overflow} "
                f"occupied slots); need reservoir_n - "
                f"max(reservoir_n//t, {self.floor - 1}) "
                f">= max(chunk_n//t, {self.raw_len})")

        # staging pool: `depth` chunks queued ahead, one being staged by the
        # producer, one still owned by the consumer; the serial loop
        # double-buffers so a recycled buffer never waits on its own copy
        self.pool = _StagingPool(self.depth + 2 if self.depth else 2,
                                 self.chunk_buf_n, d,
                                 pin=plan.device.type == "cuda")

        self.res = self.placement.reservoir(reservoir_n)
        self.frontier = 0     # host-tracked write position (no device sync)
        self.n_cascades = 0

        self.chunk_assign: List[Any] = []
        self.chunk_offset: List[int] = []
        self.chunk_epoch: List[int] = []
        self.chunk_counts: List[int] = []
        self.maps: List[np.ndarray] = []
        self.spill_pending: List[int] = []  # chunk_assign slots in flight
        self.ingest_wait_s = 0.0  # consumer time blocked on ingest
        self.loop_t0 = time.perf_counter()

    @classmethod
    def open_stream(cls, plan: FitPlan, chunks):
        """Peek the first chunk (it fixes the geometry), build the machine.
        Returns ``(machine, first, rest)``: feed them to :meth:`ingest`."""
        it = iter(chunks)
        first = None
        for item in it:
            first = _normalize_chunk(item, plan.driver)
            break
        if first is None:
            raise ValueError(f"{plan.driver}: the chunk stream is empty")
        return cls(plan, first[0]), first, it

    @property
    def n_chunks(self) -> int:
        """Chunks consumed so far == the next chunk's key-schedule index."""
        return len(self.chunk_counts)

    @property
    def n_points(self) -> int:
        """Valid rows folded so far (host bookkeeping, no device sync)."""
        return int(sum(self.chunk_counts))

    # ---- the stream loop --------------------------------------------------

    def drain_spills(self) -> None:
        """Bring every deferred chunk map to the host (one batch)."""
        for i in self.spill_pending:
            # repro_torch: allow[HS201]: the deferred spills, drained in one batch
            self.chunk_assign[i] = self.chunk_assign[i].numpy()
        self.spill_pending.clear()

    def cascade(self) -> None:
        self.drain_spills()  # the cascade syncs anyway; clear the backlog
        # compaction vs reduction is a host decision, once per reservoir fill
        occ_valid = self.placement.n_valid(self.res[2])
        if occ_valid < self.floor:
            # the slots are mostly masked holes (slabs whose chunks made few
            # clusters): too few valid prototypes to reduce, so squeeze the
            # holes out instead — an identity level that collapses nothing
            self.maps.append(_spill(self.placement.compact(self.res)))
            self.frontier = occ_valid
            return
        ck = prng.fold_in(self.key_cascade, self.n_cascades)
        out = self.placement.level_step(*self.res, key=ck,
                                        n_out=self.cascade_out)
        self.maps.append(_spill(out.assignment))
        self.placement.absorb(out, self.res)
        self.frontier = self.cascade_out
        self.n_cascades += 1

    def fold(self, px, pm, pv, slab: int) -> int:
        if self.frontier + slab > self.reservoir_n:
            self.cascade()
        if self.frontier + slab > self.reservoir_n:
            raise ValueError(
                f"{self.driver}: a {slab}-row slab does not fit the "
                f"reservoir even after a cascade (frontier={self.frontier}, "
                f"reservoir_n={self.reservoir_n}); increase reservoir_n")
        offset = self.frontier
        self.placement.fold(self.res, px, pm, pv, offset)
        self.frontier += slab
        return offset

    def process(self, chunk_idx: int, buf_i: Optional[int],
                n_valid: int) -> None:
        """Device half of one chunk: place the staged buffer, reduce, fold,
        record the spill — the same for the serial and pipelined loops."""
        if n_valid == 0:  # nothing to cluster; keep chunk indexing aligned
            self.chunk_assign.append(
                np.full((self.chunk_n,), -1, np.int32))
            self.chunk_offset.append(0)
            self.chunk_epoch.append(len(self.maps))
            self.chunk_counts.append(0)
            return
        buf = self.pool.buffer(buf_i)
        if n_valid < self.floor:
            # too small to reduce (the early-stop rule): fold the valid
            # prefix raw, with an identity map
            px, pm, pv, ev = self.placement.place_slab(buf[:self.raw_len],
                                                       n_valid)
            off = self.fold(px, pm, pv, self.raw_len)
            self.pool.release(buf_i, ev)  # after the fold that read px
            # epoch AFTER the fold: a cascade the fold itself triggered must
            # not apply to the slots it just wrote
            epoch = len(self.maps)
            ident = np.arange(self.chunk_n, dtype=np.int32)
            self.chunk_assign.append(
                np.where(ident < n_valid, ident, -1).astype(np.int32))
            self.chunk_offset.append(off)
            self.chunk_epoch.append(epoch)
            self.chunk_counts.append(n_valid)
            return
        xj, mj, vj, ev = self.placement.place_chunk(buf, n_valid)
        sub = (self.key_level0 if chunk_idx == 0
               else prng.fold_in(self.key_level0, chunk_idx))
        out = self.placement.level_step(xj, mj, vj, key=sub,
                                        n_out=self.chunk_out)
        # released AFTER the level step that read xj: on the CPU xj is the
        # staging buffer itself, which the prefetcher may restage at once
        self.pool.release(buf_i, ev)
        off = self.fold(out.protos, out.mass, out.valid, self.chunk_out)
        epoch = len(self.maps)  # after the fold — see the raw path above
        if self.depth and out.assignment.is_cuda:
            # deferred spill: the copy to the host is enqueued now and
            # drained in batches (the cascade and the stream end drain the
            # rest)
            self.chunk_assign.append(_PendingSpill(out.assignment))
            self.spill_pending.append(len(self.chunk_assign) - 1)
            if len(self.spill_pending) >= _SPILL_DRAIN_BATCH:
                self.drain_spills()
        else:
            self.chunk_assign.append(_spill(out.assignment))
        self.chunk_offset.append(off)
        self.chunk_epoch.append(epoch)
        self.chunk_counts.append(n_valid)

    def consume(self, arr: np.ndarray, n_valid: int, chunk_idx: int) -> None:
        """Serial (depth 0) path: validate, stage inline, process."""
        _validate_chunk(arr, chunk_idx, self.chunk_n, self.d, self.driver)
        buf_i = None
        if n_valid > 0:
            t0 = time.perf_counter()
            buf_i = self.pool.stage(arr)
            self.ingest_wait_s += time.perf_counter() - t0
        self.process(chunk_idx, buf_i, n_valid)

    def feed(self, item) -> int:
        """Push-style ingest (the online fitter): normalise one chunk and
        consume it at the next key-schedule index. Returns the number of
        valid rows folded."""
        arr, n_valid = _normalize_chunk(item, self.driver)
        self.consume(arr, n_valid, self.n_chunks)
        return n_valid

    def ingest(self, it, *, first=None) -> None:
        """Drain an iterator through the loop: serial at depth 0, through
        the bounded background prefetcher otherwise. The already
        normalised ``first`` chunk (from :meth:`open_stream`) is consumed
        inline — it fixed the geometry."""
        if first is not None:
            self.consume(*first, self.n_chunks)
        start = self.n_chunks
        if self.depth == 0:
            for chunk_idx, item in enumerate(it, start=start):
                t0 = time.perf_counter()
                arr, n_valid = _normalize_chunk(item, self.driver)
                self.ingest_wait_s += time.perf_counter() - t0
                self.consume(arr, n_valid, chunk_idx)
            return
        pf = _Prefetcher(it, self.pool, driver=self.driver,
                         chunk_n=self.chunk_n, d=self.d, depth=self.depth,
                         start_idx=start)
        try:
            expected = start
            while True:
                t0 = time.perf_counter()
                tag, a, b, c = pf.get()
                self.ingest_wait_s += time.perf_counter() - t0
                if tag == "end":
                    break
                if tag == "err":
                    raise a
                if a != expected:
                    # the key schedule is index-bound; folding out of order
                    # would silently change the estimator
                    raise RuntimeError(
                        f"{self.driver}: prefetch delivered chunk {a}, "
                        f"expected {expected} — stream order violated")
                expected += 1
                self.process(a, b, c)
        finally:
            pf.close()

    # ---- the epilogue -----------------------------------------------------

    def finalize(self, *, snapshot: bool = False) -> Reduction:
        """Levels 1..m-1 on the occupied reservoir prefix + the back-out
        spill. ``snapshot=True`` leaves the machine ready for more chunks
        (see the class docstring)."""
        if self.frontier == 0:
            raise ValueError(
                f"{self.driver}: the stream contained no valid rows (every "
                f"chunk was empty or fully masked) — nothing to cluster")
        self.drain_spills()
        # a snapshot composes over copies: the live lists keep growing
        copy = list if snapshot else (lambda a: a)
        chunk_assign, chunk_offset = copy(self.chunk_assign), copy(self.chunk_offset)
        chunk_epoch, chunk_counts = copy(self.chunk_epoch), copy(self.chunk_counts)
        maps = copy(self.maps)
        ingest_stats = {
            "prefetch_depth": self.depth,
            "n_chunks": len(chunk_counts),
            "n_cascades": self.n_cascades,
            "chunk_n": self.chunk_n,
            "reservoir_n": self.reservoir_n,
            "wall_s": time.perf_counter() - self.loop_t0,
            "ingest_wait_s": self.ingest_wait_s,
        }

        size0 = round_up(self.frontier, self.mult)
        sizes = (level_sizes(size0, self.t, self.m - 1, multiple=self.mult)
                 if self.m > 1 else [size0])
        bufs = self.placement.prefix(self.res, self.frontier, size0)
        if snapshot:  # the prefix is a view of the live reservoir
            bufs = self.placement.clone(bufs)
        whole = None  # the last level's replicated output
        key_chain = self.key_chain  # never consumed in place
        n_valid_seen = []
        for level in range(self.m - 1):
            # the early-exit floor is a host decision, m - 1 times per fit
            n_valid = self.placement.n_valid(bufs[2])
            if n_valid < self.floor:
                break
            key_chain, sub = prng.split(key_chain)
            out = self.placement.level_step(*bufs, key=sub,
                                            n_out=sizes[level + 1])
            maps.append(_spill(out.assignment))
            n_valid_seen.append(n_valid)
            whole = (out.protos, out.mass, out.valid)
            bufs = self.placement.rows(whole)
        buf_x, buf_m, buf_v = (whole if whole is not None
                               else self.placement.whole(bufs))
        ingest_stats["finalize_level_sizes"] = sizes[:len(n_valid_seen) + 1]
        ingest_stats["finalize_n_valid"] = n_valid_seen

        spill = LabelSpill(
            chunk_n=self.chunk_n, chunk_assign=chunk_assign,
            chunk_offset=chunk_offset, chunk_epoch=chunk_epoch,
            chunk_counts=chunk_counts, maps=maps,
            n_cascades=self.n_cascades, ingest_stats=ingest_stats)
        return Reduction(
            protos=buf_x, mass=buf_m, valid=buf_v,
            n_prototypes=buf_v.sum().to(torch.int32), assignments=[],
            n0=spill.n_total, info=ingest_stats, spill=spill)


@register_executor("streaming")
def _execute_streaming(plan: FitPlan, chunks) -> Reduction:
    """One-shot stream fit: open, drain, finalize."""
    machine, first, rest = _StreamMachine.open_stream(plan, chunks)
    machine.ingest(rest, first=first)
    return machine.finalize()


@register_executor("streaming_sharded")
def _execute_streaming_sharded(plan: FitPlan, chunks) -> Reduction:
    """The composed path: the same loop over row-sharded buffers. Every
    rank iterates the same chunk stream and places only its rows."""
    return _execute_streaming(plan, chunks)


def ihtc_streaming(
    chunks,
    t: int,
    m: int,
    backend: Union[str, BackendFn] = "kmeans",
    *,
    chunk_n: Optional[int] = None,
    reservoir_n: Optional[int] = None,
    prefetch_depth: Optional[int] = None,
    weighted: bool = False,
    use_mass_in_backend: bool = True,
    key: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
    knn_block: Optional[int] = None,
    n_blocks: Optional[int] = None,
    min_points: int = 4,
    device=None,
    **backend_kwargs,
) -> FitResult:
    """Fit IHTC over a chunk stream in O(chunk + reservoir) device memory
    (``repro_torch.fit(..., executor="streaming")``).

    ``chunks`` is any iterable of host chunks — bare (c, d) arrays (e.g.
    :func:`repro_torch.data.point_chunks`) or ``(chunk, n_valid)`` pairs.
    Chunks may be ragged up to ``chunk_n`` rows. ``chunk_n`` /
    ``reservoir_n`` / ``prefetch_depth`` default to the runtime config; 0 =
    auto (the first chunk's rows; four chunks' prototype budget; the
    serial loop). ``m >= 1``: with m = 0 the backend would need every
    point at once, which streaming exists to avoid. Runs on ``device``
    (default: the runtime config's, "cuda").
    """
    return fit(chunks, t, m, backend, executor="streaming", chunk_n=chunk_n,
               reservoir_n=reservoir_n, prefetch_depth=prefetch_depth,
               weighted=weighted, use_mass_in_backend=use_mass_in_backend,
               key=key, impl=impl, knn_block=knn_block, n_blocks=n_blocks,
               min_points=min_points, device=device, driver="ihtc_streaming",
               **backend_kwargs)
