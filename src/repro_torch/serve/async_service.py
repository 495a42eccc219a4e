"""Async continuous-batching front-end over fitted ``ClusterIndex`` versions
— the port of ``repro.serve.async_service`` (the scheduler is the same
code; only the batch execution touches torch).

:class:`repro_torch.serve.ClusterService` quantizes one request at a time onto
the bucket ladder — a request that arrives alone rides a mostly-padding
bucket, and a request that arrives during another's device dispatch waits
behind it. Under the "millions of users" traffic shape (ROADMAP.md) both
are throughput killers. This module adds the production front-end:

* **continuous batching** — admitted requests are split into ≤-top-bucket
  segments and coalesced FIFO into shared batches; a batch dispatches the
  moment it fills the top bucket (or can no longer grow), and a flush
  deadline guarantees no admitted request waits longer than ``max_wait``
  for stragglers to fill its batch;
* **admission control** — a bounded queue (``queue_depth`` points across
  all tenants) rejects overload with :class:`QueueFullError` instead of
  queueing unboundedly, and ``max_inflight`` caps concurrently dispatched
  batches;
* **multi-tenant routing** — each tenant serves its own hosted
  :class:`~repro_torch.core.index.ClusterIndex` *version*; versions hot-swap
  atomically (validated + warmed **before** the swap, so a half-installed
  artifact is never visible) while requests pin the version current at
  their admission;
* **graceful shutdown** — :meth:`AsyncClusterService.drain` stops
  admission and completes every admitted request.

**Determinism contract.** The scheduler core is a plain
callback-driven state machine: it never imports a wall clock or sleeps —
every notion of time, deferral and completion goes through three injected
seams (``loop.now`` / ``loop.call_later`` / ``loop.create_future``, plus
an ``executor.submit`` for batch execution). Under real traffic those
bind to asyncio (:class:`AsyncioServeLoop`, :class:`InlineExecutor`);
under test they bind to the virtual-time harness in ``tests/serve_sim.py``
— the *exact same scheduler code* runs in both, so the tests prove the
batching invariants in simulated milliseconds with zero real sleeps.
"""
from __future__ import annotations

import asyncio
import dataclasses
import functools
import itertools
from collections import deque
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch import runtime
from repro_torch.core.index import ClusterIndex
from repro_torch.core.plan import as_device_tensor
from repro_torch.serve.cluster_service import DEFAULT_BUCKETS, ClusterService


class ServeError(RuntimeError):
    """Base class for serve-front-end scheduling errors."""


class QueueFullError(ServeError):
    """Admission rejected: the bounded request queue is at capacity."""


class ServiceClosedError(ServeError):
    """Submitted to a service that is draining or drained."""


class UnknownTenantError(ServeError):
    """Routed to a tenant the service does not host."""


class AsyncioServeLoop:
    """Default loop seam: binds to the *running* asyncio event loop.

    Resolution happens per call (not at construction), so the service can
    be built synchronously — warming indexes, installing tenants — before
    any event loop exists, and start scheduling the first time it is used
    inside ``asyncio.run(...)``.
    """

    def now(self) -> float:
        return asyncio.get_running_loop().time()

    def call_later(self, delay: float, callback: Callable[[], None]):
        return asyncio.get_running_loop().call_later(delay, callback)

    def create_future(self):
        return asyncio.get_running_loop().create_future()


class InlineExecutor:
    """Default execution seam: run the batch on the scheduler thread,
    deliver the completion on the next loop turn.

    Executing inline is honest for a single-card deployment (the kernel
    launches are asynchronous; only the result's copy to the host
    blocks), and delivering via ``call_later(0)`` keeps the scheduler
    non-reentrant — a dispatch can never complete inside the ``_pump``
    that issued it. An offloading executor (thread pool, RPC fan-out)
    only needs to implement ``submit(fn, on_done)`` with the same
    "``on_done(result, exc)`` runs as a loop callback" contract; the
    simulated-time twin lives in ``tests/serve_sim.py``.
    """

    def __init__(self, loop):
        self._loop = loop

    def submit(self, fn: Callable[[], Any],
               on_done: Callable[[Any, Optional[BaseException]], None]):
        try:
            result, exc = fn(), None
        except Exception as e:  # delivered, not raised: the loop must live
            result, exc = None, e
        self._loop.call_later(0.0, functools.partial(on_done, result, exc))


@dataclasses.dataclass(frozen=True)
class BatchRecord:
    """One dispatched batch, as seen by an ``observer`` hook: who was
    coalesced (``segments`` = (request id, rows, admit time) per segment,
    in dispatch order), onto which bucket, for which tenant/version."""

    tenant: str
    version: int
    bucket: int
    total: int
    t_dispatch: float
    segments: Tuple[Tuple[int, int, float], ...]


class _Request:
    __slots__ = ("rid", "tenant", "n", "future", "t_admit", "entry",
                 "parts", "n_segments", "done_segments", "cancel_counted")

    def __init__(self, rid, tenant, n, future, t_admit, entry):
        self.rid = rid
        self.tenant = tenant
        self.n = n
        self.future = future
        self.t_admit = t_admit
        self.entry = entry
        self.parts: list = []
        self.n_segments = 0
        self.done_segments = 0
        self.cancel_counted = False


class _Segment:
    __slots__ = ("request", "idx", "queries", "n", "deadline")

    def __init__(self, request, idx, queries, deadline):
        self.request = request
        self.idx = idx
        self.queries = queries
        self.n = queries.shape[0]
        self.deadline = deadline


class _IndexEntry:
    """One installed (tenant, version): an immutable routing target.

    Requests pin their entry at admission, and entries own their compiled
    bucket ladder via a private :class:`ClusterService`, so a hot-swap
    can never retarget work already admitted — the old entry keeps
    serving its pinned requests until they complete, then simply becomes
    unreferenced.
    """

    __slots__ = ("tenant", "version", "service")

    def __init__(self, tenant: str, version: int, service: ClusterService):
        self.tenant = tenant
        self.version = version
        self.service = service

    @property
    def index(self) -> ClusterIndex:
        return self.service.index


class _TenantState:
    __slots__ = ("tenant", "entry", "queue", "timer", "timer_deadline")

    def __init__(self, tenant: str, entry: _IndexEntry):
        self.tenant = tenant
        self.entry = entry
        self.queue: deque = deque()
        self.timer = None
        self.timer_deadline = 0.0


class AsyncClusterService:
    """Admission-controlled continuous-batching scheduler over hosted
    ``ClusterIndex`` versions.

    ``indexes`` is one :class:`ClusterIndex` (hosted under the runtime
    config's default tenant) or a ``{tenant: index}`` mapping. The
    scheduling knobs default from :class:`repro_torch.runtime.RuntimeConfig`
    (``serve_queue_depth`` / ``serve_max_inflight`` /
    ``serve_max_wait_ms``, env-overridable as ``REPRO_TORCH_SERVE_*``);
    ``max_wait`` is in **loop time units** — seconds under the default
    asyncio loop (the config's ms knob is converted), virtual units under
    an injected simulation loop.

    Client API: :meth:`submit` returns the loop's future (an
    ``asyncio.Future`` under the default loop — ``await`` it; the async
    sugar :meth:`assign` does exactly that). :meth:`install_index`
    hot-swaps a tenant's version; :meth:`drain` shuts down gracefully.
    """

    def __init__(
        self,
        indexes: Union[ClusterIndex, Mapping[str, ClusterIndex]],
        *,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        block: int = 0,
        impl: Optional[str] = None,
        queue_depth: Optional[int] = None,
        max_inflight: Optional[int] = None,
        max_wait: Optional[float] = None,
        loop=None,
        executor=None,
        observer: Optional[Callable[[BatchRecord], None]] = None,
        warmup: bool = True,
    ):
        cfg = runtime.active()
        if not buckets or any(b < 1 for b in buckets):
            raise ValueError(f"buckets must be positive, got {buckets!r}")
        self.buckets: Tuple[int, ...] = tuple(sorted(set(int(b)
                                                         for b in buckets)))
        self.capacity = self.buckets[-1]
        self.block = block
        self.impl = impl
        self.queue_depth = (cfg.serve_queue_depth if queue_depth is None
                            else int(queue_depth))
        self.max_inflight = (cfg.serve_max_inflight if max_inflight is None
                             else int(max_inflight))
        self.max_wait = (cfg.serve_max_wait_ms / 1e3 if max_wait is None
                         else float(max_wait))
        if self.queue_depth < 1 or self.max_inflight < 1 or self.max_wait < 0:
            raise ValueError(
                f"need queue_depth >= 1, max_inflight >= 1, max_wait >= 0; "
                f"got {self.queue_depth}, {self.max_inflight}, "
                f"{self.max_wait}")
        self._loop = loop if loop is not None else AsyncioServeLoop()
        self._executor = (executor if executor is not None
                          else InlineExecutor(self._loop))
        self._observer = observer
        self._default_tenant = cfg.serve_default_tenant
        self._tenants: Dict[str, _TenantState] = {}
        self._rid = itertools.count()
        self._queued_points = 0
        self._inflight = 0
        self._closed = False
        self._drain_future = None
        self._stats: Dict[str, int] = {
            "requests": 0, "points": 0, "batches": 0, "completed": 0,
            "rejected": 0, "cancelled": 0, "failed": 0, "swaps": 0,
        }
        if isinstance(indexes, ClusterIndex):
            indexes = {self._default_tenant: indexes}
        if not indexes:
            raise ValueError("need at least one hosted index")
        for tenant, index in indexes.items():
            self.install_index(tenant, index, warmup=warmup)

    # ------------------------------------------------------------------
    # tenant lifecycle

    @property
    def tenants(self) -> Tuple[str, ...]:
        return tuple(self._tenants)

    def version(self, tenant: Optional[str] = None) -> int:
        """The installed index version a new request to ``tenant`` serves."""
        return self._state(tenant).entry.version

    def install_index(self, tenant: str, index: ClusterIndex, *,
                      warmup: bool = True) -> int:
        """Install ``index`` as ``tenant``'s next version; returns it.

        Install is atomic with respect to serving: the artifact is
        structurally validated (:meth:`ClusterIndex.check_servable`,
        including that a hot-swap keeps the tenant's feature dim) and its
        bucket ladder compiled *before* the routing pointer moves, so a
        failure anywhere leaves the previous version serving untouched
        and a concurrent request can never observe a half-installed
        artifact. Requests admitted before the swap complete on the
        version they pinned at admission.
        """
        if self._closed:
            raise ServiceClosedError(
                f"cannot install {tenant!r}: service is draining")
        state = self._tenants.get(tenant)
        expect_dim = state.entry.index.dim if state is not None else None
        index.check_servable(expect_dim)
        service = ClusterService(index, buckets=self.buckets,
                                 block=self.block, impl=self.impl)
        if warmup:
            service.warmup()
        version = state.entry.version + 1 if state is not None else 1
        entry = _IndexEntry(tenant, version, service)
        if state is None:
            self._tenants[tenant] = _TenantState(tenant, entry)
        else:
            state.entry = entry  # the atomic swap
            self._stats["swaps"] += 1
            self._pump(state)  # a superseded entry's batch can't grow: flush
        return version

    def _state(self, tenant: Optional[str]) -> _TenantState:
        tenant = self._default_tenant if tenant is None else tenant
        state = self._tenants.get(tenant)
        if state is None:
            raise UnknownTenantError(
                f"unknown tenant {tenant!r}; hosted: {sorted(self._tenants)}")
        return state

    # ------------------------------------------------------------------
    # client API

    def submit(self, queries, *, tenant: Optional[str] = None):
        """Admit an (n, d) request for ``tenant``; returns the loop's
        future resolving to (n,) int32 labels.

        Raises :class:`ServiceClosedError` after :meth:`drain`,
        :class:`UnknownTenantError` for an unhosted tenant, and
        :class:`QueueFullError` when admission would push the queued-point
        total past ``queue_depth`` (the request is not partially admitted).
        Cancelling the returned future drops its undispatched segments;
        already-dispatched work completes on device and is discarded.
        """
        if self._closed:
            raise ServiceClosedError("service is draining; no new admissions")
        state = self._state(tenant)
        n = int(queries.shape[0])
        if n == 0:
            fut = self._loop.create_future()
            fut.set_result(np.zeros((0,), np.int32))
            self._stats["requests"] += 1
            self._stats["completed"] += 1
            return fut
        if self._queued_points + n > self.queue_depth:
            self._stats["rejected"] += 1
            raise QueueFullError(
                f"admission queue full: {self._queued_points}/"
                f"{self.queue_depth} points queued, request of {n} rejected"
                + (f" (request exceeds queue_depth={self.queue_depth} and "
                   f"can never be admitted)" if n > self.queue_depth else ""))
        fut = self._loop.create_future()
        t_admit = self._loop.now()
        req = _Request(next(self._rid), state.tenant, n, fut, t_admit,
                       state.entry)
        if hasattr(queries, "detach"):  # a tensor: the queries are host data
            # repro_torch: allow[HS201]: requests are host data; a tensor request comes to the host at admission
            queries = queries.detach().cpu().numpy()
        # repro_torch: allow[HS201]: requests are host data; a tensor request comes to the host at admission
        q = np.asarray(queries)
        deadline = t_admit + self.max_wait
        segments = [
            _Segment(req, idx, q[lo:lo + self.capacity], deadline)
            for idx, lo in enumerate(range(0, n, self.capacity))
        ]
        req.n_segments = len(segments)
        req.parts = [None] * len(segments)
        state.queue.extend(segments)
        self._queued_points += n
        self._stats["requests"] += 1
        self._stats["points"] += n
        add_cb = getattr(fut, "add_done_callback", None)
        if add_cb is not None:  # eager cleanup when the client cancels
            add_cb(lambda f: self._on_request_done(state, f))
        self._pump(state)
        return fut

    async def assign(self, queries, *, tenant: Optional[str] = None):
        """Asyncio sugar: ``await service.assign(x)`` — submit + await."""
        return await self.submit(queries, tenant=tenant)

    def drain(self):
        """Stop admission and complete all admitted work; returns a future
        resolving to the final stats snapshot once the last batch lands.
        Pending partial batches flush immediately (the ``max_wait``
        deadline no longer applies); further :meth:`submit` /
        :meth:`install_index` calls raise :class:`ServiceClosedError`."""
        self._closed = True
        if self._drain_future is None:
            self._drain_future = self._loop.create_future()
            self._pump_all()
            self._maybe_finish_drain()
        return self._drain_future

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def stats(self) -> Dict[str, int]:
        """Scheduler counters: requests/points admitted, batches
        dispatched, completed/rejected/cancelled/failed requests, hot
        swaps. Per-tenant bucket telemetry lives in
        :meth:`tenant_stats`."""
        return dict(self._stats)

    def tenant_stats(self) -> Dict[str, Dict[str, int]]:
        """Per-tenant: installed version + the entry's bucket-ladder
        counters (chunks == dispatched batches for that version)."""
        return {
            t: {"version": s.entry.version, **s.entry.service.stats}
            for t, s in self._tenants.items()
        }

    def stats_snapshot(self, *, reset: bool = False) -> Dict[str, Any]:
        """One consistent view of scheduler **and** per-tenant counters:
        ``{"scheduler": {...}, "tenants": {tenant: {...}}}``.

        ``reset=True`` zeroes every counter in the same step the snapshot
        is taken, so phase-delta reporting (bench_lifecycle's per-phase
        rows) never loses a count between a read and a reset — the
        scheduler is single-threaded per the loop seam, so read-then-zero
        with no interleaved callback *is* atomic here; this method exists
        so callers don't have to know that. ``ClusterService`` exposes the
        same method, fixing the historical asymmetry where the sync
        service could ``reset_stats`` per phase but the async front-end's
        tenant counters could only be read and zeroed separately."""
        snap = {"scheduler": self.stats, "tenants": self.tenant_stats()}
        if reset:
            for k in self._stats:
                self._stats[k] = 0
            for state in self._tenants.values():
                state.entry.service.reset_stats()
        return snap

    def reset_stats(self) -> None:
        """Zero the scheduler counters and every tenant's bucket counters
        (e.g. after a warmup/probe phase, so steady-state reporting starts
        clean — the same contract as :meth:`ClusterService.warmup`)."""
        self.stats_snapshot(reset=True)

    def current_index(self, tenant: Optional[str] = None) -> ClusterIndex:
        """The index new admissions to ``tenant`` would serve right now
        (the drift proxy of :class:`repro_torch.serve.lifecycle.RefreshDriver`
        scores observed traffic against exactly this artifact). In-flight
        requests may still be pinned to an older version."""
        return self._state(tenant).entry.index

    # ------------------------------------------------------------------
    # scheduler core (every callback below runs as a loop callback)

    def _on_request_done(self, state: _TenantState, fut) -> None:
        cancelled = getattr(fut, "cancelled", None)
        if cancelled is not None and cancelled():
            self._pump(state)  # purges the cancelled segments eagerly

    def _purge_cancelled(self, state: _TenantState) -> None:
        if not any(s.request.future.done() for s in state.queue):
            return
        kept: deque = deque()
        for seg in state.queue:
            if seg.request.future.done():
                # done while still queued == cancelled (or failed by a
                # sibling segment's batch error): never dispatch it
                self._queued_points -= seg.n
                self._count_cancel(seg.request)
            else:
                kept.append(seg)
        state.queue = kept

    def _count_cancel(self, req: _Request) -> None:
        if not req.cancel_counted and req.future.cancelled():
            req.cancel_counted = True
            self._stats["cancelled"] += 1

    def _pump(self, state: _TenantState) -> None:
        """Form and dispatch batches for one tenant until the queue can't
        yield another (empty, inflight-saturated, or waiting to fill)."""
        self._purge_cancelled(state)
        while state.queue and self._inflight < self.max_inflight:
            head_entry = state.queue[0].request.entry
            batch, total = [], 0
            for seg in state.queue:
                if seg.request.entry is not head_entry:
                    break  # one batch == one index version
                if total + seg.n > self.capacity:
                    break  # FIFO: never reorder a later segment past this
                batch.append(seg)
                total += seg.n
            packed_all = len(batch) == len(state.queue)
            # a batch can only grow if every queued segment joined it,
            # there is spare capacity, and future arrivals would still be
            # batchable with it (the head entry is the live version)
            can_grow = (packed_all and total < self.capacity
                        and head_entry is state.entry)
            deadline = state.queue[0].deadline
            if can_grow and not self._closed and self._loop.now() < deadline:
                self._arm_timer(state, deadline)
                return
            self._dispatch(state, batch, total)
        if not state.queue:
            self._disarm_timer(state)

    def _arm_timer(self, state: _TenantState, deadline: float) -> None:
        if state.timer is not None and state.timer_deadline <= deadline:
            return  # an earlier-or-equal flush is already scheduled
        self._disarm_timer(state)
        state.timer_deadline = deadline
        state.timer = self._loop.call_later(
            max(0.0, deadline - self._loop.now()),
            functools.partial(self._on_timer, state))

    def _disarm_timer(self, state: _TenantState) -> None:
        if state.timer is not None:
            state.timer.cancel()
            state.timer = None

    def _on_timer(self, state: _TenantState) -> None:
        state.timer = None
        self._pump(state)

    def _dispatch(self, state: _TenantState, batch, total: int) -> None:
        for _ in batch:  # the batch is exactly the queue's head prefix
            state.queue.popleft()
        self._queued_points -= total
        entry = batch[0].request.entry
        if len(batch) == 1:
            queries = batch[0].queries
        else:
            queries = np.concatenate([s.queries for s in batch], axis=0)
        self._inflight += 1
        self._stats["batches"] += 1
        if self._observer is not None:
            self._observer(BatchRecord(
                tenant=state.tenant, version=entry.version,
                bucket=entry.service.bucket_for(total), total=total,
                t_dispatch=self._loop.now(),
                segments=tuple((s.request.rid, s.n, s.request.t_admit)
                               for s in batch)))
        self._executor.submit(
            functools.partial(self._run_batch, entry, queries),
            functools.partial(self._on_batch_done, batch))

    @staticmethod
    def _run_batch(entry: _IndexEntry, queries: np.ndarray) -> np.ndarray:
        # the copy to the host waits for the device, so completion means
        # labels the client can read, not a pending device computation
        q = as_device_tensor(queries, entry.index.device)
        # repro_torch: allow[HS201]: a batch completes with labels the client can read (one copy a batch)
        return entry.service.assign_bucket(q).cpu().numpy()

    def _on_batch_done(self, batch, result, exc) -> None:
        self._inflight -= 1
        offset = 0
        for seg in batch:
            req = seg.request
            if exc is not None:
                if not req.future.done():
                    req.future.set_exception(exc)
                    self._stats["failed"] += 1
                continue
            part = result[offset:offset + seg.n]
            offset += seg.n
            if req.future.done():  # cancelled while in flight: discard
                self._count_cancel(req)
                continue
            req.parts[seg.idx] = part
            req.done_segments += 1
            if req.done_segments == req.n_segments:
                labels = (req.parts[0] if req.n_segments == 1
                          else np.concatenate(req.parts))
                req.future.set_result(labels)
                self._stats["completed"] += 1
        self._pump_all()
        self._maybe_finish_drain()

    def _pump_all(self) -> None:
        for state in self._tenants.values():
            if state.queue and self._inflight < self.max_inflight:
                self._pump(state)

    def _maybe_finish_drain(self) -> None:
        if (self._drain_future is not None and not self._drain_future.done()
                and self._inflight == 0
                and all(not s.queue for s in self._tenants.values())):
            self._drain_future.set_result(self.stats)
