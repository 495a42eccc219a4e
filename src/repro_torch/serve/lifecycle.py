"""Online index lifecycle: incremental refit and zero-downtime refresh —
the port of ``repro.serve.lifecycle``.

:class:`OnlineFitter`
    wraps a live :class:`repro_torch.core.streaming._StreamMachine`.
    ``observe(points)`` folds new data in through the same fold/cascade
    path the batch streaming executor uses (staging pool, in-place
    reservoir, index-bound key schedule); ``snapshot()`` re-finalizes the
    reservoir — levels 1..m-1 and the backend — into a fresh
    :class:`repro_torch.core.plan.FitResult` without stopping ingestion.
    A snapshot clones the reservoir prefix it reads and re-splits the key
    chain from the stored root, so a snapshot after zero observes equals
    the one-shot batch fit of the same stream bit for bit, and a later
    in-place fold cannot change an earlier snapshot.

:class:`RefreshPolicy`
    when a refreshed index is worth installing: points folded since the
    last install, cascades survived, and a drift proxy (served traffic's
    mean assign distance against the post-install baseline). Defaults
    come from the runtime config (``REPRO_TORCH_REFRESH_*``); zero
    disables a trigger.

:class:`RefreshDriver`
    observed traffic → fitter → policy → hot-swap: when the policy fires
    it snapshots, freezes a packed index, optionally persists it through
    an :class:`repro_torch.serve.artifacts.IndexStore`, and installs it
    with warmup into an :class:`repro_torch.serve.async_service.
    AsyncClusterService`; in-flight requests finish on the version they
    pinned at admission.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import runtime
from repro_torch.core.index import ClusterIndex, nearest_valid_prototype
from repro_torch.core.plan import (STREAMING_EXECUTORS, FitResult,
                                   _is_chunk_stream, _plan_scope,
                                   as_device_tensor, finalize_reduction,
                                   plan_fit)
from repro_torch.core.streaming import _host_f32, _StreamMachine

__all__ = ["OnlineFitter", "RefreshPolicy", "RefreshDriver"]


class OnlineFitter:
    """A streaming fit held open: fold forever, snapshot any time.

    ``source`` seeds the fitter and fixes the geometry — a resident
    (n, d) array (folded as one chunk, or sliced to ``chunk_n``) or any
    chunk iterable, as :func:`repro_torch.fit` accepts. The fitter
    resolves the :class:`FitPlan` a batch call would (``t``/``m``/
    ``backend`` plus any :func:`repro_torch.core.plan.plan_fit` keyword,
    ``device`` included), forces the streaming executor, and drains the
    seed through the ingestion loop. From then on:

    * :meth:`observe` pushes new points through the identical
      fold/cascade path (oversized batches are sliced to ``chunk_n``);
    * :meth:`snapshot` returns a fresh :class:`FitResult` over
      everything folded so far — ingestion continues unaffected.

    Every device interaction runs under the plan's pinned config scope
    (:func:`repro_torch.core.plan._plan_scope`), so a snapshot is
    bit-identical to what :func:`repro_torch.core.plan.execute_plan` gives
    on the same chunk sequence.
    """

    def __init__(
        self,
        source: Any,
        t: int,
        m: int,
        backend: str = "kmeans",
        **fit_kwargs: Any,
    ):
        resident = not _is_chunk_stream(source)
        if resident:
            arr = _host_f32(source)  # a resident seed is host data
            source = iter([arr])  # a one-chunk stream, re-sliced below
        plan = plan_fit(source, t, m, backend, driver="online_fitter",
                        **fit_kwargs)
        if resident and plan.chunk_n and arr.shape[0] > plan.chunk_n:
            cn = plan.chunk_n  # honour the configured chunk geometry
            source = iter([arr[lo:lo + cn]
                           for lo in range(0, arr.shape[0], cn)])
        if plan.executor not in STREAMING_EXECUTORS:
            raise ValueError(
                f"OnlineFitter needs a streaming executor, but the plan "
                f"resolved {plan.executor!r}; drop the executor= override "
                f"(the fitter picks streaming/streaming_sharded itself)")
        self.plan = plan
        self._n_snapshots = 0
        with _plan_scope(plan):
            machine, first, rest = _StreamMachine.open_stream(plan, source)
            machine.ingest(rest, first=first)
        self._machine = machine

    # ---- ingestion --------------------------------------------------------

    def observe(self, points: Any) -> int:
        """Fold a batch of new points into the live reservoir; returns the
        number of valid rows folded.

        ``points`` is an (n, d) host array or a ``(chunk, n_valid)`` pair. Batches larger than the stream's
        ``chunk_n`` are sliced and folded as consecutive chunks — each at
        the next index of the key schedule, so an observe-split stream
        folds exactly like the same data pre-chunked.
        """
        if (isinstance(points, (tuple, list)) and len(points) == 2):
            arr, n_valid = points
            arr = _host_f32(arr)
            n_valid = int(n_valid)
        else:
            arr = _host_f32(points)
            n_valid = arr.shape[0]
        cn = self._machine.chunk_n
        folded = 0
        with _plan_scope(self.plan):
            for lo in range(0, max(arr.shape[0], 1), cn):
                sub = arr[lo:lo + cn]
                sub_valid = min(max(n_valid - lo, 0), sub.shape[0])
                folded += self._machine.feed((sub, sub_valid))
        return folded

    # ---- snapshot ---------------------------------------------------------

    def snapshot(self) -> FitResult:
        """Re-finalize the live reservoir into a fresh
        :class:`FitResult` — levels 1..m-1, backend, label back-out —
        without stopping ingestion.

        The machine's state is untouched: the reservoir prefix is cloned
        before any level step (a later in-place fold cannot change the
        snapshot), the key chain is re-split from the stored root (not
        consumed), and the spill maps are composed over frozen copies.
        Calling this with zero intervening observes repeatedly returns
        bitwise-identical results.
        """
        with _plan_scope(self.plan):
            red = self._machine.finalize(snapshot=True)
            result = finalize_reduction(self.plan, red)
        self._n_snapshots += 1
        return result

    def build_index(self, *, pack: bool = True) -> ClusterIndex:
        """Snapshot and freeze in one hop (the refresh path's artifact)."""
        return ClusterIndex.build(self.snapshot(), pack=pack)

    # ---- introspection ----------------------------------------------------

    @property
    def n_points(self) -> int:
        """Valid rows folded so far (seed + every observe)."""
        return self._machine.n_points

    @property
    def n_chunks(self) -> int:
        return self._machine.n_chunks

    @property
    def n_cascades(self) -> int:
        return self._machine.n_cascades

    @property
    def stats(self) -> Dict[str, Any]:
        m = self._machine
        return {
            "executor": self.plan.executor,
            "n_points": m.n_points,
            "n_chunks": m.n_chunks,
            "n_cascades": m.n_cascades,
            "frontier": m.frontier,
            "reservoir_n": m.reservoir_n,
            "chunk_n": m.chunk_n,
            "n_snapshots": self._n_snapshots,
        }

    def __repr__(self) -> str:
        s = self.stats
        return (f"OnlineFitter(executor={s['executor']!r}, "
                f"n_points={s['n_points']}, n_chunks={s['n_chunks']}, "
                f"n_cascades={s['n_cascades']}, "
                f"frontier={s['frontier']}/{s['reservoir_n']})")


@dataclass(frozen=True)
class RefreshPolicy:
    """When is a refreshed index worth installing? Three independent
    triggers, each disabled at zero:

    ``max_points``
        refresh once this many valid rows have been folded since the
        last install (volume: enough new evidence to matter);
    ``max_cascades``
        refresh once the reservoir has cascaded this many times since
        the last install (churn: a cascade compresses level-0 detail, so
        the *served* index lags the reservoir's summary);
    ``drift_ratio``
        refresh once the drift proxy — an EMA of observed traffic's mean
        assign distance against the *served* index, normalized by the
        post-install baseline — exceeds ``1 + drift_ratio`` (quality:
        traffic has moved away from the prototypes serving it).
    """

    max_points: int = 0
    max_cascades: int = 0
    drift_ratio: float = 0.0

    @classmethod
    def from_config(cls, cfg=None) -> "RefreshPolicy":
        """The policy the runtime config describes
        (``refresh_max_points`` / ``refresh_max_cascades`` /
        ``refresh_drift_ratio``, env-overridable as
        ``REPRO_TORCH_REFRESH_*``)."""
        cfg = runtime.active() if cfg is None else cfg
        return cls(max_points=cfg.refresh_max_points,
                   max_cascades=cfg.refresh_max_cascades,
                   drift_ratio=cfg.refresh_drift_ratio)

    @property
    def enabled(self) -> bool:
        return (self.max_points > 0 or self.max_cascades > 0
                or self.drift_ratio > 0)

    def should_refresh(self, *, points_since: int, cascades_since: int,
                       drift: Optional[float]) -> Optional[str]:
        """The first trigger that fires, or None. ``drift`` is the
        baseline-normalized proxy (None until a baseline exists)."""
        if self.max_points > 0 and points_since >= self.max_points:
            return "max_points"
        if self.max_cascades > 0 and cascades_since >= self.max_cascades:
            return "max_cascades"
        if (self.drift_ratio > 0 and drift is not None
                and drift >= 1.0 + self.drift_ratio):
            return "drift_ratio"
        return None


class RefreshDriver:
    """Close the loop: observed traffic → fitter → policy → hot-swap.

    The driver sits beside a serving
    :class:`repro_torch.serve.async_service.AsyncClusterService` (the traffic
    path never goes through it). Feed each observed batch to
    :meth:`observe`: the driver scores it against the tenant's *served*
    index (the drift proxy), folds it into the :class:`OnlineFitter`,
    and asks the :class:`RefreshPolicy` whether to refresh. A firing
    trigger — or an explicit :meth:`refresh` — snapshots the fitter,
    freezes a packed index, optionally persists it to an
    :class:`repro_torch.serve.artifacts.IndexStore`, and installs it with
    warmup; the swap is atomic and in-flight requests finish on their
    admitted version. The drift baseline resets at each
    install, so the proxy always measures drift *since the serving index
    last caught up*.
    """

    def __init__(
        self,
        service,
        fitter: OnlineFitter,
        *,
        tenant: Optional[str] = None,
        policy: Optional[RefreshPolicy] = None,
        store=None,
        warmup: bool = True,
        drift_alpha: float = 0.2,
    ):
        if not 0 < drift_alpha <= 1:
            raise ValueError(f"drift_alpha must be in (0, 1], "
                             f"got {drift_alpha}")
        self.service = service
        self.fitter = fitter
        self.tenant = tenant
        self.policy = policy if policy is not None else RefreshPolicy.from_config()
        self.store = store
        self.warmup = warmup
        self.drift_alpha = drift_alpha
        self._points_mark = fitter.n_points
        self._cascades_mark = fitter.n_cascades
        self._ema: Optional[float] = None
        self._baseline: Optional[float] = None
        self.history: List[Tuple[int, str]] = []  # (version, trigger)

    # ---- drift proxy ------------------------------------------------------

    @property
    def drift(self) -> Optional[float]:
        """EMA mean assign distance / post-install baseline (None until
        both exist). 1.0 ≈ traffic looks like it did right after the
        last install; rising values mean the served index is going stale."""
        if self._ema is None or not self._baseline:
            return None
        return self._ema / self._baseline

    def _update_drift(self, arr: np.ndarray) -> None:
        if arr.shape[0] == 0:
            return
        index = self.service.current_index(self.tenant)
        dist, _ = nearest_valid_prototype(
            as_device_tensor(arr, index.device), index.protos,
            index.proto_valid)
        # one scalar readback per observed batch, off the request path
        # repro_torch: allow[HS202]: one scalar a batch, off the request path (the drift estimate)
        mean = float(torch.sqrt(torch.clamp_min(dist, 0.0)).mean())
        a = self.drift_alpha
        self._ema = mean if self._ema is None else a * mean + (1 - a) * self._ema
        if self._baseline is None:
            self._baseline = mean  # first traffic after an install

    # ---- the loop ---------------------------------------------------------

    def observe(self, points: Any) -> Optional[int]:
        """Score ``points`` against the served index, fold them into the
        fitter, refresh if the policy fires. Returns the new version when
        a refresh happened, else None."""
        arr = _host_f32(points)  # observed traffic is host data
        self._update_drift(arr)
        self.fitter.observe(arr)
        trigger = self.policy.should_refresh(
            points_since=self.fitter.n_points - self._points_mark,
            cascades_since=self.fitter.n_cascades - self._cascades_mark,
            drift=self.drift)
        if trigger is None:
            return None
        return self.refresh(trigger=trigger)

    def refresh(self, *, trigger: str = "manual") -> int:
        """Snapshot → freeze (packed) → persist (if a store is attached)
        → atomic warm hot-swap. Returns the installed version."""
        index = self.fitter.build_index(pack=True)
        if self.store is not None:
            self.store.save(index, metadata={
                "trigger": trigger,
                "n_points": self.fitter.n_points,
                "n_cascades": self.fitter.n_cascades,
            })
        tenant = (self.tenant if self.tenant is not None
                  else self.service._default_tenant)
        version = self.service.install_index(tenant, index,
                                             warmup=self.warmup)
        self._points_mark = self.fitter.n_points
        self._cascades_mark = self.fitter.n_cascades
        self._ema = None       # the proxy restarts against the new index
        self._baseline = None  # first post-install batch re-baselines
        self.history.append((version, trigger))
        return version

    @property
    def stats(self) -> Dict[str, Any]:
        return {
            "points_since_install": self.fitter.n_points - self._points_mark,
            "cascades_since_install": (self.fitter.n_cascades
                                       - self._cascades_mark),
            "drift": self.drift,
            "refreshes": len(self.history),
            "history": list(self.history),
        }
