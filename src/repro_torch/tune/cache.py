"""Persistent tuning cache: measured dispatch winners, keyed by hardware.

The port of ``repro.tune.cache``, with the same file schema (version 1)
and key layout, so either package reads a file the other wrote. One JSON
file maps ``device_kind|kernel|shape_bucket|dtype`` to the winning
parameter dict the autotuner measured for that cell, with the
measurement's metadata. Deleting the file restores the hand-picked
constants and route rules everywhere.

  * ``device_kind`` — ``torch.cuda.get_device_name()`` of the card ("NVIDIA
    H100 80GB HBM3", ...), or "cpu": winners never leak across hardware;
  * ``kernel``      — the cell name ("knn", "pairwise_sq_l2",
    "segment_sum", "knn_block", "stream", "assign");
  * ``shape_bucket`` — every dimension rounded up to a power of two
    (:func:`shape_bucket`), so one measurement covers a bucket of sizes;
  * ``dtype``       — the input element type's name ("float32", ...).

The port's default file is its own (:func:`default_cache_path`): sharing
the reference's would let the port's stale gate prune the reference's
"pallas" winners recorded under the shared "cpu" kind.

Stdlib-only at import: ``RuntimeConfig.dispatch_key()`` reads
:func:`cache_epoch` from here, a process-wide counter bumped on every
mutation or reload of the active cache.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Iterator, Optional, Tuple

SCHEMA_VERSION = 1

_KEY_SEP = "|"


def default_cache_path() -> str:
    """``$REPRO_TORCH_TUNE_CACHE``, else ``~/.cache/repro_torch/tune_cache.json``
    (read at each call, by the runtime config)."""
    from repro_torch.runtime.config import tune_cache_path  # the env reads live there

    return tune_cache_path()


def make_key(device_kind: str, kernel: str, shape_bucket: str,
             dtype: str) -> str:
    for part in (device_kind, kernel, shape_bucket, dtype):
        if _KEY_SEP in part:
            raise ValueError(f"cache key part {part!r} contains {_KEY_SEP!r}")
    return _KEY_SEP.join((device_kind, kernel, shape_bucket, dtype))


def split_key(key: str) -> Tuple[str, str, str, str]:
    device_kind, kernel, shape_bucket, dtype = key.split(_KEY_SEP)
    return device_kind, kernel, shape_bucket, dtype


def pow2_bucket(v: int) -> int:
    """Smallest power of two >= max(v, 1): the bucket edge a dimension
    rounds up to, so a winner measured at the edge covers the bucket."""
    v = max(int(v), 1)
    return 1 << (v - 1).bit_length()


def shape_bucket(**dims: int) -> str:
    """Canonical bucket string: dims sorted by name, each pow2-rounded.
    ``shape_bucket(n=3000, d=5)`` → ``"d8,n4096"``; no dims → ``"any"``."""
    if not dims:
        return "any"
    return ",".join(f"{k}{pow2_bucket(v)}" for k, v in sorted(dims.items()))


class TuningCache:
    """On-disk JSON map of measured winners. Loaded lazily, saved eagerly:
    every :meth:`record` persists (atomic rename), so a crashed tuning run
    keeps everything measured so far. Lookups from several threads (the
    async serve front-end's) share one instance; mutations hold its lock."""

    def __init__(self, path: Optional[str] = None):
        self.path = default_cache_path() if path is None else path
        self._entries: Optional[Dict[str, dict]] = None
        self._mu = threading.RLock()

    # ---- persistence ------------------------------------------------------

    def _load(self) -> Dict[str, dict]:
        entries = self._entries
        if entries is not None:
            return entries
        with self._mu:
            if self._entries is None:
                try:
                    with open(self.path) as f:
                        blob = json.load(f)
                    if blob.get("version") != SCHEMA_VERSION:
                        self._entries = {}
                    else:
                        self._entries = dict(blob.get("entries", {}))
                except (OSError, ValueError):
                    self._entries = {}
            return self._entries

    def save(self) -> None:
        with self._mu:
            entries = self._load()
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"version": SCHEMA_VERSION, "entries": entries},
                          f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)

    def reload(self) -> None:
        """Drop the in-memory view and re-read the file on next access."""
        with self._mu:
            self._entries = None
        bump_epoch()

    # ---- lookup / record --------------------------------------------------

    def lookup(self, device_kind: str, kernel: str, shape_bucket: str,
               dtype: str = "float32") -> Optional[Dict[str, Any]]:
        """The winning params dict for one cell, or None on a miss."""
        rec = self._load().get(make_key(device_kind, kernel, shape_bucket,
                                        dtype))
        return dict(rec["params"]) if rec else None

    def record(self, device_kind: str, kernel: str, shape_bucket: str,
               params: Dict[str, Any], *, dtype: str = "float32",
               seconds: Optional[float] = None, candidates: int = 0,
               save: bool = True) -> None:
        """Store one measured winner (and persist unless ``save=False``)."""
        with self._mu:
            entries = self._load()
            entries[make_key(device_kind, kernel, shape_bucket, dtype)] = {
                "params": dict(params),
                "seconds": seconds,
                "candidates": int(candidates),
                "recorded_unix": round(time.time(), 1),
            }
            bump_epoch()
            if save:
                self.save()

    # ---- maintenance ------------------------------------------------------

    def discard(self, device_kind: str, kernel: str, shape_bucket: str,
                dtype: str = "float32", *, save: bool = True) -> bool:
        """Drop one entry by exact key (the stale gate of
        :func:`repro_torch.tune.tuned_params` prunes with it). Returns
        whether anything was removed."""
        with self._mu:
            entries = self._load()
            key = make_key(device_kind, kernel, shape_bucket, dtype)
            if key not in entries:
                return False
            del entries[key]
            bump_epoch()
            if save:
                self.save()
            return True

    def entries(self) -> Iterator[Tuple[Tuple[str, str, str, str], dict]]:
        """((device_kind, kernel, shape_bucket, dtype), record) pairs."""
        for key, rec in sorted(self._load().items()):
            yield split_key(key), rec

    def __len__(self) -> int:
        return len(self._load())

    def prune(self, *, max_age_days: Optional[float] = None,
              device_kind: Optional[str] = None,
              kernel: Optional[str] = None, save: bool = True) -> int:
        """Drop entries older than ``max_age_days`` and/or matching the
        given device kind / kernel filters; returns the dropped count."""
        with self._mu:
            entries = self._load()
            cutoff = (time.time() - max_age_days * 86400.0
                      if max_age_days is not None else None)
            drop = []
            for key, rec in entries.items():
                dk, kn, _, _ = split_key(key)
                if cutoff is not None and rec.get("recorded_unix", 0) >= cutoff:
                    continue
                if cutoff is None and device_kind is None and kernel is None:
                    continue  # pure filter mode: only drop what the filters name
                if device_kind is not None and dk != device_kind:
                    continue
                if kernel is not None and kn != kernel:
                    continue
                drop.append(key)
            for key in drop:
                del entries[key]
            if drop:
                bump_epoch()
                if save:
                    self.save()
            return len(drop)

    def clear(self, save: bool = True) -> int:
        with self._mu:
            entries = self._load()
            n = len(entries)
            entries.clear()
            bump_epoch()
            if save:
                self.save()
            return n


# the process-global active cache and the epoch counter dispatch_key() reads
_lock = threading.Lock()
_active: Optional[TuningCache] = None
_epoch = 0


def bump_epoch() -> int:
    global _epoch
    with _lock:
        _epoch += 1
        return _epoch


def cache_epoch() -> int:
    """Monotonic fingerprint of the active cache's mutation history,
    carried by ``RuntimeConfig.dispatch_key()`` when tuning is on."""
    return _epoch


def get_cache() -> TuningCache:
    """The process-global cache every tuned lookup consults."""
    global _active
    with _lock:
        if _active is None:
            _active = TuningCache()
        return _active


def set_cache(cache_or_path) -> TuningCache:
    """Swap the active cache (a TuningCache or a path); returns it and
    bumps the epoch."""
    global _active
    cache = (cache_or_path if isinstance(cache_or_path, TuningCache)
             else TuningCache(cache_or_path))
    with _lock:
        _active = cache
    bump_epoch()
    return cache
