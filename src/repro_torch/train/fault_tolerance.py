"""Fault tolerance: step retry, straggler telemetry, deterministic resume
— the port of ``repro.train.fault_tolerance`` (host Python).

The failure model: (a) transient step failures → bounded retry; (b) hard
node loss → restart from the last checkpoint; (c) stragglers → detected
from step-time quantiles. The data pipeline is a pure function of step,
so any restart replays exactly — no data state to recover.

On a mesh of data ranks every rank runs the same loop: the retry is
decided by the pure ``failure_hook(step, attempt)`` before the step starts,
so every rank retries the same step before any collective, and the
checkpoints are collective (``mesh=`` and the state's ``opt_specs=`` go
to ``CheckpointManager.save``), so a run restored on another number of data
ranks continues bit for bit.

A step's metrics stay device tensors until ``on_metrics`` reads them, so
the loop waits on the card only where a caller reads a number. The times
:class:`StepStats` records are host walls of ``step_fn``: on the card
they cover the device work only if the step function synchronises.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np


class TransientError(RuntimeError):
    """Injected/recoverable failure (preemption, link flap)."""


@dataclass
class StepStats:
    times: List[float] = field(default_factory=list)
    retries: int = 0
    failures: int = 0

    def record(self, dt: float) -> None:
        self.times.append(dt)

    def quantiles(self) -> Dict[str, float]:
        if not self.times:
            return {}
        t = np.asarray(self.times)
        return {
            "p50": float(np.quantile(t, 0.5)),
            "p95": float(np.quantile(t, 0.95)),
            "p99": float(np.quantile(t, 0.99)),
            "max": float(t.max()),
        }

    def stragglers(self, factor: float = 3.0) -> int:
        """Steps slower than factor × median — the straggler signal a
        deployment feeds back to its job scheduler."""
        if len(self.times) < 4:
            return 0
        t = np.asarray(self.times)
        return int(np.sum(t > factor * np.median(t)))


class StepGuard:
    """Wraps a step function with retry + timing. ``failure_hook`` lets tests
    inject TransientError deterministically."""

    def __init__(
        self,
        step_fn: Callable,
        *,
        max_retries: int = 3,
        failure_hook: Optional[Callable[[int, int], bool]] = None,
    ):
        self.step_fn = step_fn
        self.max_retries = max_retries
        self.failure_hook = failure_hook
        self.stats = StepStats()

    def __call__(self, step: int, *args, **kwargs):
        attempt = 0
        while True:
            t0 = time.perf_counter()
            try:
                if self.failure_hook is not None and self.failure_hook(step, attempt):
                    raise TransientError(f"injected failure at step {step}")
                out = self.step_fn(*args, **kwargs)
                self.stats.record(time.perf_counter() - t0)
                return out
            except TransientError:
                self.stats.failures += 1
                attempt += 1
                if attempt > self.max_retries:
                    raise
                self.stats.retries += 1


def run_training(
    *,
    train_step: Callable,
    init_state: Any,                      # (model, opt_state)
    batch_for_step: Callable[[int], Any],  # pure: step -> batch
    n_steps: int,
    ckpt=None,
    ckpt_every: int = 0,
    start_step: int = 0,
    guard_kwargs: Optional[dict] = None,
    on_metrics: Optional[Callable[[int, dict], None]] = None,
    mesh=None,
    opt_specs: Optional[dict] = None,
):
    """The fault-tolerant loop: pure data, guarded step, periodic async
    checkpoints (on ``mesh``, with the optimizer state's ZeRO
    ``opt_specs``: collective).
    Returns (model, opt_state, stats)."""
    params, opt_state = init_state
    guard = StepGuard(train_step, **(guard_kwargs or {}))
    for step in range(start_step, n_steps):
        batch = batch_for_step(step)
        params, opt_state, mets = guard(step, params, opt_state, batch)
        if on_metrics is not None:
            on_metrics(step, mets)
        if ckpt is not None and ckpt_every and (step + 1) % ckpt_every == 0:
            ckpt.save(step + 1, {"params": params, "opt": opt_state}, async_=True,
                      mesh=mesh, specs={"opt": opt_specs})
    if ckpt is not None:
        ckpt.wait()
    return params, opt_state, guard.stats
