"""The port's AsyncClusterService on the virtual clock of
``tests/serve_sim.py`` (stdlib and numpy only, reused as is): the cases of
``tests/test_async_service.py``, run against the port's scheduler and
indexes carried from the JAX package's fits.

Parity here is bitwise: every completed request's labels equal a direct
``ClusterIndex.assign`` of the port on the same points, and the JAX
index's own assign (the carried indexes serve the same labels on these
well-separated blobs).
"""
import asyncio
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.index import ClusterIndex as JIndex
from repro_torch import runtime
from repro_torch.core.index import ClusterIndex
from repro_torch.serve import async_service
from repro_torch.serve.async_service import (
    AsyncClusterService,
    QueueFullError,
    ServiceClosedError,
    UnknownTenantError,
)

from serve_sim import (
    BatchInvariantChecker,
    SimExecutor,
    SimLoop,
    adversarial_trace,
    bursty_trace,
    materialize,
    run_trace,
    trickle_trace,
)

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover - CI installs hypothesis
    given = None

torch.set_num_threads(1)


def _blobs(seed: int, n_per: int = 60, spread: float = 0.6,
           shift: float = 0.0) -> np.ndarray:
    """Three well-separated 2-D blobs; ``shift`` relocates the centres so
    indexes fit on different seeds/shifts label queries differently."""
    rng = np.random.default_rng(seed)
    centers = np.array([[0.0, 0.0], [6.0, 0.0], [3.0, 6.0]]) + shift
    x = np.concatenate([c + rng.normal(scale=spread, size=(n_per, 2))
                        for c in centers])
    return x.astype(np.float32)


_INDEX_CACHE = {}


def _jindex(seed: int = 0, shift: float = 0.0) -> JIndex:
    key = (seed, shift)
    if key not in _INDEX_CACHE:
        _INDEX_CACHE[key] = JIndex.build(
            jnp.asarray(_blobs(seed, shift=shift)), 2, 1, "kmeans", k=3,
            key=jax.random.PRNGKey(seed))
    return _INDEX_CACHE[key]


def _index(seed: int = 0, shift: float = 0.0) -> ClusterIndex:
    """The JAX index of (seed, shift), carried into the port (packed)."""
    j = _jindex(seed, shift)
    return ClusterIndex.from_numpy(
        {f: np.asarray(getattr(j, f)) for f in j._fields
         if getattr(j, f) is not None}, device="cpu")


def _assign(index: ClusterIndex, q: np.ndarray) -> np.ndarray:
    return index.assign(q).numpy()


def _queries(seed: int):
    pool = _blobs(seed + 100, n_per=80)
    rng = np.random.default_rng(seed)

    def data_fn(n: int) -> np.ndarray:
        idx = rng.integers(0, pool.shape[0], size=n)
        return pool[idx]

    return data_fn


def _service(indexes, loop, *, service_time=1.0, fail_when=None, **kw):
    executor = SimExecutor(loop, service_time=service_time,
                           fail_when=fail_when)
    svc = AsyncClusterService(indexes, loop=loop, executor=executor, **kw)
    return svc, executor


def _assert_parity(records, index_map, default_tenant="default"):
    """Every non-rejected request completed with labels bit-identical to a
    direct ClusterIndex.assign on the same points (the port's, and the JAX
    index it was carried from) — nothing dropped, duplicated,
    cross-tenant-routed, or perturbed by batch co-tenants."""
    for rec in records:
        assert rec.error is None, f"unexpected rejection: {rec.error}"
        assert rec.future is not None and rec.future.done(), (
            f"request at t={rec.t_arrival} never completed")
        got = rec.future.result()
        assert got.dtype == np.int32
        if rec.queries.shape[0] == 0:
            assert got.shape == (0,)
            continue
        index = index_map[rec.tenant or default_tenant]
        np.testing.assert_array_equal(got, _assign(index, rec.queries))
        jidx = _JAX_OF[id(index)]
        np.testing.assert_array_equal(
            got, np.asarray(jidx.assign(jnp.asarray(rec.queries))))


_JAX_OF = {}


def _tracked(seed: int = 0, shift: float = 0.0) -> ClusterIndex:
    idx = _index(seed, shift)
    _JAX_OF[id(idx)] = _jindex(seed, shift)
    return idx


def _I0() -> ClusterIndex:
    return _cached("i0", lambda: _tracked(0))


def _I7() -> ClusterIndex:
    return _cached("i7", lambda: _tracked(7, shift=1.5))


_CARRIED = {}


def _cached(name, make):
    if name not in _CARRIED:
        _CARRIED[name] = make()
    return _CARRIED[name]


# ----------------------------------------------------------------------
# batch-fill invariants across arrival shapes


def test_bursty_trace_fills_batches_and_holds_invariants():
    loop = SimLoop()
    checker = BatchInvariantChecker(buckets=(4, 16), max_wait=5.0)
    svc, _ = _service(_I0(), loop, buckets=(4, 16), max_wait=5.0,
                      max_inflight=99, queue_depth=10_000,
                      observer=checker)
    trace = bursty_trace(n_bursts=6, burst_size=5, sizes=(8, 8, 5, 7, 4),
                         gap=20.0)
    records = run_trace(svc, loop, materialize(trace, _queries(1)))
    checker.check()
    _assert_parity(records, {"default": _I0()})
    # bursts of 32 points into a 16-capacity ladder: real coalescing
    # happened (fewer batches than requests) and FIFO packing fills the
    # bucket exactly (8+8, then 5+7+4)
    assert svc.stats["batches"] < svc.stats["requests"]
    assert any(r.total == 16 for r in checker.records)
    assert svc.stats["completed"] == len(records)


def test_trickle_trace_flushes_on_deadline_not_fill():
    loop = SimLoop()
    checker = BatchInvariantChecker(buckets=(8, 32), max_wait=4.0)
    svc, _ = _service(_I0(), loop, buckets=(8, 32), max_wait=4.0,
                      max_inflight=99, queue_depth=10_000,
                      observer=checker)
    trace = trickle_trace(n_requests=7, gap=10.0, size=3)
    records = run_trace(svc, loop, materialize(trace, _queries(2)))
    checker.check()
    _assert_parity(records, {"default": _I0()})
    # gap > max_wait: every request rode its own deadline-flushed batch,
    # dispatched exactly max_wait after admission (virtual time is exact)
    assert len(checker.records) == 7
    for rec in checker.records:
        (_rid, _n, t_admit), = rec.segments
        assert rec.t_dispatch - t_admit == pytest.approx(4.0)


def test_full_bucket_dispatches_immediately_without_waiting():
    loop = SimLoop()
    checker = BatchInvariantChecker(buckets=(4, 16), max_wait=50.0)
    svc, _ = _service(_I0(), loop, buckets=(4, 16), max_wait=50.0,
                      max_inflight=99, queue_depth=10_000,
                      observer=checker)
    arrivals = materialize([(3.0, None, 16)], _queries(3))
    records = run_trace(svc, loop, arrivals)
    checker.check()
    _assert_parity(records, {"default": _I0()})
    (rec,) = checker.records
    assert rec.t_dispatch == pytest.approx(3.0)  # no deadline wait
    assert rec.total == rec.bucket == 16


def test_adversarial_trace_multi_tenant_invariants_and_parity():
    loop = SimLoop()
    index_map = {"a": _I0(), "b": _I7()}
    checker = BatchInvariantChecker(buckets=(4, 16), max_wait=5.0,
                                    expect_versions={1})
    svc, _ = _service(index_map, loop, buckets=(4, 16), max_wait=5.0,
                      max_inflight=99, queue_depth=100_000,
                      observer=checker)
    rng = np.random.default_rng(42)
    trace = adversarial_trace(rng, n_requests=60, capacity=16, max_wait=5.0,
                              tenants=("a", "b"))
    records = run_trace(svc, loop, materialize(trace, _queries(4)))
    checker.check()
    _assert_parity(records, index_map)
    st_ = svc.stats
    assert st_["completed"] == len(records) == st_["requests"]
    assert st_["points"] == sum(r.queries.shape[0] for r in records)
    # the two tenants' indexes disagree somewhere (else cross-tenant
    # routing would be invisible to the parity check)
    q = _queries(5)(64)
    assert np.any(_assign(index_map["a"], q) != _assign(index_map["b"], q))


def test_oversized_request_splits_into_fifo_segments():
    loop = SimLoop()
    checker = BatchInvariantChecker(buckets=(4, 16), max_wait=5.0)
    svc, _ = _service(_I0(), loop, buckets=(4, 16), max_wait=5.0,
                      max_inflight=99, queue_depth=10_000,
                      observer=checker)
    records = run_trace(svc, loop, materialize([(0.0, None, 53)],
                                               _queries(6)))
    checker.check()
    _assert_parity(records, {"default": _I0()})
    # 53 rows through capacity 16: 3 full immediate batches + a 5-row tail
    totals = [r.total for r in checker.records]
    assert totals == [16, 16, 16, 5]


# ----------------------------------------------------------------------
# property test: async path ≡ direct assign for any arrival sequence

_SIZES = (0, 1, 2, 3, 5, 8, 13, 16, 17, 31)
_LADDERS = ((4, 16), (8,), (4, 8, 32))

_PINNED_CASES = [
    # (ladder_idx, max_wait, max_inflight, service_time, arrivals)
    (0, 2.0, 2, 1.0, [(0, "a", 3), (0, "b", 5), (1, "a", 16), (1, "a", 0),
                      (3, "b", 17), (9, "a", 31), (9, "b", 1), (9, "a", 2)]),
    (1, 0.0, 1, 3.0, [(0, "a", 8), (0, "a", 8), (2, "b", 13), (2, "a", 1),
                      (4, "b", 31), (5, "a", 5)]),
    (2, 5.0, 99, 0.5, [(i % 7, ("a", "b")[i % 2], _SIZES[i % len(_SIZES)])
                       for i in range(24)]),
]


def _run_parity_case(ladder_idx, max_wait, max_inflight, service_time,
                     arrivals):
    loop = SimLoop()
    buckets = _LADDERS[ladder_idx]
    index_map = {"a": _I0(), "b": _I7()}
    svc, _ = _service(index_map, loop, buckets=buckets, max_wait=max_wait,
                      max_inflight=max_inflight, queue_depth=1_000_000,
                      service_time=service_time)
    data_fn = _queries(8)
    records = run_trace(
        svc, loop,
        [(float(t), tenant, data_fn(n)) for t, tenant, n in arrivals])
    _assert_parity(records, index_map)
    stats = svc.stats
    assert stats["requests"] == len(arrivals)
    assert stats["completed"] == len(arrivals)  # none dropped
    assert stats["points"] == sum(n for _, _, n in arrivals)  # none duped
    assert stats["rejected"] == stats["cancelled"] == stats["failed"] == 0


def test_pinned_parity_cases():
    for case in _PINNED_CASES:
        _run_parity_case(*case)


if given is not None:
    @settings(max_examples=20, deadline=None)
    @given(
        ladder_idx=st.integers(0, len(_LADDERS) - 1),
        max_wait=st.sampled_from([0.0, 2.0, 5.0]),
        max_inflight=st.sampled_from([1, 2, 99]),
        service_time=st.sampled_from([0.5, 1.0, 3.0]),
        arrivals=st.lists(
            st.tuples(st.integers(0, 40),
                      st.sampled_from(["a", "b"]),
                      st.sampled_from(_SIZES)),
            max_size=30),
    )
    def test_hypothesis_any_arrival_sequence_matches_direct_assign(
            ladder_idx, max_wait, max_inflight, service_time, arrivals):
        """For ANY arrival sequence and bucket config the async path is
        bit-identical to direct ClusterIndex.assign on the same points —
        no request dropped, duplicated, or cross-tenant-routed."""
        _run_parity_case(ladder_idx, max_wait, max_inflight, service_time,
                         sorted(arrivals))
else:  # pragma: no cover - CI installs hypothesis
    @pytest.mark.skip(reason="property sweep needs hypothesis "
                             "(pip install -r requirements-dev.txt); "
                             "pinned cases above ran instead")
    def test_hypothesis_any_arrival_sequence_matches_direct_assign():
        pass


# ----------------------------------------------------------------------
# backpressure / faults / lifecycle


def test_queue_full_rejection_is_loud_and_bounded():
    loop = SimLoop()
    svc, _ = _service(_I0(), loop, buckets=(16,), max_wait=5.0,
                      max_inflight=1, queue_depth=32, service_time=50.0)
    ok1 = svc.submit(_queries(9)(16))   # dispatches (fills the bucket)
    ok2 = svc.submit(_queries(9)(16))   # queued (inflight slot busy)
    ok3 = svc.submit(_queries(9)(16))   # queued: 32/32 points
    with pytest.raises(QueueFullError) as ei:
        svc.submit(_queries(9)(4))
    assert "admission queue full" in str(ei.value)
    assert "32/32" in str(ei.value)
    # an over-depth request is called out as never admittable
    with pytest.raises(QueueFullError) as ei2:
        svc.submit(_queries(9)(33))
    assert "can never be admitted" in str(ei2.value)
    assert svc.stats["rejected"] == 2
    loop.run()
    # rejection cost nothing: every admitted request still completed
    assert all(f.done() and f.result().shape == (16,)
               for f in (ok1, ok2, ok3))
    assert svc.stats["completed"] == 3
    # bounded concurrency held across the backlog
    assert svc.stats["batches"] == 3


def test_max_inflight_is_respected():
    loop = SimLoop()
    svc, executor = _service(_I0(), loop, buckets=(8,), max_wait=0.0,
                             max_inflight=2, queue_depth=10_000,
                             service_time=10.0)
    for _ in range(6):
        svc.submit(_queries(10)(8))
    loop.run()
    assert executor.max_inflight_seen == 2
    assert svc.stats["completed"] == 6


def test_cancellation_of_queued_and_inflight_requests():
    loop = SimLoop()
    checker = BatchInvariantChecker(buckets=(16,), max_wait=5.0,
                                    check_wait=False)
    svc, _ = _service(_I0(), loop, buckets=(16,), max_wait=5.0,
                      max_inflight=1, queue_depth=10_000, service_time=10.0,
                      observer=checker)
    data = _queries(11)
    f_inflight = svc.submit(data(16))  # dispatches immediately
    f_queued = svc.submit(data(16))    # waits for the inflight slot
    f_kept = svc.submit(data(16))
    assert f_inflight.cancel()  # already on device: result discarded
    assert f_queued.cancel()    # still queued: never dispatched
    loop.run()
    assert f_inflight.cancelled() and f_queued.cancelled()
    assert f_kept.done() and f_kept.result().shape == (16,)
    assert svc.stats["cancelled"] == 2
    assert svc.stats["completed"] == 1
    # the queued-cancelled request never reached a batch
    dispatched_rids = [rid for rec in checker.records
                       for rid, _, _ in rec.segments]
    assert sorted(dispatched_rids) == [0, 2]


def test_batch_execution_fault_fails_only_its_requests():
    loop = SimLoop()
    svc, _ = _service(_I0(), loop, buckets=(16,), max_wait=0.0,
                      max_inflight=99, queue_depth=10_000,
                      fail_when=lambda ordinal: ordinal == 0)
    data = _queries(12)
    f_bad = svc.submit(data(16))
    f_good = svc.submit(data(16))
    loop.run()
    with pytest.raises(RuntimeError, match="injected batch fault"):
        f_bad.result()
    assert f_good.done() and f_good.exception() is None
    assert svc.stats["failed"] == 1 and svc.stats["completed"] == 1


def test_drain_completes_all_admitted_work_then_closes():
    loop = SimLoop()
    checker = BatchInvariantChecker(buckets=(4, 16), max_wait=100.0,
                                    check_wait=False)
    svc, executor = _service(_I0(), loop, buckets=(4, 16),
                             max_wait=100.0, max_inflight=1,
                             queue_depth=10_000, service_time=2.0,
                             observer=checker)
    data = _queries(13)
    futures = [svc.submit(data(n)) for n in (16, 7, 3, 16, 2)]
    loop.run(until=1.0)  # first batch in flight, the rest queued/waiting
    drain = svc.drain()
    with pytest.raises(ServiceClosedError):
        svc.submit(data(1))
    with pytest.raises(ServiceClosedError):
        svc.install_index("default", _I0())
    loop.run()
    assert drain.done()
    final = drain.result()
    assert final["completed"] == len(futures)
    assert all(f.done() and f.exception() is None for f in futures)
    # the 100-virtual-ms deadline never fired: drain flushed the partial
    # batches immediately (total virtual time ≈ batches * service_time)
    assert loop.now() < 100.0
    checker.check()
    assert svc.closed
    # drain is idempotent: same future back
    assert svc.drain() is drain


def test_unknown_tenant_and_empty_request():
    loop = SimLoop()
    svc, _ = _service(_I0(), loop, buckets=(8,), max_wait=1.0)
    with pytest.raises(UnknownTenantError, match="unknown tenant 'nope'"):
        svc.submit(_queries(14)(4), tenant="nope")
    f = svc.submit(np.zeros((0, 2), np.float32))
    assert f.done() and f.result().shape == (0,)
    assert f.result().dtype == np.int32
    assert svc.stats["points"] == 0 and svc.stats["completed"] == 1


# ----------------------------------------------------------------------
# hot-swapped index versions


def test_hot_swap_is_atomic_and_pins_admitted_requests():
    loop = SimLoop()
    checker = BatchInvariantChecker(buckets=(16,), max_wait=50.0,
                                    check_wait=False,
                                    expect_versions={1, 2})
    v1, v2 = _I0(), _I7()
    svc, _ = _service(v1, loop, buckets=(16,), max_wait=50.0,
                      max_inflight=99, queue_depth=10_000, service_time=5.0,
                      observer=checker)
    data = _queries(15)
    q_old, q_new = data(7), data(7)
    f_old = svc.submit(q_old)       # pinned to v1, waiting to fill
    assert svc.version() == 1
    assert svc.install_index("default", v2) == 2
    f_new = svc.submit(q_new)       # admitted post-swap: pinned to v2
    loop.run()
    # the pre-swap request was NOT retargeted (served by v1), the post-swap
    # one by v2, and no batch mixed versions
    np.testing.assert_array_equal(f_old.result(), _assign(v1, q_old))
    np.testing.assert_array_equal(f_new.result(), _assign(v2, q_new))
    checker.check()
    versions = [rec.version for rec in checker.records]
    assert versions == [1, 2]
    # the superseded v1 batch flushed at the swap, not at its 50ms deadline
    assert checker.records[0].t_dispatch < 50.0
    assert svc.stats["swaps"] == 1
    assert svc.tenant_stats()["default"]["version"] == 2


def test_half_installed_artifact_is_never_served():
    loop = SimLoop()
    svc, _ = _service(_I0(), loop, buckets=(8,), max_wait=1.0)
    good = _I0()
    torn = good._replace(proto_mass=good.proto_mass[:3])  # wrong length
    with pytest.raises(ValueError, match="proto_mass"):
        svc.install_index("default", torn)
    # a dim-changing swap is rejected too (live traffic would crash)
    wide = ClusterIndex.build(
        np.random.default_rng(0).normal(size=(60, 3)).astype(np.float32),
        2, 1, "kmeans", k=2, device="cpu")
    with pytest.raises(ValueError, match="feature dimension"):
        svc.install_index("default", wide)
    # both failed installs left version 1 serving, untouched
    assert svc.version() == 1
    q = _queries(16)(4)
    f = svc.submit(q)
    loop.run()
    assert f.done() and f.exception() is None
    np.testing.assert_array_equal(f.result(), _assign(_I0(), q))


# ----------------------------------------------------------------------
# real-asyncio adapter (correctness only — no timing assertions)


def test_asyncio_adapter_end_to_end():
    """The default (asyncio) bindings run the identical scheduler: submit
    under asyncio.run, await results, drain. Correctness-only — timing
    claims live in the simulated tests above."""
    index = _I0()
    svc = AsyncClusterService(index, buckets=(4, 16), max_wait=0.001,
                              max_inflight=2, queue_depth=10_000)
    data = _queries(17)
    batches = [data(n) for n in (3, 16, 7, 0, 17)]

    async def main():
        futs = [svc.submit(q) for q in batches]
        results = await asyncio.gather(*futs)
        final = await svc.drain()
        return results, final

    results, final = asyncio.run(main())
    for q, got in zip(batches, results, strict=True):
        np.testing.assert_array_equal(got, _assign(index, q))
    assert final["completed"] == len(batches)
    with pytest.raises(ServiceClosedError):
        svc.submit(batches[0])


def test_scheduler_has_no_wall_clock_dependence():
    """The determinism contract, enforced structurally: the scheduler
    module never reaches for a wall clock or a real sleep — all timing
    goes through the injected loop seams."""
    src = inspect.getsource(async_service)
    for forbidden in ("time.sleep", "time.time", "perf_counter",
                      "monotonic", "sleep("):
        assert forbidden not in src, f"scheduler uses {forbidden}"


def test_runtime_config_defaults_flow_into_service():
    loop = SimLoop()
    with runtime.configure(serve_queue_depth=77, serve_max_inflight=3,
                           serve_max_wait_ms=250.0,
                           serve_default_tenant="main"):
        svc = AsyncClusterService(_I0(), loop=loop,
                                  executor=SimExecutor(loop),
                                  buckets=(8,), warmup=False)
        assert svc.queue_depth == 77
        assert svc.max_inflight == 3
        assert svc.max_wait == pytest.approx(0.25)  # ms knob → loop seconds
        assert svc.tenants == ("main",)
        f = svc.submit(_queries(18)(4))  # default tenant routing
        loop.run()
        assert f.done()
