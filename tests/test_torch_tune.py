"""``repro_torch.tune`` and the runtime's dispatch hooks against ``repro.tune``.

The behaviours of ``tests/test_tune.py``, each held against the reference
where both packages compute the same thing (shape buckets, the cache file
either package writes, candidate lists on the CPU, stale reasons, the
fields ``plan_fit`` freezes from the same entries under the device kind
"cpu"), plus the port's own: the card's candidate lists (plain functions
here), the stale gate under a card's kind, the runtime's default-config
helpers, the multi-device executors refused, and a CPU fit under
``tune="cached"`` bit for bit equal to the one under ``"off"``.
Tolerances: equality everywhere (labels, buckets, fields, candidate
lists); distances of the plain versions within 1e-5 where a tuned
dispatch runs another plain fold.
"""
import json
import threading
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.tune as jtune
import repro_torch
import repro_torch.tune as ttune
from repro import runtime as jruntime
from repro.core.plan import plan_fit as jplan_fit
from repro.tune import autotune as jautotune
from repro_torch import prng
from repro_torch import runtime
from repro_torch.core.knn import AUTO_KNN_BLOCK, resolve_auto_block
from repro_torch.core.plan import execute_plan, plan_fit
from repro_torch.kernels import fused_assign, ops, pairwise_l2, ref
from repro_torch.kernels import segment_sum as segsum
from repro_torch.runtime.config import RuntimeConfig, config_from_env
from repro_torch.tune import autotune
from repro_torch.tune.cache import TuningCache, make_key, split_key

torch.set_num_threads(1)

DK = "cpu"
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def caches(tmp_path):
    """Point both packages' process-global caches at throwaway files (two
    files: the port's stale gate must never prune the reference's);
    restore them after."""
    prev_t, prev_j = ttune.get_cache(), jtune.get_cache()
    t = ttune.set_cache(str(tmp_path / "port_cache.json"))
    j = jtune.set_cache(str(tmp_path / "ref_cache.json"))
    yield t, j
    ttune.set_cache(prev_t)
    jtune.set_cache(prev_j)


@pytest.fixture
def cache(caches):
    return caches[0]


def dyadic(rng, shape, scale=0.25, lim=16):
    return (rng.integers(-lim, lim + 1, size=shape) * scale).astype(np.float32)


def record_both(caches, kernel, params, **dims):
    for c, pkg in zip(caches, (ttune, jtune)):
        c.record(DK, kernel, pkg.shape_bucket(**dims), params)


# ----------------------------------------------------------- cache layer


@pytest.mark.parametrize("v", [0, 1, 2, 3, 5, 8, 1000, 1024, 1025, 581_012,
                               2 ** 20, 2 ** 20 + 1])
def test_pow2_bucket_and_shape_bucket(v):
    assert ttune.pow2_bucket(v) == jtune.pow2_bucket(v)
    dims = {"n": v + 3, "d": max(v % 97, 1), "k": v % 9}
    assert ttune.shape_bucket(**dims) == jtune.shape_bucket(**dims)
    assert ttune.shape_bucket(n=3000, d=5) == "d8,n4096"
    assert ttune.shape_bucket() == jtune.shape_bucket() == "any"


def test_cache_roundtrip_and_key_layout(tmp_path):
    path = str(tmp_path / "c.json")
    c = TuningCache(path)
    assert c.lookup(DK, "knn", "d8,n4096") is None
    c.record(DK, "knn", "d8,n4096", {"impl": "ref", "block_q": 128},
             seconds=0.002, candidates=9)
    assert c.lookup(DK, "knn", "d8,n4096") == {"impl": "ref", "block_q": 128}
    assert c.lookup(H100, "knn", "d8,n4096") is None
    assert c.lookup(DK, "knn", "d8,n8192") is None
    assert c.lookup(DK, "knn", "d8,n4096", dtype="bfloat16") is None
    assert TuningCache(path).lookup(DK, "knn", "d8,n4096")["block_q"] == 128
    blob = json.load(open(path))
    assert blob["version"] == 1
    key = next(iter(blob["entries"]))
    assert split_key(key) == (DK, "knn", "d8,n4096", "float32")
    assert make_key(DK, "knn", "d8,n4096", "float32") == key
    assert ttune.CACHE_ENV == "REPRO_TORCH_TUNE_CACHE"


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_cache_file_reads_across_packages(tmp_path, writer):
    path = str(tmp_path / "shared.json")
    w, r = ((TuningCache(path), jtune.TuningCache) if writer == "port"
            else (jtune.TuningCache(path), TuningCache))
    w.record(H100, "knn", "d8,k2,n1048576",
             {"impl": "cuda", "route": "tc3xtf32"}, seconds=0.5, candidates=3)
    w.record(DK, "knn_block", "d8,k2,n1048576", {"knn_block": 8192})
    other = r(path)
    assert len(other) == 2
    assert other.lookup(H100, "knn", "d8,k2,n1048576") == {
        "impl": "cuda", "route": "tc3xtf32"}
    assert dict(other.entries()) == dict(w.entries())


def test_default_cache_path_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_TORCH_TUNE_CACHE", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert ttune.default_cache_path() == str(tmp_path / "repro_torch" / "tune_cache.json")
    assert ttune.default_cache_path() != jtune.default_cache_path()
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "x.json"))
    assert TuningCache().path == str(tmp_path / "x.json")


def test_cache_prune_clear_and_entries(tmp_path):
    c = TuningCache(str(tmp_path / "c.json"))
    c.record(DK, "knn", "d8,n4096", {"impl": "ref"})
    c.record(DK, "segment_sum", "d8,n4096,s512", {"impl": "ref"})
    c.record(H100, "knn", "d8,n4096", {"impl": "cuda", "route": "cuda_core"})
    assert len(c) == 3
    assert [k[1] for k, _ in c.entries()].count("knn") == 2
    assert c.prune(kernel="segment_sum") == 1
    assert c.prune(device_kind=H100) == 1
    key = make_key(DK, "knn", "d8,n4096", "float32")
    c._load()[key]["recorded_unix"] = 0.0
    assert c.prune(max_age_days=1.0) == 1
    c.record(DK, "knn", "d8,n4096", {"impl": "ref"})
    assert c.clear() == 1 and len(c) == 0


# ------------------------------------------------- config + dispatch_key


def test_tune_policy_validation_and_env():
    assert RuntimeConfig().tune == "off" == jruntime.RuntimeConfig().tune
    assert RuntimeConfig(tune="cached").tune == "cached"
    with pytest.raises(ValueError, match="tune must be one of"):
        RuntimeConfig(tune="always")
    assert config_from_env({"REPRO_TORCH_TUNE": "onthefly"}).tune == "onthefly"
    assert config_from_env({"REPRO_TORCH_TUNE": "off"}) == RuntimeConfig()
    assert config_from_env({"REPRO_TORCH_EXECUTOR": "streaming"}).executor == "streaming"
    assert config_from_env({"REPRO_TUNE": "onthefly"}).tune == "off"  # the reference's var


@pytest.mark.parametrize("executor", ["sharded", "streaming_sharded"])
def test_multi_device_executors_name_item_7(executor):
    # ROADMAP item 7a ported the multi-device executors: the field takes
    # them, as the reference's does
    assert RuntimeConfig(executor=executor).executor == executor
    assert config_from_env({"REPRO_TORCH_EXECUTOR": executor}).executor == executor
    with pytest.raises(ValueError, match="executor must be one of"):
        RuntimeConfig(executor="memroy")
    assert jruntime.RuntimeConfig(executor=executor).executor == executor


def test_configured_executor_reaches_the_plan(rng):
    x = rng.normal(size=(64, 3)).astype(np.float32)
    with runtime.configure(executor="memory"):
        assert plan_fit(x, 2, 1, device="cpu").executor == "memory"
    with runtime.configure(executor="streaming"):
        assert plan_fit(iter([x]), 2, 1, device="cpu").executor == "streaming"
        with pytest.raises(ValueError, match="chunk"):
            plan_fit(x, 2, 1, device="cpu")  # a resident array cannot stream
        assert plan_fit(x, 2, 1, device="cpu", executor="memory").executor == "memory"


def test_dispatch_key_carries_cache_epoch(cache):
    off = runtime.dispatch_key()
    assert off == runtime.active().dispatch_key()
    cache.record(DK, "knn", "d8,n4096", {"impl": "ref"}, save=False)
    assert runtime.dispatch_key() == off
    with runtime.configure(tune="cached"):
        k1 = runtime.dispatch_key()
        assert k1 != off and ("cached", ttune.cache_epoch()) in k1
        cache.record(DK, "knn", "d8,n8192", {"impl": "ref"}, save=False)
        k2 = runtime.dispatch_key()
    assert k2 != k1
    # the reference's field order over the port's fields: device, precision
    # and the default tenant are left out
    assert runtime.RuntimeConfig(device="cpu", precision="bfloat16",
                                 serve_default_tenant="x").dispatch_key() == off
    cfg = jruntime.RuntimeConfig()
    want = (cfg.impl, cfg.knn_block, cfg.block_q, cfg.block_k, cfg.n_blocks,
            cfg.chunk_n, cfg.reservoir_n, cfg.prefetch_depth, cfg.executor,
            "off", cfg.serve_queue_depth, cfg.serve_max_inflight,
            cfg.serve_max_wait_ms, cfg.refresh_max_points,
            cfg.refresh_max_cascades, cfg.refresh_drift_ratio)
    assert off == want


def test_default_config_set_default_update_default():
    prev = runtime.default_config()
    assert runtime.active() is prev  # no configure() scope is open
    try:
        old = runtime.set_default(prev.replace(knn_block=4096))
        assert old is prev
        assert runtime.active().knn_block == 4096
        with runtime.configure(knn_block=2048):
            assert runtime.active().knn_block == 2048
            assert runtime.default_config().knn_block == 4096
        new = runtime.update_default(tune="cached")
        assert new.tune == "cached" and new.knn_block == 4096
        assert runtime.default_config() is new
        with pytest.raises(TypeError, match="RuntimeConfig"):
            runtime.set_default({"tune": "off"})
        with pytest.raises(ValueError, match="tune must be one of"):
            runtime.update_default(tune="sometimes")
    finally:
        runtime.set_default(prev)
    assert runtime.default_config() is prev


# --------------------------------------------------- plan_fit resolution


def test_plan_fit_consults_cache(rng, caches):
    """The same entries under the kind "cpu", in the two packages' files,
    freeze the same fields into both plans; explicit kwargs win; off
    keeps the constants."""
    x = rng.normal(size=(512, 4)).astype(np.float32)
    record_both(caches, "knn", {"impl": "ref", "block_q": 128, "block_k": 1024},
                n=512, d=4, k=1)
    record_both(caches, "knn_block", {"knn_block": 4096}, n=512, d=4, k=1)
    record_both(caches, "assign", {"impl": "fused_int8", "block_k": 16},
                nq=512, p=512, d=4, k=1)
    fields = ("impl", "knn_block", "block_q", "block_k")
    with runtime.configure(tune="cached"), jruntime.configure(tune="cached"):
        tuned = plan_fit(x, 2, 1, device="cpu")
        want = jplan_fit(jnp.asarray(x), 2, 1)
        assert [getattr(tuned, f) for f in fields] == [getattr(want, f) for f in fields]
        assert (tuned.block_q, tuned.block_k, tuned.knn_block, tuned.impl) == (
            128, 1024, 4096, "fused")
        assert tuned.knn_route is None
        pinned = plan_fit(x, 2, 1, block_q=64, knn_block=256, impl="ref",
                          device="cpu")
        jpinned = jplan_fit(jnp.asarray(x), 2, 1, block_q=64, knn_block=256,
                            impl="ref")
        assert [getattr(pinned, f) for f in fields] == [getattr(jpinned, f)
                                                        for f in fields]
        assert (pinned.block_q, pinned.knn_block, pinned.impl) == (64, 256, "ref")
    for plan in (plan_fit(x, 2, 1, device="cpu"),):
        assert (plan.block_q, plan.block_k, plan.knn_block, plan.impl) == (
            256, 512, 0, "auto")


def test_plan_fit_freezes_the_knn_route(rng, cache):
    x = rng.normal(size=(512, 6)).astype(np.float32)
    cache.record(DK, "knn", ttune.shape_bucket(n=512, d=6, k=2),
                 {"impl": "cuda", "route": "cuda_core_split"})
    with runtime.configure(tune="cached"):
        assert plan_fit(x, 3, 1, device="cpu").knn_route == "cuda_core_split"
        assert plan_fit(x, 3, 1, device="cpu", knn_route="cuda_core").knn_route \
            == "cuda_core"
    assert plan_fit(x, 3, 1, device="cpu").knn_route is None


def test_fit_with_tuned_plan_matches_untuned_labels(rng, caches):
    """Tuned dispatch moves where work happens, never the result: a cached
    fit gives the untuned labels, in both packages (dyadic data, one-block
    folds: bit for bit across the packages)."""
    x = dyadic(rng, (256, 4))
    record_both(caches, "knn", {"impl": "ref", "block_q": 128, "block_k": 256},
                n=256, d=4, k=1)
    record_both(caches, "knn_block", {"knn_block": 2048}, n=256, d=4, k=1)
    jk = jax.random.PRNGKey(3)
    tk = prng.key_from_numpy(np.asarray(jk))
    with runtime.configure(n_blocks=1), jruntime.configure(n_blocks=1):
        want = repro_torch.fit(x, 2, 1, "kmeans", k=3, key=tk, device="cpu")
        with runtime.configure(tune="cached"), jruntime.configure(tune="cached"):
            got = repro_torch.fit(x, 2, 1, "kmeans", k=3, key=tk, device="cpu")
            ref_got = repro.fit(jnp.asarray(x), 2, 1, "kmeans", k=3, key=jk)
    np.testing.assert_array_equal(got.labels.numpy(), want.labels.numpy())
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref_got.labels))


def test_plan_fit_streaming_consults_stream_cell(rng, caches):
    x = rng.normal(size=(64, 3)).astype(np.float32)
    record_both(caches, "stream", {"chunk_n": 2048, "reservoir_n": 8192,
                                   "prefetch_depth": 2})
    fields = ("chunk_n", "reservoir_n", "prefetch_depth")
    with runtime.configure(tune="cached"), jruntime.configure(tune="cached"):
        plan = plan_fit(iter([x]), 2, 1, device="cpu")
        want = jplan_fit(iter([x]), 2, 1)
        assert [getattr(plan, f) for f in fields] == [getattr(want, f) for f in fields]
        assert (plan.chunk_n, plan.reservoir_n, plan.prefetch_depth) == (2048, 8192, 2)
        assert plan_fit(iter([x]), 2, 1, prefetch_depth=0,
                        device="cpu").prefetch_depth == 0
        assert plan_fit(iter([x]), 2, 1, prefetch_depth=1,
                        device="cpu").prefetch_depth == 1
        assert plan_fit(iter([x]), 2, 1, chunk_n=64, device="cpu").chunk_n == 64
    assert plan_fit(iter([x]), 2, 1, device="cpu").chunk_n == 0
    assert plan_fit(iter([x]), 2, 1, device="cpu").prefetch_depth == 0


def test_resolve_auto_block(caches):
    from repro.core.knn import resolve_auto_block as jresolve

    assert resolve_auto_block(100_000, 8, 3, device="cpu") == AUTO_KNN_BLOCK
    record_both(caches, "knn_block", {"knn_block": 4096}, n=100_000, d=8, k=3)
    with runtime.configure(tune="cached"), jruntime.configure(tune="cached"):
        assert resolve_auto_block(100_000, 8, 3, device="cpu") == 4096 \
            == jresolve(100_000, 8, 3)
        assert resolve_auto_block(50, 8, 3, device="cpu") == AUTO_KNN_BLOCK
        assert resolve_auto_block(100_000, 8, 3, "bfloat16", "cpu") == AUTO_KNN_BLOCK
    assert resolve_auto_block(100_000, 8, 3, device="cpu") == AUTO_KNN_BLOCK


# ------------------------------------------------------ ops consultation


def test_ops_use_the_tuned_impl(rng, cache, monkeypatch):
    """A cached fused winner with a fold tile flows through ops.knn (the
    plain streaming fold on the CPU) and still matches the dense plain
    version; an explicit impl= wins."""
    x = torch.as_tensor(rng.normal(size=(24, 3)).astype(np.float32))
    cache.record(DK, "knn", ttune.shape_bucket(n=24, d=3, k=2),
                 {"impl": "fused", "block_k": 8})
    seen = []
    real = fused_assign.fused_topk_plain

    def spy(*a, **kw):
        seen.append(kw.get("block_k"))
        return real(*a, **kw)

    monkeypatch.setattr(fused_assign, "fused_topk_plain", spy)
    wd, wi = ref.knn(x, 2)
    with runtime.configure(tune="cached"):
        gd, gi = ops.knn(x, 2)
        gd2, _ = ops.knn(x, 2, impl="ref")
    assert seen == [8]
    np.testing.assert_allclose(gd.numpy(), wd.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(gi.numpy(), wi.numpy())
    np.testing.assert_array_equal(gd2.numpy(), wd.numpy())
    # segment_sum and pairwise take their cells' winners too (plain on the CPU)
    cache.record(DK, "segment_sum", ttune.shape_bucket(n=24, d=3, s=5),
                 {"impl": "cuda", "route": "few"})
    ids = torch.as_tensor(rng.integers(0, 5, size=24))
    with runtime.configure(tune="cached"):
        s1, m1 = ops.blocked_segment_sum(x, ids, 5)
    s0, m0 = ops.blocked_segment_sum(x, ids, 5)
    assert torch.equal(s0, s1) and torch.equal(m0, m1)
    assert len(cache) == 2


def test_route_is_ignored_on_cpu_tensors_and_checked_by_name():
    x, y = torch.randn(16, 3), torch.randn(5, 3)
    for r in pairwise_l2.ROUTES:
        assert torch.equal(ops.pairwise_sq_l2(x, y, impl="cuda", route=r),
                           ref.pairwise_sq_l2(x, y))
    want = ref.knn(x, 2)
    for r in fused_assign.ROUTES:
        got = ops.knn(x, 2, impl="cuda", route=r)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert fused_assign.check_route(None, 6, 2) == "tc3xtf32"
    assert fused_assign.check_route(None, 64, 1) == "cuda_core_split"
    assert fused_assign.check_route(None, 6, 16) == "cuda_core"
    assert fused_assign.check_route("cuda_core_split", 6, 2) == "cuda_core_split"
    assert fused_assign.check_route("cuda_core", 6, 1) == "cuda_core"
    for bad, d, k in (("tc3xtf32", 64, 2), ("cuda_core_split", 6, 16),
                      ("cuda_core", 6, 33), ("tiled", 6, 2)):
        with pytest.raises(ValueError, match="route"):
            fused_assign.check_route(bad, d, k)
    assert pairwise_l2.check_route(None, 7, 6) == "small_m"
    with pytest.raises(ValueError, match="route"):
        pairwise_l2.check_route("small_m", 17, 6)
    assert segsum.route_ok("few", 64) and not segsum.route_ok("few", 65)
    assert segsum.route_ok("many", 7)


def test_onthefly_measures_and_persists(rng, cache):
    x = torch.as_tensor(rng.normal(size=(32, 3)).astype(np.float32))
    assert len(cache) == 0
    with runtime.configure(tune="onthefly"):
        ops.knn(x, 2)
    params = cache.lookup(DK, "knn", ttune.shape_bucket(n=32, d=3, k=2))
    assert params == {"impl": "ref"}
    assert TuningCache(cache.path).lookup(
        DK, "knn", ttune.shape_bucket(n=32, d=3, k=2)) == params


def test_onthefly_plan_measures_and_execution_does_not(rng, cache):
    x = rng.normal(size=(300, 3)).astype(np.float32)
    with runtime.configure(tune="onthefly"):
        plan = plan_fit(x, 3, 1, "kmeans", k=3, device="cpu")
        cells = sorted(k[1] for k, _ in cache.entries())
        assert cells == ["assign", "knn", "knn_block"]
        n_entries = len(cache)
        res = execute_plan(plan, x)
    assert len(cache) == n_entries  # execution runs under "cached"
    assert res.labels.shape == (300,)


def test_autotune_cell_records_winner(cache):
    with runtime.configure(device="cpu"):
        params, sec = ttune.autotune_cell("knn", {"n": 32, "d": 3, "k": 2},
                                          cache=cache, repeats=1)
    jparams, _ = jtune.autotune_cell("knn", {"n": 32, "d": 3, "k": 2},
                                     cache=jtune.get_cache(), repeats=1)
    assert params == jparams == {"impl": "ref"}
    assert sec > 0
    rec = dict(cache.entries())[(DK, "knn", "d4,k2,n32", "float32")]
    assert rec["candidates"] == 1 and rec["params"] == params
    with pytest.raises(ValueError, match="unknown tunable kernel"):
        ttune.autotune_cell("attention", {}, cache=cache, device="cpu")


# ------------------------------------------- candidate lists per device


CELL_DIMS = {
    "knn": [{"n": 24, "d": 3, "k": 2}, {"n": 7172, "d": 6, "k": 2},
            {"n": 2208, "d": 256, "k": 1}],
    "pairwise_sq_l2": [{"n": 2390, "m": 7, "d": 6}, {"n": 4096, "m": 4096, "d": 8},
                       {"n": 15_625, "m": 17, "d": 40}],
    "segment_sum": [{"n": 581_012, "d": 6, "s": 193_670}, {"n": 2390, "d": 6, "s": 7},
                    {"n": 100, "d": 3, "s": 64}],
    "knn_block": [{"n": 512, "d": 4, "k": 1}, {"n": 581_012, "d": 6, "k": 2},
                  {"n": 5000, "d": 2, "k": 1}],
    "stream": [{}, {"d": 6}, {"d": 64}],
    "assign": [{"nq": 5000, "p": 5393, "d": 6, "k": 1},
               {"nq": 581_012, "p": 581_012, "d": 6, "k": 2},
               {"nq": 8192, "p": 65_536, "d": 64, "k": 16}],
}
CASES = [(kernel, i) for kernel in CELL_DIMS for i in range(3)]


@pytest.mark.parametrize("kernel,i", CASES)
def test_cpu_candidates_equal_the_references(kernel, i):
    dims = CELL_DIMS[kernel][i]
    assert autotune.candidates_for(kernel, dims) == jautotune.candidates_for(
        kernel, dims, include_pallas=False)
    assert autotune.DEFAULT_DIMS[kernel] == jautotune.DEFAULT_DIMS[kernel]


@pytest.mark.parametrize("kernel,i", CASES)
def test_card_candidates_are_legal_routes_never_plain(kernel, i):
    dims = CELL_DIMS[kernel][i]
    cands, skipped = autotune.card_candidates(kernel, dims, free_bytes=80 * 2 ** 30)
    assert cands
    for params in cands:
        assert params.get("impl") != "ref"
        assert ttune._stale_reason(params, kernel, H100, dims) is None, params
    routes = [p["route"] for p in cands if "route" in p]
    if kernel == "knn":
        want = [r for r in fused_assign.ROUTES if fused_assign.route_ok(
            r, ttune.pow2_bucket(dims["d"]), ttune.pow2_bucket(dims["k"]))]
        assert routes == want and {p["impl"] for p in cands} == {"cuda"}
    if kernel == "assign":
        assert {"impl": "fused_bf16"} in cands and {"impl": "fused_int8"} in cands
        big = dims["nq"] * dims["p"] > 2 ** 32
        assert ({"impl": "cuda"} in cands) != big
        assert [s[0] for s in skipped] == ([{"impl": "cuda"}] if big else [])
    if kernel == "knn_block":
        assert cands == autotune.candidates_for(kernel, dims)


def test_card_candidates_at_the_main_paths_shapes():
    c = autotune.card_candidates
    assert [p["route"] for p in c("knn", {"n": 581_012, "d": 6, "k": 2}, 0)[0]] == [
        "cuda_core", "tc3xtf32", "cuda_core_split"]
    assert [p["route"] for p in c("knn", {"n": 2208, "d": 256, "k": 1}, 0)[0]] == [
        "cuda_core", "cuda_core_split"]
    assert [p["route"] for p in c("knn", {"n": 99, "d": 6, "k": 9}, 0)[0]] == [
        "cuda_core"]
    assert [p["route"] for p in c("pairwise_sq_l2",
                                  {"n": 2390, "m": 7, "d": 6}, 0)[0]] == ["tiled", "small_m"]
    assert [p["route"] for p in c("pairwise_sq_l2",
                                  {"n": 2390, "m": 17, "d": 6}, 0)[0]] == ["tiled"]
    assert [p["route"] for p in c("segment_sum",
                                  {"n": 581_012, "d": 6, "s": 193_670}, 0)[0]] == ["many"]
    assert [p["route"] for p in c("segment_sum",
                                  {"n": 2390, "d": 6, "s": 7}, 0)[0]] == ["many", "few"]
    stream = c("stream", {}, 0)[0]
    assert {p["chunk_n"] for p in stream} == {32768, 65536, 131072}
    assert {p["prefetch_depth"] for p in stream} == {0, 2}


# ------------------------------------------------------------ CLI


def test_tune_cli_roundtrip(tmp_path, capsys):
    from repro_torch.tune.__main__ import main

    path = str(tmp_path / "cli_cache.json")
    with runtime.configure(device="cpu"):
        assert main(["--cache", path, "populate", "--kernels", "knn",
                     "--shapes", "32x3x2", "--repeats", "1"]) == 0
    assert main(["--cache", path, "show"]) == 0
    out = capsys.readouterr().out
    assert "knn" in out and "d4,k2,n32" in out and "cpu | knn" in out
    assert main(["--cache", path, "prune", "--kernel", "knn"]) == 0
    assert main(["--cache", path, "clear"]) == 0
    assert main(["--cache", path, "populate", "--kernels", "bogus"]) == 2
    assert len(TuningCache(path)) == 0
    with pytest.raises(SystemExit):
        main(["--cache", path, "populate", "--include-pallas"])


# ------------------------------------------- stale-entry hardening


def test_stale_cache_unknown_impl_ignored_and_pruned(rng, cache):
    """"pallas" is the reference's winner; the port registers no such impl,
    so it is warned about, pruned from memory and file, and the constants
    run."""
    bucket = ttune.shape_bucket(n=24, d=3, k=2)
    blob = {"version": 1, "entries": {
        make_key(DK, "knn", bucket, "float32"):
            {"params": {"impl": "pallas", "block_q": 8, "block_k": 8},
             "seconds": 0.001, "candidates": 9, "recorded_unix": 0},
    }}
    json.dump(blob, open(cache.path, "w"))
    cache.reload()
    x = torch.as_tensor(rng.normal(size=(24, 3)).astype(np.float32))
    wd, wi = ref.knn(x, 2)
    with runtime.configure(tune="cached"):
        with pytest.warns(RuntimeWarning, match="stale tuning-cache"):
            gd, gi = ops.knn(x, 2)
    assert torch.equal(gd, wd) and torch.equal(gi, wi)
    assert cache.lookup(DK, "knn", bucket) is None
    assert TuningCache(cache.path).lookup(DK, "knn", bucket) is None


def test_stale_cache_bad_tile_ignored_and_pruned(rng, cache):
    bucket = ttune.shape_bucket(n=24, d=3, k=2)
    cache.record(DK, "knn", bucket, {"impl": "fused", "block_q": 300, "block_k": 8})
    x = torch.as_tensor(rng.normal(size=(24, 3)).astype(np.float32))
    with runtime.configure(tune="cached"):
        with pytest.warns(RuntimeWarning, match="power of two"):
            gd, gi = ops.knn(x, 2)
    wd, wi = ref.knn(x, 2)
    assert torch.equal(gi, wi)
    assert cache.lookup(DK, "knn", bucket) is None


CATALOGUE = [
    ({"impl": "ref"}, None),
    ({"impl": "fused_int8", "block_k": 1024}, None),
    ({"knn_block": 4096}, None),
    ({"impl": "palas"}, "stale"),
    ({"impl": "auto"}, "stale"),
    ({"block_k": 300}, "stale"),
    ({"block_q": 0}, "stale"),
    ({"chunk_n": "big"}, "stale"),
    ("not-a-dict", "stale"),
    ({"chunk_n": 2048, "prefetch_depth": 0}, None),
    ({"chunk_n": 2048, "prefetch_depth": 3}, None),
    ({"prefetch_depth": -1}, "stale"),
    ({"prefetch_depth": True}, "stale"),
    ({"prefetch_depth": "deep"}, "stale"),
]


@pytest.mark.parametrize("params,want", CATALOGUE)
def test_stale_reason_catalogue(params, want):
    from repro.tune import _stale_reason as jstale

    got = ttune._stale_reason(params)
    assert (got is None) == (want is None) == (jstale(params) is None)


def test_stale_reason_port_only():
    stale = ttune._stale_reason
    assert stale({"impl": "pallas"}) is not None  # the reference's TPU kernel
    assert stale({"impl": "cuda"}) is None and stale({"impl": "fused"}) is None
    assert stale({"impl": "cuda", "route": "tc3xtf32"}) is None
    assert stale({"impl": "cuda", "route": "wgmma"}) is not None
    assert stale({"knn_block": 4096, "route": "tiled"}, "knn_block") is not None


def test_stale_gate_under_a_cards_kind():
    d6 = {"n": 581_012, "d": 6, "k": 2}
    d64 = {"n": 8192, "d": 64, "k": 2}
    stale = ttune._stale_reason
    assert "plain" in stale({"impl": "ref"}, "knn", H100, d6)
    assert stale({"impl": "ref"}, "knn", DK, d6) is None
    assert stale({"impl": "cuda", "route": "tc3xtf32"}, "knn", H100, d6) is None
    assert "edge" in stale({"impl": "cuda", "route": "tc3xtf32"}, "knn", H100, d64)
    assert stale({"impl": "cuda", "route": "cuda_core_split"}, "knn", H100, d64) is None
    assert "edge" in stale({"impl": "fused", "route": "cuda_core_split"}, "assign",
                           H100, {"nq": 8, "p": 8, "d": 6, "k": 9})
    # d 17..32 is bucket 32: still the tensor-core route's; 33 is bucket 64
    assert stale({"impl": "cuda", "route": "tc3xtf32"}, "knn", H100,
                 {"n": 8, "d": 32, "k": 8}) is None
    assert stale({"impl": "cuda", "route": "tc3xtf32"}, "knn", H100,
                 {"n": 8, "d": 33, "k": 8}) is not None
    assert stale({"impl": "cuda", "route": "small_m"}, "pairwise_sq_l2", H100,
                 {"n": 2390, "m": 7, "d": 6}) is None
    assert "edge" in stale({"impl": "cuda", "route": "small_m"}, "pairwise_sq_l2",
                           H100, {"n": 2390, "m": 17, "d": 6})
    assert "edge" in stale({"impl": "cuda", "route": "few"}, "segment_sum", H100,
                           {"n": 99, "d": 6, "s": 65})
    assert "not one of" in stale({"impl": "cuda", "route": "tiled"}, "knn", H100, d6)


def test_stale_entries_under_a_cards_kind_are_pruned(cache, monkeypatch):
    monkeypatch.setattr(autotune, "current_device_kind", lambda device=None: H100)
    planted = {
        ("knn", "d8,k2,n1048576"): {"impl": "ref"},
        ("knn", "d64,k2,n8192"): {"impl": "cuda", "route": "tc3xtf32"},
        ("knn_block", "d8,k2,n1048576"): {"knn_block": 3000},
        ("assign", "d8,k2,nq1048576,p1048576"): {"impl": "pallas"},
    }
    for (kernel, bucket), params in planted.items():
        cache.record(H100, kernel, bucket, params)
    keep = {"impl": "cuda", "route": "cuda_core"}
    cache.record(H100, "knn", "d8,k2,n8192", keep)
    with runtime.configure(tune="cached"):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            assert ttune.tuned_params("knn", n=581_012, d=6, k=2) == {}
            assert ttune.tuned_params("knn", n=8000, d=64, k=2) == {}
            assert ttune.tuned_params("knn_block", n=581_012, d=6, k=2) == {}
            assert ttune.tuned_params("assign", nq=581_012, p=581_012, d=6, k=2) == {}
            assert ttune.tuned_params("knn", n=7172, d=6, k=2) == keep
    assert len([w for w in caught if "stale tuning-cache" in str(w.message)]) == 4
    assert len(cache) == 1 and len(TuningCache(cache.path)) == 1


def test_stale_prune_warning_points_at_the_caller(rng, cache):
    """The warning names the code that called into the port — this file —
    whether it called tuned_params itself or an op that looked up."""
    bucket = ttune.shape_bucket(n=24, d=3, k=2)
    x = torch.as_tensor(rng.normal(size=(24, 3)).astype(np.float32))
    for call in (lambda: ttune.tuned_params("knn", device="cpu", n=24, d=3, k=2),
                 lambda: ops.knn(x, 2)):
        cache.record(DK, "knn", bucket, {"impl": "not-an-impl"})
        with runtime.configure(tune="cached"):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                call()
        stale = [w for w in caught if "stale tuning-cache" in str(w.message)]
        assert len(stale) == 1
        assert stale[0].filename == __file__


def test_concurrent_lookups_share_one_cache(cache):
    cache.record(DK, "knn", ttune.shape_bucket(n=64, d=3, k=2), {"impl": "ref"})
    cache.record(DK, "knn", ttune.shape_bucket(n=640, d=3, k=2), {"impl": "palas"})
    cache.reload()
    out, errors = [], []

    def worker():
        try:
            with runtime.configure(tune="cached"):
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    for _ in range(50):
                        out.append(ttune.tuned_params("knn", device="cpu",
                                                      n=64, d=3, k=2))
                        ttune.tuned_params("knn", device="cpu", n=640, d=3, k=2)
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors
    assert out == [{"impl": "ref"}] * 400
    assert len(cache) == 1


# ------------------------------------------------- the "assign" cell


def test_autotune_assign_cell_records_and_serves(rng, caches):
    """The assign cell measures the fused and quantized candidates on the
    CPU (as the reference's does), and a recorded winner drives
    ClusterIndex.assign without changing labels."""
    from repro_torch.core.index import ClusterIndex

    cache = caches[0]
    dims = {"nq": 16, "p": 32, "d": 4, "k": 1}
    with runtime.configure(device="cpu"):
        params, sec = ttune.autotune_cell("assign", dims, cache=cache, repeats=1)
    assert params["impl"] in ("ref", "fused", "fused_bf16", "fused_int8")
    assert params in jautotune.candidates_for("assign", dims, include_pallas=False)
    assert sec > 0
    protos = torch.as_tensor(rng.normal(size=(32, 4)).astype(np.float32) * 10.0)
    idx = ClusterIndex.build(ClusterIndex(
        protos=protos, proto_mass=torch.ones(32),
        proto_valid=torch.ones(32, dtype=torch.bool),
        proto_labels=torch.arange(32, dtype=torch.int32),
        n_prototypes=torch.tensor(32, dtype=torch.int32)))
    q = torch.as_tensor(rng.normal(size=(16, 4)).astype(np.float32) * 10.0)
    want = idx.assign(q, impl="ref")
    cache.record(DK, "assign", ttune.shape_bucket(**dims),
                 {"impl": "fused", "block_k": 16})
    with runtime.configure(tune="cached"):
        got = idx.assign(q)
    assert torch.equal(got, want)


def test_plan_fit_freezes_fused_assign_winner(rng, caches):
    """A fused (here quantized) winner of the assign cell freezes as plain
    "fused" in both packages; explicit impl wins; the fused fit gives the
    untuned labels bit for bit."""
    x = dyadic(rng, (64, 3))
    record_both(caches, "assign", {"impl": "fused_int8", "block_k": 16},
                nq=64, p=64, d=3, k=1)
    with runtime.configure(tune="cached"), jruntime.configure(tune="cached"):
        plan = plan_fit(x, 2, 1, "kmeans", k=3, device="cpu")
        assert plan.impl == "fused" == jplan_fit(jnp.asarray(x), 2, 1, "kmeans",
                                                  k=3).impl
        assert plan_fit(x, 2, 1, "kmeans", k=3, impl="ref", device="cpu").impl == "ref"
    want = repro_torch.fit(x, 2, 1, "kmeans", k=3, device="cpu").labels
    with runtime.configure(tune="cached"):
        got = repro_torch.fit(x, 2, 1, "kmeans", k=3, device="cpu").labels
    assert torch.equal(got, want)


def test_cpu_fit_under_cached_is_bitwise_the_untuned_fit(rng, cache):
    """Every cell the fit looks up, measured on the CPU into the cache, and
    the fit run again under "cached": the same labels, prototypes and
    level maps bit for bit (dyadic inputs: every policy's plain fold is
    exact there)."""
    x = dyadic(rng, (600, 3))
    with runtime.configure(device="cpu"):
        for kernel, dims in (("knn", {"n": 600, "d": 3, "k": 2}),
                             ("knn_block", {"n": 600, "d": 3, "k": 2}),
                             ("assign", {"nq": 600, "p": 600, "d": 3, "k": 2}),
                             ("segment_sum", {"n": 600, "d": 3, "s": 200}),
                             ("pairwise_sq_l2", {"n": 22, "m": 3, "d": 3})):
            ttune.autotune_cell(kernel, dims, cache=cache, repeats=1)
    assert len(cache) == 5
    want = repro_torch.fit(x, 3, 2, "kmeans", k=3, device="cpu")
    with runtime.configure(tune="cached"):
        plan = plan_fit(x, 3, 2, "kmeans", k=3, device="cpu")
        got = execute_plan(plan, x)
        again = repro_torch.fit(x, 3, 2, "kmeans", k=3, device="cpu")
    assert plan.knn_block == cache.lookup(
        DK, "knn_block", ttune.shape_bucket(n=600, d=3, k=2))["knn_block"] == 1024
    for a, b in ((got, want), (again, want)):
        assert torch.equal(a.labels, b.labels)
        assert torch.equal(a.protos, b.protos)
        for p, q in zip(a.assignments, b.assignments):
            assert torch.equal(p, q)
