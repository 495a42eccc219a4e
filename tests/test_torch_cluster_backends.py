"""The port's HAC and DBSCAN backends through the whole slice, its metrics
and its backend registry, against the JAX package.

``repro_torch.fit(x, t, m, "hac" | "dbscan", ...)`` against ``repro.fit``
on the same 2,048 rows (the paper's GMM and a dyadic grid), same key,
one-block segment-sum fold on both sides (ROADMAP: XLA:CPU does not keep
the 8-block fold's rounding under ``jit``): labels equal, m = 0 included
(the backend on the rows themselves). ``bss_tss`` within rtol 1e-5; the
bottleneck functions equal. K4's route rule (which instance of
``csrc/pairwise_l2.cu`` a launch takes) is checked here too; the kernels
themselves run only on the card (``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import gmm_sample

import repro
from repro import runtime as j_runtime
from repro.cluster import metrics as j_metrics
from repro.cluster.registry import available_backends as j_available
import repro_torch
from repro_torch import kernels as tkernels
from repro_torch import prng
from repro_torch import runtime as t_runtime
from repro_torch.cluster import available_backends, metrics, resolve_backend
from repro_torch.cluster.dbscan import DBSCANResult, dbscan_masked
from repro_torch.cluster.hac import HACResult, hac_masked
from repro_torch.cluster.registry import validate_backend_fn
from repro_torch.kernels import pairwise_l2

torch.set_num_threads(1)

CASES = [("hac", dict(k=3, linkage="ward"), 2),
         ("hac", dict(k=3, linkage="average"), 2),
         ("hac", dict(k=3, linkage="single"), 1),
         ("dbscan", dict(eps=0.5, min_pts=8.0), 2),
         ("dbscan", dict(eps=0.5, min_pts=8.0), 1),
         ("dbscan", dict(eps=0.5, min_pts=8.0), 0),
         ("hac", dict(k=3, linkage="complete"), 0)]


def _data(kind, n):
    rng = np.random.default_rng(0)
    if kind == "gmm":
        return gmm_sample(n, rng)[0]
    return (rng.integers(-16, 17, size=(n, 2)) * 0.25).astype(np.float32)


@pytest.mark.parametrize("kind", ["gmm", "dyadic"])
@pytest.mark.parametrize("backend,kw,m", CASES,
                         ids=[f"{b}-{k.get('linkage', 'eps')}-m{m}" for b, k, m in CASES])
def test_fit_backend_matches_reference(kind, backend, kw, m):
    # HAC on the rows themselves (m = 0) runs n - k merges: 256 rows
    n = 256 if (backend == "hac" and m == 0) else 2048
    x = _data(kind, n)
    jk = jax.random.PRNGKey(3)
    with j_runtime.configure(n_blocks=1):
        want = repro.fit(jnp.asarray(x), 2, m, backend, key=jk, **kw)
    with t_runtime.configure(n_blocks=1):
        got = repro_torch.fit(x, 2, m, backend, key=prng.key_from_numpy(np.asarray(jk)),
                              device="cpu", **kw)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.proto_labels.numpy(), np.asarray(want.proto_labels))
    assert int(got.n_prototypes) == int(want.n_prototypes)
    result = got.backend_result
    assert isinstance(result, HACResult if backend == "hac" else DBSCANResult)
    if m == 0:
        assert not got.assignments and got.labels.shape == (n,)


def test_fit_backends_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    x = _data("gmm", 64)
    for backend, kw in (("hac", dict(k=3)), ("dbscan", dict(eps=0.5, min_pts=4.0))):
        with pytest.raises(RuntimeError, match="CUDA"):
            repro_torch.fit(x, 2, 1, backend, **kw)


def test_registry_lists_the_reference_backends():
    assert available_backends() == ["dbscan", "hac", "kmeans"]
    assert available_backends() == j_available()
    assert resolve_backend("hac") is hac_masked
    assert resolve_backend("dbscan") is dbscan_masked
    for fn in (hac_masked, dbscan_masked):
        validate_backend_fn(fn)
    with pytest.raises(ValueError, match="unknown backend"):
        resolve_backend("spectral")


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("k", [1, 3, 6])
def test_bss_tss_matches_reference(weighted, k):
    rng = np.random.default_rng(k + 10 * weighted)
    x = rng.normal(size=(300, 4)).astype(np.float32)
    lab = rng.integers(-1, k, size=300).astype(np.int32)
    w = rng.integers(1, 9, size=300).astype(np.float32) if weighted else None
    want = float(j_metrics.bss_tss(jnp.asarray(x), jnp.asarray(lab), k,
                                   weights=None if w is None else jnp.asarray(w)))
    got = metrics.bss_tss(torch.from_numpy(x), torch.from_numpy(lab), k,
                          weights=None if w is None else torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


def test_bss_tss_degenerate_data_is_finite():
    const = torch.ones((10, 3))
    assert float(metrics.bss_tss(const, torch.zeros(10, dtype=torch.int32), 1)) == 0.0
    single = torch.tensor([[1.0, 2.0]])
    assert float(metrics.bss_tss(single, torch.zeros(1, dtype=torch.int32), 1)) == 0.0
    masked = float(metrics.bss_tss(const, torch.full((10,), -1, dtype=torch.int32), 2))
    assert np.isfinite(masked) and masked == 0.0


def test_bottleneck_functions_match_reference():
    rng = np.random.default_rng(4)
    for _ in range(3):
        x = rng.normal(size=(7, 2)).astype(np.float32)
        lab = rng.integers(-1, 3, size=7)
        assert metrics.bottleneck_objective(torch.from_numpy(x), lab) == \
            j_metrics.bottleneck_objective(x, lab)
        for t in (2, 3):
            assert metrics.optimal_bottleneck(x, t) == j_metrics.optimal_bottleneck(x, t)
    with pytest.raises(ValueError, match="n <= 10"):
        metrics.optimal_bottleneck(np.zeros((11, 2)), 2)


@pytest.mark.parametrize("m,d,want", [(1, 1, "small_m"), (7, 6, "small_m"),
                                      (16, 32, "small_m"), (17, 6, "tiled"),
                                      (3, 33, "tiled"), (4096, 2, "tiled")])
def test_k4_route_rule(m, d, want):
    """The wrapper's route rule, which mirrors repro_pairwise_sq_l2_route in
    csrc/pairwise_l2.cu (chip_smoke.py checks the two agree on the card)."""
    assert pairwise_l2.route(m, d) == want


def test_k4_counts_no_launch_on_the_cpu():
    tkernels.reset_launch_counts()
    x = torch.randn(20, 3)
    d = pairwise_l2.pairwise_sq_l2(x, x[:5], torch.tensor([1, 0, 1, 1, 0]))
    assert d.shape == (20, 5) and bool(torch.isinf(d[:, 1]).all())
    assert tkernels.launch_counts()["K4"] == 0
    assert tkernels.route_counts() == {}
