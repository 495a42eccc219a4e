"""The reference's public surface in the port (ROADMAP item 11):

* ``ClusterIndex.fit``, ``fit_streaming``, ``from_result`` and
  ``with_packed_protos`` warn (``DeprecationWarning`` naming
  ``ClusterIndex.build``) and return what ``build`` returns, bit for bit
  (the reference's checks: ``tests/test_lifecycle.py``'s alias test);
  ``IHTCResult`` and ``StreamingIHTCResult`` are ``FitResult``
  (``tests/test_fit_plan.py``'s);
* every public name of ``repro.core`` and ``repro.cluster`` resolves in
  the port, and every module of ``src/repro/`` has its counterpart in
  ``src/repro_torch/``, apart from the names on :data:`EXEMPT`.
"""
import pathlib

import numpy as np
import pytest
import torch

import repro.cluster as ref_cluster
import repro.core as ref_core
import repro_torch
import repro_torch.cluster as port_cluster
import repro_torch.core as port_core
from repro_torch.core import ClusterIndex, FitResult

#: public names the port expresses otherwise, each with its reason (none
#: of repro.core's or repro.cluster's is among them today)
EXEMPT = {}

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _blobs(seed: int, n_per: int = 60) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = np.array([[0.0, 0.0], [6.0, 0.0], [3.0, 6.0]])
    x = np.concatenate([c + rng.normal(scale=0.5, size=(n_per, 2)) for c in centers])
    return x.astype(np.float32)


def _assert_index_bitwise(a: ClusterIndex, b: ClusterIndex) -> None:
    for name in ClusterIndex._fields:
        fa, fb = getattr(a, name), getattr(b, name)
        assert (fa is None) == (fb is None), name
        if fa is not None:
            assert torch.equal(fa, fb), name


def test_result_deprecation_aliases():
    from repro_torch.core.ihtc import IHTCResult
    from repro_torch.core.streaming import StreamingIHTCResult

    assert IHTCResult is FitResult and StreamingIHTCResult is FitResult
    assert port_core.IHTCResult is FitResult
    assert port_core.StreamingIHTCResult is FitResult


def test_deprecated_aliases_warn_and_match_build():
    x = _blobs(0)
    kw = dict(k=3, device="cpu")
    result = repro_torch.fit(torch.from_numpy(x), 2, 1, **kw)
    want = ClusterIndex.build(result)
    with pytest.warns(DeprecationWarning, match="ClusterIndex.build"):
        got = ClusterIndex.from_result(result)
    _assert_index_bitwise(want, got)
    with pytest.warns(DeprecationWarning, match="ClusterIndex.build"):
        got = ClusterIndex.build(result, pack=False).with_packed_protos()
    _assert_index_bitwise(want, got)
    with pytest.warns(DeprecationWarning, match="ClusterIndex.build"):
        got = ClusterIndex.fit(torch.from_numpy(x), 2, 1, "kmeans", **kw)
    _assert_index_bitwise(want, got)
    with pytest.warns(DeprecationWarning, match="ClusterIndex.build"):
        streamed = ClusterIndex.fit_streaming(iter([x[:90], x[90:]]), 2, 1, "kmeans",
                                              **kw)
    _assert_index_bitwise(ClusterIndex.build(iter([x[:90], x[90:]]), 2, 1, "kmeans",
                                             **kw), streamed)
    assert streamed.dim == 2


def test_the_aliases_point_at_the_callers_line():
    """stacklevel=2: the warning names this file, not the port's."""
    x = _blobs(1)
    result = repro_torch.fit(torch.from_numpy(x), 2, 1, k=3, device="cpu")
    with pytest.warns(DeprecationWarning) as rec:
        ClusterIndex.from_result(result)
    assert rec[0].filename == __file__


def _public(mod) -> set:
    return {n for n in dir(mod) if not n.startswith("_")}


@pytest.mark.parametrize("ref,port", [(ref_core, port_core), (ref_cluster, port_cluster)],
                         ids=["core", "cluster"])
def test_every_public_name_resolves_in_the_port(ref, port):
    missing = sorted(n for n in _public(ref) - set(EXEMPT) if not hasattr(port, n))
    assert not missing, f"{ref.__name__} names the port lacks: {missing}"


def test_the_cluster_exports():
    from repro_torch.cluster import registry

    assert port_cluster.BackendFn is registry.BackendFn
    assert port_cluster.validate_backend_fn is registry.validate_backend_fn
    for sub in ("dbscan", "hac", "kmeans", "metrics"):
        assert getattr(port_cluster, sub).__name__ == f"repro_torch.cluster.{sub}"
    with pytest.raises(TypeError):
        port_cluster.validate_backend_fn(lambda: None, "no_x")


def test_every_reference_module_has_its_counterpart():
    ref = {p.relative_to(ROOT / "src/repro").as_posix()
           for p in (ROOT / "src/repro").rglob("*.py")}
    port = {p.relative_to(ROOT / "src/repro_torch").as_posix()
            for p in (ROOT / "src/repro_torch").rglob("*.py")}
    assert sorted(ref - port - set(EXEMPT)) == []
