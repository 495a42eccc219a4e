"""Clustering backends of the port (k-means, HAC, DBSCAN) and their
registry — the public names of ``repro.cluster``.

Backends self-register with :mod:`repro_torch.cluster.registry` at import;
resolve names (or validate callables) through :func:`resolve_backend`."""
from repro_torch.cluster import dbscan, hac, kmeans, metrics  # noqa: F401
from repro_torch.cluster.metrics import clustering_accuracy  # noqa: F401
from repro_torch.cluster.registry import (  # noqa: F401
    BackendFn,
    available_backends,
    register_backend,
    resolve_backend,
    validate_backend_fn,
)
