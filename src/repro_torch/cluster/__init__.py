"""Clustering backends of the port (k-means so far) and their registry."""
from repro_torch.cluster.metrics import clustering_accuracy  # noqa: F401
from repro_torch.cluster.registry import (  # noqa: F401
    available_backends,
    register_backend,
    resolve_backend,
)
