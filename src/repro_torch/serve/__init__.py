"""Serving front-ends of the port."""
from repro_torch.serve.cluster_service import ClusterService  # noqa: F401
