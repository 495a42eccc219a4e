"""Serving front-ends of the port: the cluster-assign service and the LM
engine with IHTC KV-cache compression."""
from repro_torch.serve.cluster_service import ClusterService  # noqa: F401
from repro_torch.serve.engine import ServeConfig, ServeEngine  # noqa: F401
