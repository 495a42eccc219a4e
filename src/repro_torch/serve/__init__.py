"""Serving front-ends of the port, one import site for everything between
a fit and live traffic::

    from repro_torch.serve import (
        ClusterService,        # micro-batched sync front-end
        AsyncClusterService,   # continuous-batching async front-end
        OnlineFitter,          # long-lived incremental refit
        RefreshDriver,         # policy-driven zero-downtime refresh
        IndexStore,            # versioned, checksummed index artifacts
        ServeEngine,           # LM serving with IHTC KV-cache compression
    )

Names resolve lazily, so ``import repro_torch.serve`` stays cheap.
"""

# public name -> defining module, resolved on first attribute access
_LAZY = {
    "AsyncClusterService": "repro_torch.serve.async_service",
    "AsyncioServeLoop": "repro_torch.serve.async_service",
    "BatchRecord": "repro_torch.serve.async_service",
    "InlineExecutor": "repro_torch.serve.async_service",
    "QueueFullError": "repro_torch.serve.async_service",
    "ServeError": "repro_torch.serve.async_service",
    "ServiceClosedError": "repro_torch.serve.async_service",
    "UnknownTenantError": "repro_torch.serve.async_service",
    "ClusterService": "repro_torch.serve.cluster_service",
    "DEFAULT_BUCKETS": "repro_torch.serve.cluster_service",
    "OnlineFitter": "repro_torch.serve.lifecycle",
    "RefreshPolicy": "repro_torch.serve.lifecycle",
    "RefreshDriver": "repro_torch.serve.lifecycle",
    "IndexStore": "repro_torch.serve.artifacts",
    "ArtifactError": "repro_torch.serve.artifacts",
    "ServeConfig": "repro_torch.serve.engine",
    "ServeEngine": "repro_torch.serve.engine",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'repro_torch.serve' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
