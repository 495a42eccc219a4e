"""repro_torch — Hybridized Threshold Clustering in PyTorch, with
hand-written CUDA kernels for Hopper.

The port of the JAX package ``repro`` (which stays the reference).
``repro_torch.fit(x_or_chunks, t, m, backend)`` runs the IHTC pipeline on
a resident array or a chunk stream; ``ClusterIndex.build(result)`` freezes
the servable index, ``ClusterService(index).assign(queries)`` or
``AsyncClusterService`` serves it, ``IndexStore`` versions it, and
``OnlineFitter`` / ``RefreshDriver`` keep it fresh under live traffic.
Under ``mesh=make_data_mesh()`` (one process per rank) the fit shards its
rows over the ranks. Entry points run on
``device="cuda"`` unless the caller passes ``device="cpu"`` (or configures
it); a missing GPU raises.

Heavy submodules load lazily, so ``import repro_torch`` stays cheap.
"""
from repro_torch import runtime  # noqa: F401

_LAZY = {
    "fit": "repro_torch.core.plan",
    "plan_fit": "repro_torch.core.plan",
    "execute_plan": "repro_torch.core.plan",
    "FitPlan": "repro_torch.core.plan",
    "FitResult": "repro_torch.core.plan",
    "register_executor": "repro_torch.core.plan",
    "available_executors": "repro_torch.core.plan",
    "ClusterIndex": "repro_torch.core.index",
    "ClusterService": "repro_torch.serve.cluster_service",
    "AsyncClusterService": "repro_torch.serve.async_service",
    "OnlineFitter": "repro_torch.serve.lifecycle",
    "RefreshDriver": "repro_torch.serve.lifecycle",
    "RefreshPolicy": "repro_torch.serve.lifecycle",
    "IndexStore": "repro_torch.serve.artifacts",
    "ihtc": "repro_torch.core.ihtc",
    "ihtc_sharded": "repro_torch.core.distributed",
    "ihtc_streaming": "repro_torch.core.streaming",
    "make_data_mesh": "repro_torch.core.distributed",
}

__all__ = ["runtime", *sorted(_LAZY)]


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
