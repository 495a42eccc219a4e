"""The IHTC pipeline of the port: kNN, TC, prototypes, ITIS, planner,
memory, streaming and sharded executors and the servable index — the
public names of ``repro.core``.

Every name loads lazily: the sharded drivers (``torch.distributed``) only
when asked, the rest at first use, so ``import repro_torch.core`` stays
cheap."""

_LAZY = {
    **dict.fromkeys(("make_data_mesh", "ihtc_sharded", "itis_sharded",
                     "kmeans_sharded", "tc_sharded"), "repro_torch.core.distributed"),
    **dict.fromkeys(("IHTCResult", "ihtc"), "repro_torch.core.ihtc"),
    **dict.fromkeys(("ClusterIndex", "nearest_valid_prototype"),
                    "repro_torch.core.index"),
    **dict.fromkeys(("ITISResult", "itis", "itis_step", "level_sizes",
                     "validate_reduction_params"), "repro_torch.core.itis"),
    **dict.fromkeys(("knn_graph", "knn_graph_blocked", "ring_knn"),
                    "repro_torch.core.knn"),
    **dict.fromkeys(("FitPlan", "FitResult", "LabelSpill", "Reduction",
                     "available_executors", "execute_plan", "fit", "plan_fit",
                     "register_executor", "resolve_executor"), "repro_torch.core.plan"),
    **dict.fromkeys(("PrototypeSet", "compose_assignments", "reduce_to_prototypes",
                     "standardize"), "repro_torch.core.prototypes"),
    **dict.fromkeys(("StreamingIHTCResult", "ihtc_streaming"),
                    "repro_torch.core.streaming"),
    **dict.fromkeys(("TCResult", "threshold_clustering"), "repro_torch.core.tc"),
}

#: submodules reachable as attributes, as the reference's eager imports make them
_SUBMODULES = ("distributed", "index", "itis", "knn", "plan", "prototypes",
               "streaming", "tc")

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    import importlib

    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    if name in _SUBMODULES:
        return importlib.import_module(f"repro_torch.core.{name}")
    raise AttributeError(f"module 'repro_torch.core' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
