"""The IHTC pipeline of the port: kNN, TC, prototypes, ITIS, planner,
memory, streaming and sharded executors and the servable index.

The sharded drivers load lazily (``torch.distributed`` only when asked)."""

_LAZY = {
    "make_data_mesh": "repro_torch.core.distributed",
    "ihtc_sharded": "repro_torch.core.distributed",
    "itis_sharded": "repro_torch.core.distributed",
    "kmeans_sharded": "repro_torch.core.distributed",
    "tc_sharded": "repro_torch.core.distributed",
    "ring_knn": "repro_torch.core.knn",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'repro_torch.core' has no attribute {name!r}")
