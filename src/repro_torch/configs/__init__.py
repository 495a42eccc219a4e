"""Configs of the port (copies of ``repro.configs``)."""
from repro_torch.configs.archs import ARCHS, smoke_config  # noqa: F401
from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ModelConfig,
    ParallelConfig,
    RunConfig,
    ShapeConfig,
)


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]
