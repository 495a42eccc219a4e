"""Configs of the port (copies of ``repro.configs``)."""
from repro_torch.configs.archs import ARCHS, smoke_config  # noqa: F401
from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ModelConfig,
    ParallelConfig,
    RunConfig,
    ShapeConfig,
)
