"""The LM side of the port: dense decoder-only models (``transformer``),
their layers and attention, the bundle registry and the carry-across of
the reference's parameters (``convert``)."""
from repro_torch.models.registry import ModelBundle, build  # noqa: F401
