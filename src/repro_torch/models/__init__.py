"""The LM side of the port: decoder-only models (``transformer``) of the
dense, MoE, SSM, hybrid and VLM families, the audio encoder-decoder
(``encdec``), the stubbed front ends (``frontends``), their layers,
attention, MoE (``moe``) and Mamba-2 (``mamba2``) blocks, the bundle
registry and the carry-across of the reference's parameters
(``convert``)."""
from repro_torch.models.registry import ModelBundle, build  # noqa: F401
