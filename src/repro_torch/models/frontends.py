"""Modality front-end stubs — the port of ``repro.models.frontends``.

The audio and vision configs exercise the transformer backbone; their front
ends (a speech encoder, a CLIP tower) are stubs in the reference too, whose
output is drawn from a seed. The draw here is the reference's bit for bit:
``prng.normal`` (jax's threefry and XLA's ``erf_inv``) in f32, rounded to bf16,
times 0.02 in bf16.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import prng
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import COMPUTE_DTYPE

VISION_PREFIX_TOKENS = 256   # CLIP-style patch-embedding prefix length


def frontend_embed_shape(cfg: ModelConfig, batch: int, seq_len: int
                         ) -> Optional[Tuple[int, int, int]]:
    """Shape of the stubbed front end's output for this arch and shape."""
    if cfg.frontend == "audio":
        return (batch, seq_len, cfg.d_model)               # encoder frames
    if cfg.frontend == "vision":
        return (batch, VISION_PREFIX_TOKENS, cfg.d_model)  # patch prefix
    return None


def fake_frontend_embeddings(key: torch.Tensor, cfg: ModelConfig, batch: int,
                             seq_len: int, *, device=None
                             ) -> Optional[torch.Tensor]:
    """The stub's output: N(0, 1) in f32 to bf16, times 0.02 (bf16), or
    None for an arch without a front end."""
    shape = frontend_embed_shape(cfg, batch, seq_len)
    if shape is None:
        return None
    x = prng.normal(key, shape, device=device).to(COMPUTE_DTYPE)
    # jax rounds the weakly typed 0.02 to bf16 before the product
    return x * torch.tensor(0.02, dtype=COMPUTE_DTYPE, device=x.device)
