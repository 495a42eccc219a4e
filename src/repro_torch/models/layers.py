"""Shared layers of the LM — the port of ``repro.models.layers``.

Weights keep the reference's layout (a dense weight is (d_in, d_out) and
applies as ``x @ w``). Serving stores them frozen in the compute dtype,
bf16, once: the reference keeps them in f32 and casts them to bf16 at
every use, which gives the same values. Training stores them as the
reference does, f32 and trainable (``dtype=torch.float32,
requires_grad=True``); every use is a cast at use, so an f32 weight meets
the activations in bf16, the reference's arithmetic. Norm weights stay
f32, as the reference applies them. Activations are bf16 between layers;
norms, rope and the final logits work in f32.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig

COMPUTE_DTYPE = torch.bfloat16


def weight(shape, *, dtype=COMPUTE_DTYPE, device=None,
           requires_grad: bool = False) -> nn.Parameter:
    """An uninitialised weight (filled by ``init`` or ``convert``): frozen
    bf16 for serving, f32 with ``requires_grad`` for training."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=requires_grad)


def dense_init_(w: torch.Tensor, generator: torch.Generator,
                scale: Optional[float] = None) -> None:
    """Fill ``w`` (d_in, ...) with N(0, 1)·scale drawn in f32 (default
    scale 1/sqrt(d_in)), as the reference's ``_dense_init``. A slice of a
    sharded leaf (``w.whole``: the leaf's shape, the sliced dimension and
    the slice's first index; ``tensor_parallel.init_sharded``) draws the
    whole leaf and keeps its slice."""
    shape, dim, lo = getattr(w, "whole", (w.shape, None, 0))
    s = (1.0 / shape[0]) ** 0.5 if scale is None else scale
    draw = torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=generator.device).mul_(s)
    if dim is not None:
        draw = draw.narrow(dim, lo, w.shape[dim])
    with torch.no_grad():
        w.copy_(draw.to(w.device, w.dtype))


# ---------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm with gemma's ``(1 + w)`` weight, in f32; returns x's dtype."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + w.float())
    return out.to(dt)


# ---------------------------------------------------------------- rope
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., seq, n_heads, head_dim); positions:
    (..., seq)."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freq  # (..., seq, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- specs
def mlp_specs(kind: str, tp: Optional[str] = "model") -> dict:
    """The reference's ``mlp_specs``: gate and up column-parallel, down
    row-parallel over ``tp`` (one tuple per dimension)."""
    p = {"down": (tp, None), "up": (None, tp)}
    if kind == "swiglu":
        p["gate"] = (None, tp)
    return p


def embed_specs(cfg: ModelConfig, tp: Optional[str] = "model") -> dict:
    """The reference's ``embed_specs``: the vocabulary over ``tp``."""
    p = {"table": (tp, None)}
    if not cfg.tie_embeddings:
        p["unembed"] = (None, tp)
    return p


# ---------------------------------------------------------------- mlp
class MLP(nn.Module):
    """swiglu (gate, up, down) | relu2 | gelu (up, down), in bf16."""

    def __init__(self, d: int, ff: int, kind: str, *, device=None,
                 dtype=COMPUTE_DTYPE, requires_grad: bool = False):
        super().__init__()
        if kind not in ("swiglu", "relu2", "gelu"):
            raise ValueError(f"unknown mlp kind {kind!r}")
        self.kind = kind
        kw = dict(device=device, dtype=dtype, requires_grad=requires_grad)
        self.up = weight((d, ff), **kw)
        self.down = weight((ff, d), **kw)
        if kind == "swiglu":
            self.gate = weight((d, ff), **kw)

    def forward(self, x: torch.Tensor, tp=None) -> torch.Tensor:
        """``tp`` (a sharded model's ``TensorParallel``): gate and up hold
        this rank's columns, down its rows; the output is summed over the
        model ranks."""
        from repro_torch.models.tensor_parallel import column_mm

        dt = x.dtype
        if tp is not None:
            x = tp.column_input(x)
        up = column_mm(x, self.up, dt)
        if self.kind == "swiglu":
            h = nn.functional.silu(column_mm(x, self.gate, dt)) * up
        elif self.kind == "relu2":
            h = torch.square(torch.relu(up))
        else:  # the reference's jax.nn.gelu: the tanh approximation
            h = nn.functional.gelu(up, approximate="tanh")
        return h @ self.down.to(dt) if tp is None else tp.row_reduce(h, self.down, dt)


# ---------------------------------------------------------------- embedding
class Embed(nn.Module):
    """Token table (padded vocab) and, untied, the unembedding."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=COMPUTE_DTYPE,
                 requires_grad: bool = False):
        super().__init__()
        self.cfg = cfg
        v = cfg.padded_vocab_size
        kw = dict(device=device, dtype=dtype, requires_grad=requires_grad)
        self.table = weight((v, cfg.d_model), **kw)
        if not cfg.tie_embeddings:
            self.unembed = weight((cfg.d_model, v), **kw)

    def embed(self, tokens: torch.Tensor, tp=None) -> torch.Tensor:
        """The tokens' rows in bf16 (gemma scales them by sqrt(d)); ``tp``:
        the table holds this rank's rows of the vocabulary."""
        table = self.table.to(COMPUTE_DTYPE)
        x = table[tokens] if tp is None else tp.embed(table, tokens)
        cfg = self.cfg
        if cfg.family in ("dense",) and cfg.name.startswith("gemma"):
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=COMPUTE_DTYPE,
                                 device=x.device)
        return x

    def logits(self, x: torch.Tensor, tp=None) -> torch.Tensor:
        """(…, padded_vocab) f32 logits: final softcap, padding masked;
        ``tp``: this rank's columns of them (…, padded_vocab / tp)."""
        from repro_torch.models.tensor_parallel import column_mm

        cfg = self.cfg
        dt = x.dtype
        if tp is not None:
            x = tp.column_input(x)
        if cfg.tie_embeddings:
            logits = column_mm(x, self.table.T, dt)
        else:
            logits = column_mm(x, self.unembed, dt)
        logits = logits.float()
        if cfg.final_logit_softcap:
            c = cfg.final_logit_softcap
            logits = c * torch.tanh(logits / c)
        if cfg.padded_vocab_size != cfg.vocab_size:
            per = logits.shape[-1]
            col = torch.arange(per, device=x.device)
            if tp is not None:
                col = col + tp.index * per
            logits = torch.where(col < cfg.vocab_size, logits, -1e30)
        return logits
