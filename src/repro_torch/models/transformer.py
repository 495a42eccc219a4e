"""Decoder-only LM — the port of ``repro.models.transformer``, for the
dense family (attention + dense MLP layers, with gemma2's post-norms).

The reference stacks the repeated layer group on a leading axis and scans
it; here the model is a plain list of per-layer modules. :func:`stack_plan`
is kept: it says how the reference's parameters and caches are laid out
(``convert.py`` unstacks them) and which PRNG key the KV compression gives
each layer (``serve/kv_compression.py``).

MoE, Mamba2, hybrid, VLM and enc-dec families are not ported yet
(ROADMAP.md, Queue 1, slice 8): building one raises NotImplementedError.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    COMPUTE_DTYPE,
    MLP,
    Embed,
    dense_init_,
    rms_norm,
)


def dense_ff(cfg: ModelConfig, layer: int) -> int:
    if cfg.dense_d_ff and layer < cfg.first_dense_layers:
        return cfg.dense_d_ff
    return cfg.d_ff


def _signature(cfg: ModelConfig, layer: int) -> tuple:
    kind = cfg.layer_kind(layer)
    return (
        kind,
        cfg.layer_is_moe(layer),
        cfg.attn_type(layer) if kind == "attn" else "",
        dense_ff(cfg, layer),
    )


def stack_plan(cfg: ModelConfig, max_period: int = 8) -> Tuple[int, int, int]:
    """(n_prefix, period, n_repeats) of the reference's layer layout:
    layers [0, n_prefix) stand alone; the rest is ``n_repeats`` copies of
    a ``period``-layer group (layer = n_prefix + r·period + j)."""
    sigs = [_signature(cfg, l) for l in range(cfg.n_layers)]
    n = len(sigs)
    if not cfg.scan_layers:
        return n, 1, 0
    for prefix in range(0, min(n, 4)):
        rest = sigs[prefix:]
        for period in range(1, min(len(rest), max_period) + 1):
            if len(rest) % period:
                continue
            if all(rest[i] == rest[i % period] for i in range(len(rest))):
                if len(rest) // period >= 2:
                    return prefix, period, len(rest) // period
    return n, 1, 0


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the families the port does not build yet."""
    if cfg.family != "dense" or cfg.frontend or cfg.n_enc_layers:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet; the "
            f"port builds the dense attention + MLP LMs (ROADMAP.md, Queue 1, "
            f"slice 8)")
    for layer in range(cfg.n_layers):
        if cfg.layer_kind(layer) != "attn" or cfg.layer_is_moe(layer):
            raise NotImplementedError(
                f"{cfg.name}: layer {layer} is not attention + dense MLP; "
                f"MoE and Mamba layers are not ported yet (ROADMAP.md, "
                f"Queue 1, slice 8)")
        if dense_ff(cfg, layer) <= 0:
            raise NotImplementedError(f"{cfg.name}: layer {layer} has no FFN")


class Block(nn.Module):
    """Pre-norm attention and MLP sub-blocks (post-norms with
    ``cfg.post_norm``); norm weights in f32, zero-initialised (1 + w)."""

    def __init__(self, cfg: ModelConfig, layer: int, *, device=None):
        super().__init__()
        self.cfg, self.layer = cfg, layer
        d = cfg.d_model

        def norm():
            return nn.Parameter(torch.zeros(d, dtype=torch.float32, device=device),
                                requires_grad=False)

        self.ln1, self.ln2 = norm(), norm()
        self.attn = attn.Attention(cfg, device=device)
        self.mlp = MLP(d, dense_ff(cfg, layer), cfg.mlp, device=device)
        if cfg.post_norm:
            self.ln1_post, self.ln2_post = norm(), norm()

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cache: Optional[dict], impl: Optional[str]
                ) -> Tuple[torch.Tensor, Optional[dict]]:
        cfg = self.cfg
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        y, new_cache = attn.attention_apply(self.attn, h, cfg, layer=self.layer,
                                            positions=positions, cache=cache,
                                            impl=impl)
        if cfg.post_norm:
            y = rms_norm(y, self.ln1_post, cfg.norm_eps)
        x = x + y
        y2 = self.mlp(rms_norm(x, self.ln2, cfg.norm_eps))
        if cfg.post_norm:
            y2 = rms_norm(y2, self.ln2_post, cfg.norm_eps)
        return x + y2, new_cache


class LM(nn.Module):
    """Embedding → blocks → final norm → (soft-capped) logits."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.embed = Embed(cfg, device=device)
        self.layers = nn.ModuleList(Block(cfg, l, device=device)
                                    for l in range(cfg.n_layers))
        self.ln_f = nn.Parameter(torch.zeros(cfg.d_model, dtype=torch.float32,
                                             device=device), requires_grad=False)

    def init_weights(self, generator: torch.Generator) -> "LM":
        """Random weights drawn from ``generator`` (f32 normals scaled as
        the reference's init, stored in bf16); norms stay 0."""
        dense_init_(self.embed.table, generator, scale=1.0)
        if not self.cfg.tie_embeddings:
            dense_init_(self.embed.unembed, generator)
        for blk in self.layers:
            a = blk.attn
            for w in (a.wq, a.wk, a.wv, a.wo):
                dense_init_(w, generator)
            for name in ("bq", "bk", "bv"):
                if hasattr(a, name):
                    getattr(a, name).zero_()
            for name in ("gate", "up", "down"):
                if hasattr(blk.mlp, name):
                    dense_init_(getattr(blk.mlp, name), generator)
        return self

    def forward(
        self,
        tokens: torch.Tensor,                 # (b, s) integer ids
        *,
        caches: Optional[dict] = None,
        start_pos: Optional[int] = None,      # decode offset
        impl: Optional[str] = None,
        last_only: bool = False,
    ) -> Tuple[torch.Tensor, Optional[dict]]:
        """(logits (b, s or 1, padded_vocab) f32, caches). ``last_only``
        unembeds only the last position (prefill: the reference keeps
        ``logits[:, -1:]`` of the full set, the same numbers)."""
        cfg = self.cfg
        x = self.embed.embed(tokens).to(COMPUTE_DTYPE)
        b, s, _ = x.shape
        offset = 0 if start_pos is None else int(start_pos)
        positions = (offset + torch.arange(s, device=x.device)).expand(b, s)
        layer_caches: List[Optional[dict]] = (
            caches["layers"] if caches is not None else [None] * cfg.n_layers)
        new_layers = []
        for blk, c in zip(self.layers, layer_caches, strict=True):
            x, nc = blk(x, positions, c, impl)
            new_layers.append(nc)
        x = rms_norm(x, self.ln_f, cfg.norm_eps)
        if last_only:
            x = x[:, -1:]
        logits = self.embed.logits(x)
        new_caches = None if caches is None else {**caches, "layers": new_layers}
        return logits, new_caches


def init_lm_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                   dtype=COMPUTE_DTYPE, device=None) -> dict:
    """``{"layers": [per-layer cache], "n_prefix", "period"}`` — the layer
    list with the reference's stack plan beside it."""
    n_prefix, period, _ = stack_plan(cfg)
    return {
        "layers": [attn.init_cache(cfg, batch, max_len, dtype=dtype, device=device)
                   for _ in range(cfg.n_layers)],
        "n_prefix": n_prefix,
        "period": period,
    }


def cache_start_pos(caches: dict) -> int:
    """Current decode position: the first attention cache's ``pos``."""
    for c in caches["layers"]:
        if c is not None and "pos" in c:
            return int(c["pos"])
    return 0
