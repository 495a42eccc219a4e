"""Encoder-decoder (the seamless-m4t backbone) — the port of
``repro.models.encdec``.

The encoder takes precomputed frame embeddings (the speech front end is a
stub, ``models/frontends.py``): pre-norm blocks of non-causal,
rotary self-attention and a gelu MLP, then ``ln_enc``. The decoder is a
causal LM whose blocks add a cross-attention into the encoder output
between self-attention and MLP (``ln_x``), then ``ln_f`` and the
unembedding. The reference stacks each side's layers on a leading axis and
scans them; here each side is a plain list of layer modules, run in a
loop, with the reference's float operations in its order.

Training: ``remat`` "block" or "dots" recomputes each encoder block and
each decoder block in the backward pass (``torch.utils.checkpoint``), as
the reference's ``jax.checkpoint`` of each scanned block; the reference
gives the enc-dec no policy, so "dots" is the same plain checkpoint as
"block" here. The values do not depend on ``remat``.

Caches are per layer: ``{"layers": [{"self": attention cache, "cross_k",
"cross_v": (b, hkv, s_enc, hd)}, ...]}``. The cross k/v are projected once,
in the prefill, from the encoder output, and reused by every decode step
(the reference's ``_project_cross_kv``); they are kept heads first, the
layout attention reads, where the reference keeps (b, s_enc, hkv, hd).

On a model axis (``tensor_parallel.shard_model``, ``self.tp``; every call
then takes the cell's ``plan``): the encoder's and the decoder's
self-attention, the cross-attention's q and the MLPs run on this rank's
heads and columns, the embedding, unembedding and loss over its rows of
the vocabulary, as the decoder-only LM's; each decoder layer projects the
cross k/v of this rank's kv heads from its ``wk``/``wv`` columns
(``TensorParallel.cross_kv_operands``), and the cross k/v cache holds
those heads, while ``encdec_cache_specs`` keeps the reference's (dp,
None, None, None): the same choice as the Mamba conv cache's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import tensor_parallel
from repro_torch.models.layers import (
    COMPUTE_DTYPE,
    MLP,
    Embed,
    dense_init_,
    rms_norm,
)
from repro_torch.models.transformer import REMATS


def _norm(d: int, device, requires_grad: bool) -> nn.Parameter:
    return nn.Parameter(torch.zeros(d, dtype=torch.float32, device=device),
                        requires_grad=requires_grad)


class EncLayer(nn.Module):
    """ln1 → non-causal self-attention → ln2 → MLP, both residual."""

    def __init__(self, cfg: ModelConfig, *, device=None, requires_grad=False,
                 dtype=COMPUTE_DTYPE):
        super().__init__()
        kw = dict(device=device, dtype=dtype, requires_grad=requires_grad)
        self.ln1 = _norm(cfg.d_model, device, requires_grad)
        self.attn = attn.Attention(cfg, **kw)
        self.ln2 = _norm(cfg.d_model, device, requires_grad)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp, **kw)


class DecLayer(nn.Module):
    """ln1 → causal self-attention → ln_x → cross-attention → ln2 → MLP."""

    def __init__(self, cfg: ModelConfig, *, device=None, requires_grad=False,
                 dtype=COMPUTE_DTYPE):
        super().__init__()
        kw = dict(device=device, dtype=dtype, requires_grad=requires_grad)
        d = cfg.d_model
        self.ln1 = _norm(d, device, requires_grad)
        self.self_attn = attn.Attention(cfg, **kw)
        self.ln_x = _norm(d, device, requires_grad)
        self.cross_attn = attn.Attention(cfg, **kw)
        self.ln2 = _norm(d, device, requires_grad)
        self.mlp = MLP(d, cfg.d_ff, cfg.mlp, **kw)


def project_cross_kv(p: attn.Attention, enc_out: torch.Tensor, cfg: ModelConfig,
                     tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """A decoder layer's cross k/v, (b, hkv, s_enc, hd) each, from the
    (b, s_enc, d) encoder output: no bias, no rope (the reference's
    ``_project_cross_kv``). ``tp``: the kv heads this rank holds
    (``TensorParallel.cross_kv_operands``)."""
    b, s, _ = enc_out.shape
    dt = enc_out.dtype
    x, wk, wv, hkv = enc_out, p.wk, p.wv, cfg.n_kv_heads
    if tp is not None:
        x, wk, wv, hkv = tp.cross_kv_operands(p, enc_out)
    k = tensor_parallel.column_mm(x, wk, dt).reshape(b, s, hkv, cfg.head_dim)
    v = tensor_parallel.column_mm(x, wv, dt).reshape(b, s, hkv, cfg.head_dim)
    return k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()


class EncDec(nn.Module):
    """Embedding, encoder and decoder stacks, ``ln_enc`` and ``ln_f``.

    ``trainable=False`` (serving): frozen bf16 weights; ``trainable=True``:
    f32 weights and norms with ``requires_grad``, as ``LM``. ``tp``: None
    on one device, the ``TensorParallel`` of a model sliced over a mesh's
    "model" dimension (module docstring)."""

    tp = None

    def __init__(self, cfg: ModelConfig, *, device=None, trainable: bool = False):
        super().__init__()
        if cfg.family != "encdec-audio":
            raise ValueError(f"{cfg.name}: EncDec builds the encdec-audio "
                             f"family, not {cfg.family!r}")
        self.cfg = cfg
        kw = dict(device=device, requires_grad=trainable,
                  dtype=torch.float32 if trainable else COMPUTE_DTYPE)
        self.embed = Embed(cfg, **kw)
        self.enc = nn.ModuleList(EncLayer(cfg, **kw) for _ in range(cfg.n_enc_layers))
        self.dec = nn.ModuleList(DecLayer(cfg, **kw) for _ in range(cfg.n_layers))
        self.ln_enc = _norm(cfg.d_model, device, trainable)
        self.ln_f = _norm(cfg.d_model, device, trainable)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "EncDec":
        """Random weights from ``generator`` at the reference's init
        scales; norms set to 0."""
        dense_init_(self.embed.table, generator, scale=1.0)
        if not self.cfg.tie_embeddings:
            dense_init_(self.embed.unembed, generator)
        for name, p in self.named_parameters():
            if name.startswith("embed."):
                continue
            if p.ndim == 1:  # norms (the attention biases are zero too)
                p.zero_()
            else:
                dense_init_(p, generator)
        return self

    def _bound(self, plan):
        """The model's layout bound to ``plan`` (None on one device)."""
        return self.tp.bind(plan) if self.tp is not None else None

    def _enc_block(self, lp: EncLayer, x: torch.Tensor, positions: torch.Tensor,
                   impl: Optional[str], tp) -> torch.Tensor:
        cfg = self.cfg
        h = rms_norm(x, lp.ln1, cfg.norm_eps)
        y, _ = attn.attention_apply(lp.attn, h, cfg, layer=0, positions=positions,
                                    causal=False, impl=impl, tp=tp)
        x = x + y
        return x + lp.mlp(rms_norm(x, lp.ln2, cfg.norm_eps), tp)

    def encode(self, frames: torch.Tensor, *, impl: Optional[str] = None,
               remat: str = "none", plan=None) -> torch.Tensor:
        """frames (b, s_enc, d) → the encoder output (b, s_enc, d) bf16
        (replicated over the model ranks)."""
        _check_remat(remat)
        tp = self._bound(plan)
        x = frames.to(COMPUTE_DTYPE)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        for lp in self.enc:
            x = _run(self._enc_block, remat, lp, x, positions, impl, tp)
        return rms_norm(x, self.ln_enc, self.cfg.norm_eps)

    def _dec_block(self, lp: DecLayer, x: torch.Tensor, positions: torch.Tensor,
                   cache: Optional[dict], enc_out: Optional[torch.Tensor],
                   impl: Optional[str], tp):
        """(x, the layer's new cache or None). A decode step (s = 1 with a
        cache) attends to the cached cross k/v; otherwise the layer
        projects them from ``enc_out``."""
        cfg = self.cfg
        h = rms_norm(x, lp.ln1, cfg.norm_eps)
        y, new_self = attn.attention_apply(
            lp.self_attn, h, cfg, layer=0, positions=positions,
            cache=cache["self"] if cache is not None else None, impl=impl, tp=tp)
        x = x + y
        hx = rms_norm(x, lp.ln_x, cfg.norm_eps)
        if cache is not None and x.shape[1] == 1:
            cross = (cache["cross_k"], cache["cross_v"])  # decode: reuse
        else:
            cross = project_cross_kv(lp.cross_attn, enc_out, cfg, tp)  # prefill
        yx, _ = attn.attention_apply(lp.cross_attn, hx, cfg, layer=0,
                                     positions=positions, causal=False,
                                     cross_kv=cross, impl=impl, tp=tp)
        x = x + yx
        x = x + lp.mlp(rms_norm(x, lp.ln2, cfg.norm_eps), tp)
        if cache is None:
            return x, None
        return x, {"self": new_self, "cross_k": cross[0], "cross_v": cross[1]}

    def decode(
        self,
        tokens: torch.Tensor,                 # (b, s) integer ids
        enc_out: Optional[torch.Tensor],      # (b, s_enc, d); None: from caches
        *,
        caches: Optional[dict] = None,
        start_pos: Optional[int] = None,
        impl: Optional[str] = None,
        last_only: bool = False,
        remat: str = "none",
        plan=None,
    ) -> Tuple[torch.Tensor, Optional[dict]]:
        """(logits (b, s or 1, padded_vocab) f32, caches; on a model axis
        this rank's vocabulary columns of the logits). A decode step (s = 1
        with caches) attends to the cached cross k/v; otherwise each layer
        projects them from ``enc_out`` (and, with caches, stores them).
        ``remat`` (training) takes no caches."""
        _check_remat(remat)
        if remat != "none" and caches is not None:
            raise ValueError("remat is for training, which passes no caches")
        cfg = self.cfg
        tp = self._bound(plan)
        x = self.embed.embed(tokens, tp).to(COMPUTE_DTYPE)
        b, s, _ = x.shape
        offset = 0 if start_pos is None else int(start_pos)
        positions = (offset + torch.arange(s, device=x.device)).expand(b, s)
        layer_caches = caches["layers"] if caches is not None else [None] * cfg.n_layers
        new_layers = []
        for lp, c in zip(self.dec, layer_caches, strict=True):
            if c is None:
                x, _ = _run(self._dec_block, remat, lp, x, positions, None,
                            enc_out, impl, tp)
            else:
                x, nc = self._dec_block(lp, x, positions, c, enc_out, impl, tp)
                new_layers.append(nc)
        x = rms_norm(x, self.ln_f, cfg.norm_eps)
        if last_only:
            x = x[:, -1:]
        logits = self.embed.logits(x, tp)
        new_caches = {**caches, "layers": new_layers} if caches is not None else None
        return logits, new_caches

    def forward(self, frames: torch.Tensor, tokens: torch.Tensor, *,
                impl: Optional[str] = None, remat: str = "none",
                plan=None) -> torch.Tensor:
        """The full (b, s, padded_vocab) f32 logits of the decoder (on a
        model axis, this rank's vocabulary columns)."""
        enc_out = self.encode(frames, impl=impl, remat=remat, plan=plan)
        return self.decode(tokens, enc_out, impl=impl, remat=remat, plan=plan)[0]


def _check_remat(remat: str) -> None:
    if remat not in REMATS:
        raise ValueError(f"remat must be one of {REMATS}, got {remat!r}")


def _run(block, remat: str, *args):
    """``block(*args)``, checkpointed unless ``remat`` is "none"."""
    if remat == "none":
        return block(*args)
    return ckpt.checkpoint(block, *args, use_reentrant=False)


def encdec_specs(cfg: ModelConfig, tp: Optional[str] = "model", tp_size: int = 1) -> dict:
    """The reference's ``encdec_specs`` keyed by the port's parameter names
    (every encoder and decoder layer's leaf without the stack's leading
    None)."""
    from repro_torch.models.layers import embed_specs, mlp_specs

    a = attn.attention_specs(cfg, tp, tp_size)
    m = mlp_specs(cfg.mlp, tp)

    def sub(prefix: str, specs: dict) -> dict:
        return {f"{prefix}.{k}": v for k, v in specs.items()}

    specs = sub("embed", embed_specs(cfg, tp))
    for i in range(cfg.n_enc_layers):
        specs.update({f"enc.{i}.ln1": (None,), f"enc.{i}.ln2": (None,),
                      **sub(f"enc.{i}.attn", a), **sub(f"enc.{i}.mlp", m)})
    for i in range(cfg.n_layers):
        specs.update({f"dec.{i}.ln1": (None,), f"dec.{i}.ln_x": (None,),
                      f"dec.{i}.ln2": (None,), **sub(f"dec.{i}.self_attn", a),
                      **sub(f"dec.{i}.cross_attn", a), **sub(f"dec.{i}.mlp", m)})
    specs.update(ln_enc=(None,), ln_f=(None,))
    return specs


def encdec_cache_specs(cfg: ModelConfig, plan, tp_size: int = 1) -> dict:
    """The reference's ``encdec_cache_specs``, laid out as
    :func:`init_encdec_caches` lays out the caches."""
    from repro_torch.models.transformer import layer_cache_spec

    dp = plan.resid[0] if plan.resid is not None else None
    one = {"self": layer_cache_spec(cfg, 0, plan, tp_size),
           "cross_k": (dp, None, None, None), "cross_v": (dp, None, None, None)}
    return {"layers": [dict(one) for _ in range(cfg.n_layers)]}


def init_encdec_caches(cfg: ModelConfig, batch: int, max_len: int, enc_len: int,
                       *, dtype=COMPUTE_DTYPE, device=None, tp_size: int = 1,
                       layout=None) -> dict:
    """Per decoder layer: a self-attention cache of ``max_len`` slots and
    zero cross k/v of ``enc_len`` (the prefill replaces them). ``tp_size``:
    one rank's caches over that many model ranks, the kv heads it projects
    (``tensor_parallel.cache_kv_heads``); ``layout`` (the cell's
    ``tensor_parallel.CacheLayout``): the self-attention cache's heads and
    slots by it."""
    from repro_torch.models.tensor_parallel import cache_kv_heads

    heads = cache_kv_heads(cfg, tp_size)
    shape = (batch, heads, enc_len, cfg.head_dim)
    self_heads = layout.heads if layout is not None else heads
    seq = layout.seq if layout is not None else None
    return {"layers": [
        {"self": attn.init_cache(cfg, batch, max_len, dtype=dtype, device=device,
                                 kv_heads=self_heads, seq=seq),
         "cross_k": torch.zeros(shape, dtype=dtype, device=device),
         "cross_v": torch.zeros(shape, dtype=dtype, device=device)}
        for _ in range(cfg.n_layers)]}


def cache_start_pos(caches: dict) -> int:
    """The decode position: the first layer's self-attention ``pos``."""
    return int(caches["layers"][0]["self"]["pos"])
