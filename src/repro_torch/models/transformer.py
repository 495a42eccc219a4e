"""Decoder-only LM — the port of ``repro.models.transformer``: the dense,
MoE, SSM and hybrid families (a layer is attention or Mamba, then a MoE,
a dense MLP or, in a pure-Mamba block, no FFN; gemma2's post-norms).

The reference stacks the repeated layer group on a leading axis and scans
it; here the model is a plain list of per-layer modules. :func:`stack_plan`
is kept: it says how the reference's parameters and caches are laid out
(``convert.py`` and ``utils/tree.py`` map them), which PRNG key the KV
compression gives each layer (``serve/kv_compression.py``) and which
layers one rematerialised group of training holds.

``LM(cfg)`` is the frozen bf16 serving model; ``LM(cfg, trainable=True)``
holds f32 weights with ``requires_grad``, as the reference trains them;
:meth:`LM.forward` with ``remat`` gives the full (b, s, padded_vocab)
logits under autograd with the reference's rematerialisation policies.

The VLM is this LM with a patch-embedding prefix (``prefix_embeds``);
the enc-dec family is ``models/encdec.py``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba2
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (
    COMPUTE_DTYPE,
    MLP,
    Embed,
    dense_init_,
    embed_specs,
    mlp_specs,
    rms_norm,
)

#: a sharding spec: one entry a leading dimension (None, a mesh dimension's
#: name, or a tuple of names), the reference's ``PartitionSpec`` as a tuple
Spec = Tuple


@dataclass(frozen=True)
class ShardingPlan:
    """The reference's activation layout of one (arch x shape x mesh) cell
    (``launch.mesh.make_plan``), as spec tuples; None leaves a tensor
    unconstrained. The port's tensor-parallel paths read ``heads`` and
    ``kv`` (which attention layout runs), ``cache`` (the decode caches) and
    ``logits`` (the vocabulary over "model")."""
    resid: Optional[Spec] = None        # (b, s, d)
    heads: Optional[Spec] = None        # (b, h, s, hd): the query tensor
    kv: Optional[Spec] = None           # (b, hkv, s, hd): fresh k/v
    mamba_heads: Optional[Spec] = None  # (b, s, h, p)
    ep: Optional[Spec] = None           # (g, e, c, d): the MoE dispatch buffer
    cache: Optional[Spec] = None        # (b, hkv, S, hd)
    logits: Optional[Spec] = None       # (b, s, v)


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


#: the families the port builds: decoder-only LMs (``LM``; the VLM with a
#: patch-embedding prefix) and the audio encoder-decoder (``encdec.EncDec``)
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "encdec-audio")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a family the port does not know (every arch of ``ARCHS``
    is built)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported; the port "
            f"builds {', '.join(FAMILIES)} (see ROADMAP.md)")


def _prefixed(prefix: str, specs: dict) -> dict:
    return {f"{prefix}.{k}": v for k, v in specs.items()}


def layer_specs(cfg: ModelConfig, layer: int, tp: Optional[str] = "model",
                tp_size: int = 1) -> dict:
    """The reference's ``layer_specs`` of decoder layer ``layer``, keyed by
    the port's names within a ``Block`` ("ln1", "attn.wq", "mlp.up")."""
    p = {"ln1": (None,)}
    if cfg.layer_kind(layer) == "attn":
        p.update(_prefixed("attn", attn.attention_specs(cfg, tp, tp_size)))
    else:
        p.update(_prefixed("mamba", mamba2.mamba_specs(cfg, tp, tp_size)))
    if cfg.layer_is_moe(layer):
        p.update(_prefixed("moe", moe_mod.moe_specs(cfg, tp, tp_size)))
    elif dense_ff(cfg, layer) > 0:
        p.update(_prefixed("mlp", mlp_specs(cfg.mlp, tp)))
    if cfg.layer_is_moe(layer) or dense_ff(cfg, layer) > 0:
        p["ln2"] = (None,)
    if cfg.post_norm:
        p["ln1_post"] = p["ln2_post"] = (None,)
    return p


def lm_specs(cfg: ModelConfig, tp: Optional[str] = "model", tp_size: int = 1) -> dict:
    """The reference's ``lm_specs`` keyed by the port's parameter names. A
    scanned reference leaf carries a leading None for its repeat axis; the
    port's per-layer leaf has the spec without it."""
    specs = _prefixed("embed", embed_specs(cfg, tp))
    for l in range(cfg.n_layers):
        specs.update(_prefixed(f"layers.{l}", layer_specs(cfg, l, tp, tp_size)))
    specs["ln_f"] = (None,)
    return specs


def layer_cache_spec(cfg: ModelConfig, layer: int, plan: ShardingPlan,
                     tp_size: int = 1) -> dict:
    """The reference's ``_layer_cache_spec``: an attention layer's k and v
    by ``plan.cache`` (whole without one); a Mamba layer's state by the
    batch axes of ``plan.resid`` and its heads over "model" where they
    divide."""
    dp = plan.resid[0] if plan.resid is not None else None
    if cfg.layer_kind(layer) == "attn":
        spec = plan.cache if plan.cache is not None else (None,)
        return {"k": spec, "v": spec, "pos": ()}
    _, h, _, _ = mamba2.dims(cfg)
    head_ok = h % max(tp_size, 1) == 0
    return {"ssm": (dp, "model" if head_ok else None, None, None),
            "conv": (dp, None, None)}


def cache_specs(cfg: ModelConfig, plan: ShardingPlan, tp_size: int = 1) -> dict:
    """The spec of every layer's cache, laid out as :func:`init_lm_caches`
    lays out the caches (``{"layers": [...]}``)."""
    return {"layers": [layer_cache_spec(cfg, l, plan, tp_size)
                       for l in range(cfg.n_layers)]}


class Block(nn.Module):
    """One decoder layer: pre-norm attention or Mamba, then (after ``ln2``)
    a MoE or a dense MLP; a pure-Mamba block (``dense_ff`` 0, not MoE) has
    no FFN sub-block and no ``ln2``, as in the reference's ``init_layer``.
    Post-norms with ``cfg.post_norm``; norm weights in f32,
    zero-initialised (1 + w)."""

    def __init__(self, cfg: ModelConfig, layer: int, *, device=None,
                 dtype=COMPUTE_DTYPE, requires_grad: bool = False):
        super().__init__()
        self.cfg, self.layer = cfg, layer
        d = cfg.d_model

        def norm():
            return nn.Parameter(torch.zeros(d, dtype=torch.float32, device=device),
                                requires_grad=requires_grad)

        kw = dict(device=device, dtype=dtype, requires_grad=requires_grad)
        self.ln1 = norm()
        if cfg.layer_kind(layer) == "attn":
            self.attn = attn.Attention(cfg, **kw)
        else:
            self.mamba = mamba2.Mamba(cfg, **kw)
        if cfg.layer_is_moe(layer):
            self.moe = moe_mod.MoE(cfg, **kw)
        elif dense_ff(cfg, layer) > 0:
            self.mlp = MLP(d, dense_ff(cfg, layer), cfg.mlp, **kw)
        if hasattr(self, "moe") or hasattr(self, "mlp"):
            self.ln2 = norm()
        if cfg.post_norm:
            self.ln1_post, self.ln2_post = norm(), norm()

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cache: Optional[dict], impl: Optional[str], tp=None
                ) -> Tuple[torch.Tensor, Optional[dict], Optional[torch.Tensor]]:
        """(x, the layer's new cache, the MoE aux loss or None); ``tp``: the
        model's ``TensorParallel`` (attention or Mamba, then the MoE or the
        MLP, on this rank's part)."""
        cfg = self.cfg
        aux = None
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        if hasattr(self, "attn"):
            y, new_cache = attn.attention_apply(self.attn, h, cfg, layer=self.layer,
                                                positions=positions, cache=cache,
                                                impl=impl, tp=tp)
        else:
            y, new_cache = mamba2.mamba_apply(self.mamba, h, cfg, cache=cache, tp=tp)
        if cfg.post_norm:
            y = rms_norm(y, self.ln1_post, cfg.norm_eps)
        x = x + y
        if hasattr(self, "ln2"):
            h2 = rms_norm(x, self.ln2, cfg.norm_eps)
            if hasattr(self, "moe"):
                y2, aux = moe_mod.moe_apply(self.moe, h2, cfg, tp=tp)
            else:
                y2 = self.mlp(h2, tp)
            if cfg.post_norm:
                y2 = rms_norm(y2, self.ln2_post, cfg.norm_eps)
            x = x + y2
        return x, new_cache, aux


class LM(nn.Module):
    """Embedding → blocks → final norm → (soft-capped) logits.

    ``trainable=False`` (serving): frozen bf16 weights. ``trainable=True``:
    f32 weights and norms with ``requires_grad``, as the reference trains.

    ``tp``: None on one device; a model sliced over a mesh's "model"
    dimension (``tensor_parallel.shard_model``) holds its
    ``TensorParallel`` there, and its forward then takes ``plan=``.
    """

    tp = None

    def __init__(self, cfg: ModelConfig, *, device=None, trainable: bool = False):
        super().__init__()
        check_supported(cfg)
        if cfg.family == "encdec-audio":
            raise ValueError(f"{cfg.name}: an encoder-decoder is built by "
                             f"models.encdec.EncDec, not LM")
        self.cfg = cfg
        kw = dict(device=device, requires_grad=trainable,
                  dtype=torch.float32 if trainable else COMPUTE_DTYPE)
        self.embed = Embed(cfg, **kw)
        self.layers = nn.ModuleList(Block(cfg, l, **kw)
                                    for l in range(cfg.n_layers))
        self.ln_f = nn.Parameter(torch.zeros(cfg.d_model, dtype=torch.float32,
                                             device=device), requires_grad=trainable)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "LM":
        """Random weights drawn from ``generator`` (f32 normals scaled as
        the reference's init, stored in the weights' dtype; routed experts
        at their own fan-in, see below); norms and biases are set to 0 (and
        Mamba's ``D`` to 1, ``dt_bias`` to -2, as the reference), so a
        trained model is reset to the draw."""
        dense_init_(self.embed.table, generator, scale=1.0)
        self.ln_f.zero_()
        if not self.cfg.tie_embeddings:
            dense_init_(self.embed.unembed, generator)
        for blk in self.layers:
            for name in ("ln1", "ln2", "ln1_post", "ln2_post"):
                if hasattr(blk, name):
                    getattr(blk, name).zero_()
            if hasattr(blk, "attn"):
                a = blk.attn
                for w in (a.wq, a.wk, a.wv, a.wo):
                    dense_init_(w, generator)
                for name in ("bq", "bk", "bv"):
                    if hasattr(a, name):
                        getattr(a, name).zero_()
            else:
                mb = blk.mamba
                for w in (mb.wz, mb.wx, mb.wB, mb.wC, mb.wdt):
                    dense_init_(w, generator)
                dense_init_(mb.conv_w, generator, scale=0.5)
                dense_init_(mb.out, generator)
                mb.conv_b.zero_()
                mb.A_log.zero_()      # A = -exp(A_log) = -1
                mb.D.fill_(1.0)
                mb.dt_bias.fill_(-2.0)  # softplus(-2) ~ 0.13
                mb.norm.zero_()
            mlps = [blk.mlp] if hasattr(blk, "mlp") else []
            if hasattr(blk, "moe"):
                dense_init_(blk.moe.router, generator)
                # each expert at its own fan-in, d_in of (E, d_in, d_out): the
                # reference's _dense_init takes shape[0], the expert count,
                # which makes a deep random MoE amplify last-bit differences
                # (ROADMAP.md, Queue 3)
                for w in (blk.moe.gate, blk.moe.up, blk.moe.down):
                    dense_init_(w, generator, scale=w.shape[1] ** -0.5)
                if hasattr(blk.moe, "shared"):
                    mlps.append(blk.moe.shared)
            for mlp in mlps:
                for name in ("gate", "up", "down"):
                    if hasattr(mlp, name):
                        dense_init_(getattr(mlp, name), generator)
        return self

    def forward(
        self,
        tokens: torch.Tensor,                 # (b, s) integer ids
        *,
        prefix_embeds: Optional[torch.Tensor] = None,  # (b, s_pre, d) VLM stub
        caches: Optional[dict] = None,
        start_pos: Optional[int] = None,      # decode offset
        impl: Optional[str] = None,
        last_only: bool = False,
        remat: str = "none",
        with_aux: bool = False,
        plan: Optional[ShardingPlan] = None,
    ):
        """(logits (b, s or 1, padded_vocab) f32, caches), and with
        ``with_aux`` the sum of the MoE layers' aux losses () f32 after
        them, as the reference's ``lm_apply``. ``last_only`` unembeds only
        the last position (prefill: the reference keeps ``logits[:, -1:]``
        of the full set, the same numbers). ``prefix_embeds`` (the VLM's
        patch embeddings) stand before the embedded tokens, in bf16, and
        the positions run over both; the logits cover both.

        ``remat`` as the reference's ``lm_apply`` (training, no caches):
        "none" keeps every activation; "block" recomputes each prefix
        layer and each group of ``period`` stacked layers in the backward
        pass (the reference's ``jax.checkpoint`` of a layer and of its
        scanned group); "dots" recomputes the same groups but keeps the
        outputs of matrix products without batch dimensions (``x @ w``:
        ``aten.mm``), the counterpart of
        ``dots_with_no_batch_dims_saveable``. The values do not depend on
        ``remat``. Training takes ``impl`` "ref", the reference's "xla"
        route: the kernels have no backward pass.

        A model sharded over "model" (``self.tp``) needs ``plan`` (the
        reference's ``make_plan`` of its cell: ``plan.kv`` runs the
        attention context-parallel) and gives this rank's vocabulary
        columns of the logits, ``plan.logits``; one device reads no plan.
        """
        if remat not in REMATS:
            raise ValueError(f"remat must be one of {REMATS}, got {remat!r}")
        if remat != "none" and caches is not None:
            raise ValueError("remat is for training, which passes no caches")
        cfg = self.cfg
        tp = self.tp.bind(plan) if self.tp is not None else None
        x = self.embed.embed(tokens, tp).to(COMPUTE_DTYPE)
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(x.device, COMPUTE_DTYPE), x], dim=1)
        b, s, _ = x.shape
        offset = 0 if start_pos is None else int(start_pos)
        positions = (offset + torch.arange(s, device=x.device)).expand(b, s)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        new_caches = None
        if remat == "none":
            layer_caches: List[Optional[dict]] = (
                caches["layers"] if caches is not None else [None] * cfg.n_layers)
            new_layers = []
            for blk, c in zip(self.layers, layer_caches, strict=True):
                x, nc, aux = blk(x, positions, c, impl, tp)
                if aux is not None:
                    aux_total = aux_total + aux
                new_layers.append(nc)
            if caches is not None:
                new_caches = {**caches, "layers": new_layers}
        else:
            def group(h: torch.Tensor, ids: range):
                a = torch.zeros((), dtype=torch.float32, device=h.device)
                for l in ids:
                    h, _, aux = self.layers[l](h, positions, None, impl, tp)
                    if aux is not None:
                        a = a + aux
                return h, a

            ctx = _dots_context if remat == "dots" else ckpt.noop_context_fn
            for ids in layer_groups(cfg):
                x, aux = ckpt.checkpoint(functools.partial(group, ids=ids), x,
                                         use_reentrant=False, context_fn=ctx)
                aux_total = aux_total + aux
        x = rms_norm(x, self.ln_f, cfg.norm_eps)
        if last_only:
            x = x[:, -1:]
        logits = self.embed.logits(x, tp)
        if with_aux:
            return logits, new_caches, aux_total
        return logits, new_caches


#: the rematerialisation policies of training (``ParallelConfig.remat``)
REMATS = ("none", "block", "dots")


def layer_groups(cfg: ModelConfig) -> List[range]:
    """The layers one rematerialised unit holds: each prefix layer alone,
    then each repeat of the stacked ``period``-layer group."""
    n_prefix, period, rep = stack_plan(cfg)
    return ([range(l, l + 1) for l in range(n_prefix)]
            + [range(n_prefix + r * period, n_prefix + (r + 1) * period)
               for r in range(rep)])


def _save_mm(ctx, op, *args, **kwargs):
    if op is torch.ops.aten.mm.default:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return ckpt.create_selective_checkpoint_contexts(_save_mm)


def init_lm_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                   dtype=COMPUTE_DTYPE, device=None, tp_size: int = 1,
                   layout=None) -> dict:
    """``{"layers": [per-layer cache], "n_prefix", "period"}`` — the layer
    list (an attention layer's KV cache or a Mamba layer's state) with the
    reference's stack plan beside it. ``tp_size``: the caches of one rank
    of a model sharded over that many model ranks (its kv heads,
    ``tensor_parallel.cache_kv_heads``; its Mamba heads,
    ``tensor_parallel.mamba_heads_local``). ``layout`` (a
    ``tensor_parallel.CacheLayout``, from the cell's plan): the attention
    caches hold its kv heads and, where it splits the sequence, this rank's
    slice of the ``max_len`` slots (:func:`attention.init_cache`)."""
    from repro_torch.models.tensor_parallel import cache_kv_heads, mamba_heads_local

    n_prefix, period, _ = stack_plan(cfg)
    heads = layout.heads if layout is not None else cache_kv_heads(cfg, tp_size)
    seq = layout.seq if layout is not None else None
    ssm_split = tp_size if mamba_heads_local(cfg, tp_size) else 1
    return {
        "layers": [attn.init_cache(cfg, batch, max_len, dtype=dtype, device=device,
                                   kv_heads=heads, seq=seq)
                   if cfg.layer_kind(l) == "attn"
                   else mamba2.init_mamba_cache(cfg, batch, dtype=dtype,
                                                device=device, tp_size=ssm_split)
                   for l in range(cfg.n_layers)],
        "n_prefix": n_prefix,
        "period": period,
    }


def cache_start_pos(caches: dict) -> int:
    """Current decode position: the first attention cache's ``pos`` (0
    without one: a Mamba layer reads no position)."""
    for c in caches["layers"]:
        if c is not None and "pos" in c:
            return int(c["pos"])
    return 0
