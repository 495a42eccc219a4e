"""Carry the reference's parameters across into the port's model.

``repro``'s ``bundle.init`` returns a pytree ``{"embed": {"table"[,
"unembed"]}, "prefix": [layer dicts], "stack": [period layer dicts whose
leaves carry a leading repeat axis], "ln_f"}``. :func:`params_from_tree`
takes that tree with numpy leaves (``jax.tree_util.tree_map(np.asarray,
params)``; nothing of JAX is imported here) and fills the port's per-layer
modules: stack entry ``j`` at repeat ``r`` is layer
``n_prefix + r·period + j`` under :func:`transformer.stack_plan`. Dense
weights are stored in bf16, as the reference casts them at use; norm
weights stay f32.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.runtime import resolve_device


def _put(param: torch.Tensor, value) -> None:
    a = np.array(value, dtype=np.float32)  # a writable copy
    if tuple(a.shape) != tuple(param.shape):
        raise ValueError(f"shape {a.shape} does not match the port's "
                         f"{tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(torch.from_numpy(a).to(param.device, param.dtype))


def _load_layer(blk: transformer.Block, lp: Mapping) -> None:
    for name in ("ln1", "ln2", "ln1_post", "ln2_post"):
        if name in lp:
            _put(getattr(blk, name), lp[name])
    for name, value in lp["attn"].items():
        _put(getattr(blk.attn, name), value)
    for name, value in lp["mlp"].items():
        _put(getattr(blk.mlp, name), value)


def params_from_tree(cfg: ModelConfig, tree: Mapping, *,
                     device=None) -> transformer.LM:
    """A port ``LM`` holding the reference's parameters (numpy leaves)."""
    model = transformer.LM(cfg, device=resolve_device(device))
    n_prefix, period, rep = transformer.stack_plan(cfg)
    _put(model.embed.table, tree["embed"]["table"])
    if not cfg.tie_embeddings:
        _put(model.embed.unembed, tree["embed"]["unembed"])
    _put(model.ln_f, tree["ln_f"])
    for l in range(n_prefix):
        _load_layer(model.layers[l], tree["prefix"][l])
    for j in range(period if rep else 0):
        group = tree["stack"][j]
        for r in range(rep):
            sliced = {k: ({kk: vv[r] for kk, vv in v.items()}
                          if isinstance(v, Mapping) else v[r])
                      for k, v in group.items()}
            _load_layer(model.layers[n_prefix + r * period + j], sliced)
    return model
