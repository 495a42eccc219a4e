"""Carry the reference's parameters and optimizer state across into the
port.

``repro``'s ``bundle.init`` returns a pytree ``{"embed": {"table"[,
"unembed"]}, "prefix": [layer dicts], "stack": [period layer dicts whose
leaves carry a leading repeat axis], "ln_f"}``. :func:`params_from_tree`
takes that tree with numpy leaves (``jax.tree_util.tree_map(np.asarray,
params)``; nothing of JAX is imported here) and fills the port's per-layer
modules through ``utils.tree.param_path``: stack entry ``j`` at repeat
``r`` is layer ``n_prefix + r·period + j`` under
:func:`transformer.stack_plan`. Every family the port builds is carried
the same way: attention and Mamba blocks, MoE layers (the f32 router,
the (E, d, f) experts, the shared MLP), dense MLPs. The enc-dec tree is
``{"embed", "enc", "dec", "ln_enc", "ln_f"}`` with every layer of ``enc``
and ``dec`` stacked (``self_attn``, ``ln_x``, ``cross_attn`` in the
decoder's). Serving weights are stored in bf16, as
the reference casts them at use; ``trainable=True`` keeps them in f32
with ``requires_grad``, as the reference trains them. Norm weights stay
f32. :func:`opt_state_from_tree` carries the reference's AdamW state
(``repro.train.optimizer.init_opt_state``'s ``{"m", "v", "step"[,
"master"]}``) into the port's (``repro_torch.train.optimizer``).
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, transformer
from repro_torch.runtime import resolve_device
from repro_torch.utils.tree import param_path


def reference_value(tree: Mapping, path: str, repeat: Optional[int] = None):
    """The leaf at ``path`` ("stack/0/attn/wq") of a reference tree, sliced
    at ``repeat`` when the leaf is stacked."""
    node = tree
    for part in path.split("/"):
        node = node[int(part)] if isinstance(node, (list, tuple)) else node[part]
    return node if repeat is None else node[repeat]


def _put(param: torch.Tensor, value) -> None:
    a = np.array(value, dtype=np.float32)  # a writable copy
    if tuple(a.shape) != tuple(param.shape):
        raise ValueError(f"shape {a.shape} does not match the port's "
                         f"{tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(torch.from_numpy(a).to(param.device, param.dtype))


def params_from_tree(cfg: ModelConfig, tree: Mapping, *, device=None,
                     trainable: bool = False) -> nn.Module:
    """A port ``LM`` (``EncDec`` for the enc-dec family) holding the
    reference's parameters (numpy leaves)."""
    make = encdec.EncDec if cfg.family == "encdec-audio" else transformer.LM
    model = make(cfg, device=resolve_device(device), trainable=trainable)
    for name, param in model.named_parameters():
        _put(param, reference_value(tree, *param_path(cfg, name)))
    return model


def opt_state_from_tree(model: nn.Module, tree: Mapping) -> dict:
    """The port's optimizer state (f32 moments keyed by parameter name on
    the model's device, an int32 step) from the reference's ``{"m", "v",
    "step"[, "master"]}`` with numpy leaves."""
    cfg = model.cfg
    dev = next(model.parameters()).device

    def moments(sub: Mapping) -> dict:
        out = {}
        for name, p in model.named_parameters():
            a = np.array(reference_value(sub, *param_path(cfg, name)), np.float32)
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {a.shape}, want {tuple(p.shape)}")
            out[name] = torch.from_numpy(a).to(dev)
        return out

    state = {"m": moments(tree["m"]), "v": moments(tree["v"]),
             "step": torch.tensor(int(np.asarray(tree["step"])), dtype=torch.int32,
                                  device=dev)}
    if "master" in tree:
        state["master"] = moments(tree["master"])
    return state
