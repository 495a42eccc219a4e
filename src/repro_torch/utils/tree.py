"""Parameter trees — the port of ``repro.utils.tree``.

The reference keeps parameters as a nested dict whose repeated layer group
is stacked on a leading axis (``transformer.stack_plan``); the port keeps
an ``nn.Module`` with one module per layer. This module maps between the
two, so the checkpoint manifest and the carry-across name every leaf as
the reference does:

  * :func:`param_path` gives a port parameter's reference path
    (``embed/table``, ``ln_f``, ``prefix/0/attn/wq``, ``stack/1/mlp/up``)
    and, for a stacked leaf, its repeat index: layer
    ``n_prefix + r·period + j`` is stack entry ``j`` at repeat ``r``; an
    enc-dec model's layer ``i`` of ``enc`` or ``dec`` is repeat ``i`` of
    ``enc/...`` or ``dec/...`` (``dec/cross_attn/wq``, ``ln_enc``);
  * :func:`tree_flatten_with_paths` flattens a tree of dicts, lists,
    tensors and LM modules into ``(path, parts)`` pairs in the reference's
    leaf order (dict keys sorted, list items in order). ``parts`` lists the
    port tensors that make the leaf: one, or the ``rep`` per-layer tensors
    of a stacked leaf in repeat order (stack them to get the reference's
    array). A dict keyed by the model's parameter names (the optimizer's
    moments) is laid out as the model is.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import stack_plan

_LAYER = re.compile(r"layers\.(\d+)\.(.+)")
_ENCDEC_LAYER = re.compile(r"(enc|dec)\.(\d+)\.(.+)")
_PARAM_NAME = re.compile(
    r"embed\.(table|unembed)|ln_f|ln_enc|(layers|enc|dec)\.\d+\..+")

Leaf = Tuple[str, List[Any]]


def param_path(cfg: ModelConfig, name: str) -> Tuple[str, Optional[int]]:
    """(reference path, repeat index or None) of the port parameter ``name``."""
    m = _ENCDEC_LAYER.fullmatch(name)
    if m is not None:  # the enc-dec stacks: every layer is stacked
        return f"{m.group(1)}/{m.group(3).replace('.', '/')}", int(m.group(2))
    m = _LAYER.fullmatch(name)
    if m is None:
        return name.replace(".", "/"), None
    layer, rest = int(m.group(1)), m.group(2).replace(".", "/")
    n_prefix, period, _ = stack_plan(cfg)
    if layer < n_prefix:
        return f"prefix/{layer}/{rest}", None
    r, j = divmod(layer - n_prefix, period)
    return f"stack/{j}/{rest}", r


def _order_key(path: str) -> tuple:
    # jax flattens dicts in sorted key order and lists by index
    return tuple((0, int(c), "") if c.isdigit() else (1, 0, c)
                 for c in path.split("/"))


def param_layout(cfg: ModelConfig, names: Sequence[str]) -> List[Tuple[str, List[str]]]:
    """(reference path, port names) for every leaf the parameters ``names``
    make, in the reference's leaf order; a stacked leaf lists its
    per-layer names in repeat order."""
    groups: Dict[str, List[Tuple[int, str]]] = {}
    for name in names:
        path, r = param_path(cfg, name)
        groups.setdefault(path, []).append((-1 if r is None else r, name))
    return [(p, [n for _, n in sorted(groups[p])])
            for p in sorted(groups, key=_order_key)]


def is_model(node) -> bool:
    """Whether ``node`` is a model (an ``nn.Module`` with a model config:
    ``LM`` or ``EncDec``)."""
    return isinstance(node, torch.nn.Module) and isinstance(
        getattr(node, "cfg", None), ModelConfig)


def is_param_dict(node) -> bool:
    """Whether ``node`` is a dict keyed by LM parameter names."""
    return (isinstance(node, Mapping) and len(node) > 0
            and all(isinstance(k, str) and _PARAM_NAME.fullmatch(k) for k in node))


def find_config(tree) -> Optional[ModelConfig]:
    """The config of the first LM module in ``tree`` (None if it has none)."""
    if is_model(tree):
        return tree.cfg
    children = (tree.values() if isinstance(tree, Mapping)
                else tree if isinstance(tree, (list, tuple)) else ())
    for c in children:
        cfg = find_config(c)
        if cfg is not None:
            return cfg
    return None


def tree_flatten_with_paths(tree, *, cfg: Optional[ModelConfig] = None
                            ) -> List[Leaf]:
    """``(path, parts)`` of every leaf, in the reference's leaf order (see
    the module docstring). ``cfg`` lays out parameter-keyed dicts; by
    default, the config of the first LM module in the tree."""
    cfg = cfg if cfg is not None else find_config(tree)
    out: List[Leaf] = []
    _flatten(tree, "", cfg, out)
    return out


def join_path(prefix: str, key) -> str:
    return f"{prefix}/{key}" if prefix else str(key)


def _flatten(node, prefix: str, cfg, out: List[Leaf]) -> None:
    if node is None:  # an empty subtree, as in jax
        return
    if is_model(node):
        node = dict(node.named_parameters())
    if is_param_dict(node) and cfg is not None:
        for path, names in param_layout(cfg, list(node)):
            out.append((join_path(prefix, path), [node[n] for n in names]))
    elif isinstance(node, Mapping):
        for k in sorted(node):
            _flatten(node[k], join_path(prefix, k), cfg, out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _flatten(v, join_path(prefix, i), cfg, out)
    else:
        out.append((prefix, [node]))


def _shape(parts: List[Any]) -> Tuple[int, ...]:
    one = tuple(np.shape(parts[0]))
    return one if len(parts) == 1 else (len(parts),) + one


def tree_size(tree) -> int:
    """Total number of scalar parameters in a tree."""
    return sum(int(np.prod(_shape(parts))) for _, parts in tree_flatten_with_paths(tree))


def tree_bytes(tree) -> int:
    """Total bytes of a tree's leaves (their actual dtypes)."""
    return sum(int(p.numel()) * p.element_size()
               for _, parts in tree_flatten_with_paths(tree) for p in parts)


def global_norm(tree, *, cfg: Optional[ModelConfig] = None) -> torch.Tensor:
    """L2 norm over every leaf (in f32). Each leaf's sum of squares is added
    in the reference's leaf order; a stacked leaf sums its repeats in
    order first."""
    total = None
    for _, parts in tree_flatten_with_paths(tree, cfg=cfg):
        leaf = None
        for p in parts:
            s = torch.sum(torch.square(p.detach().float()))
            leaf = s if leaf is None else leaf + s
        total = leaf if total is None else total + leaf
    if total is None:
        return torch.zeros(())
    return torch.sqrt(total)
