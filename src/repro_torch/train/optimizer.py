"""AdamW with a cosine schedule, global-norm clipping and ZeRO-1 — the port
of ``repro.train.optimizer``.

ZeRO-1 over the data ranks: :func:`zero_opt_specs` gives each moment the
parameter's spec with the data axes folded into its first dimension that
they divide (the reference's rule, on the port's per-layer tensor shapes),
:func:`init_opt_state` with ``mesh=`` allocates only this rank's shard of
``m``, ``v`` (and ``master``), and :func:`adamw_update` with ``local=``
updates only that shard. The update is elementwise, so a shard's bits are
the whole update's; the train step gathers the updated weights
(:func:`gather_shards`), a checkpoint the whole moments
(:func:`gather_whole`). On a mesh with a model axis the specs are the
whole tensors' (the reference's, with "model" in them); a rank's
parameter is already its model slice, so the ZeRO shard of it is taken
under :func:`restrict`'s data part of the spec (a merged ``("model",
"data")`` entry included), and :func:`local_shard` of a whole tensor
(a checkpoint's) slices every sharded dimension.

The state is a dict of tensors on the parameters' device: f32 moments
``m`` and ``v`` keyed by parameter name, an int32 ``step``, and with
``master=True`` an f32 copy of the parameters. The update is written as
the reference writes it, ``base − lr·(m̂/(√v̂ + eps) + wd·base)``, one
parameter at a time (no whole-model temporaries), a large parameter in
slices of ``SLICE`` elements (the arithmetic is elementwise, so the bits
do not depend on the slicing; jamba's 3.8 GB f32 expert tensors would
otherwise take about 15 GB of temporaries), and the parameters are
updated in place. ``torch.optim.AdamW`` is not used: its decoupled decay
and bias correction round differently. The schedule, clip scale and bias
corrections stay 0-d device tensors, so a step never waits on the host.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from repro_torch.models.tensor_parallel import entry_names
from repro_torch.utils.tree import global_norm


#: elements of one slice of a parameter's update (256 MB in f32)
SLICE = 1 << 26


@dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warm-up to ``peak_lr``, then a cosine to ``min_lr`` at
    ``decay_steps`` (f32, the reference's operation order)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    frac = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr + 0.5 * (cfg.peak_lr - cfg.min_lr) * (1 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cos)


Params = Union[nn.Module, Mapping[str, torch.Tensor]]


def _named(params: Params) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return {n: p for n, p in params.named_parameters() if p.requires_grad}
    return dict(params)


def init_opt_state(params: Params, *, master: bool = False, mesh=None,
                   specs: Optional[dict] = None) -> dict:
    """Zero moments and step. ``master=True`` is mixed precision: the
    parameters are stored in a low precision and the state carries their
    f32 master copy, which the update applies to.

    With ``mesh`` and ``specs`` (:func:`zero_opt_specs`' output) each of
    ``m``, ``v`` and ``master`` holds only this rank's shard of the
    parameter, its slice along the dimension its spec gives the data axes
    (of the rank's parameter: on a model axis, its model slice); a leaf
    that nothing divides stays whole on every rank."""
    named = _named(params)
    dev = next(iter(named.values())).device if named else None
    if (mesh is None) != (specs is None):
        raise ValueError("init_opt_state: pass mesh and specs together")
    coords = mesh_coords(mesh) if mesh is not None else {}

    def local(key: str, n: str, t: torch.Tensor) -> torch.Tensor:
        if specs is None:
            return t
        return local_shard(t, restrict(specs[key][n], DATA_AXES), coords)

    out = {
        "m": {n: torch.zeros(local("m", n, p).shape, dtype=torch.float32,
                             device=p.device)
              for n, p in named.items()},
        "v": {n: torch.zeros(local("v", n, p).shape, dtype=torch.float32,
                             device=p.device)
              for n, p in named.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }
    if master:
        out["master"] = {n: local("master", n, p.detach()).to(torch.float32).clone(
                             memory_format=torch.contiguous_format)
                         for n, p in named.items()}
    return out


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], opt_state: dict,
                 params: Params, cfg: OptConfig, *,
                 local: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None,
                 gnorm: Optional[torch.Tensor] = None
                 ) -> Tuple[Params, dict, Dict[str, torch.Tensor]]:
    """One AdamW step, in place. Returns (params, opt_state, metrics
    {"grad_norm", "lr"}). With an f32 ``master`` copy in the state the
    update applies to it and the parameters are cast from it.

    ``local(name, tensor)`` (ZeRO-1) maps a parameter or its gradient to
    the view of this rank's shard, the one the state's moments hold: the
    update then writes that shard of each parameter only. The grad norm is
    taken from the whole ``grads`` all the same, unless ``gnorm`` gives it
    (a model sharded over "model": ``TensorParallel.grad_norm``)."""
    named = _named(params)
    model_cfg = getattr(params, "cfg", None)
    step = opt_state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(dict(grads), cfg=model_cfg)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-12), 1.0)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    master: Optional[dict] = opt_state.get("master")
    for name, p in named.items():
        g = grads[name]
        if local is not None:
            g, p = local(name, g), local(name, p)
        tensors = [g, opt_state["m"][name], opt_state["v"][name], p]
        if master is not None:
            tensors.append(master[name])
        for g, m, v, p_s, *master_s in zip(*_slices(tensors), strict=True):
            g = g.to(torch.float32) * scale
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * torch.square(g))
            base = master_s[0] if master_s else p_s.to(torch.float32)
            delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * base
            new = base - lr * delta
            if master_s:
                master_s[0].copy_(new)
            p_s.copy_(new)
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}


def _slices(tensors):
    """Each tensor as a list of views of at most SLICE elements, in the
    same places (one whole-tensor piece each where one is not contiguous)."""
    if all(t.is_contiguous() for t in tensors):
        return [t.view(-1).split(SLICE) for t in tensors]
    return [[t] for t in tensors]


# ------------------------------------------------------------- ZeRO-1 specs
#: A spec is a tuple with one entry per leading dimension: None, a mesh
#: dimension's name, or a tuple of names (the reference's PartitionSpec);
#: missing trailing entries are None.
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]


def _entry_size(entry, mesh_shape: Mapping[str, int]) -> int:
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    return int(np.prod([mesh_shape[a] for a in names]))


def _zero_spec_for(spec: Spec, shape: Sequence[int], data_axes: Tuple[str, ...],
                   mesh_shape: Mapping[str, int]) -> Spec:
    """Fold the data axes into the first unsharded dimension they divide,
    or merge them into a model-sharded one whose local extent they divide;
    else the spec as it is (the leaf is replicated over the data ranks)."""
    dp = int(np.prod([mesh_shape[a] for a in data_axes])) if data_axes else 1
    if dp <= 1 or not len(shape):
        return spec
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, (dim, cur) in enumerate(zip(shape, parts, strict=True)):
        if cur is None and dim % dp == 0:
            parts[i] = data_axes if len(data_axes) > 1 else data_axes[0]
            return tuple(parts)
        if cur is not None and dim % (_entry_size(cur, mesh_shape) * dp) == 0:
            merged = (cur,) if isinstance(cur, str) else tuple(cur)
            parts[i] = merged + tuple(data_axes)
            return tuple(parts)
    return spec


def zero_opt_specs(param_specs: Mapping[str, Spec], params_shapes: Mapping[str, object],
                   data_axes: Tuple[str, ...], mesh_shape: Mapping[str, int],
                   zero_stage: int = 1, master: bool = False) -> dict:
    """Specs of :func:`init_opt_state`'s ``{"m", "v"[, "master"], "step"}``
    for parameters keyed by name (``params_shapes``: shapes, or tensors).
    ``zero_stage=0`` keeps the parameter specs (replicated state)."""
    if zero_stage == 0:
        mspec = dict(param_specs)
    else:
        mspec = {n: _zero_spec_for(s, tuple(getattr(params_shapes[n], "shape",
                                                     params_shapes[n])),
                                   data_axes, mesh_shape)
                 for n, s in param_specs.items()}
    out = {"m": mspec, "v": mspec, "step": ()}
    if master:
        out["master"] = mspec
    return out


def mesh_coords(mesh) -> Dict[str, Tuple[int, int]]:
    """{dimension name: (this rank's index, size)} of a ``DeviceMesh``."""
    names = tuple(mesh.mesh_dim_names or ())
    return {a: (int(mesh.get_local_rank(a)), int(mesh.size(i)))
            for i, a in enumerate(names)}


#: the data axes of a mesh; a rank's parameter is already sliced over the
#: others ("model", by ``models.tensor_parallel.shard_params``)
DATA_AXES = ("pod", "data")


def restrict(spec: Spec, axes: Sequence[str]) -> Spec:
    """``spec`` with only the mesh dimensions in ``axes`` kept in each
    entry. ``restrict(spec, DATA_AXES)`` is the spec of a rank's parameter
    (its model slice) under a whole-tensor spec: a merged ``("model",
    "data")`` entry becomes "data", row-major (model-major) as the merge
    lays out the whole dimension."""
    out = []
    for e in spec:
        kept = tuple(a for a in entry_names(e) if a in axes)
        out.append(None if not kept else kept[0] if len(kept) == 1 else kept)
    return tuple(out)


def shard_dim(spec: Spec) -> Optional[int]:
    """The dimension a spec shards (None: the leaf is whole on every rank);
    a spec of more than one sharded dimension raises (see
    :func:`restrict`)."""
    dims = [i for i, e in enumerate(spec) if e is not None]
    if len(dims) > 1:
        raise ValueError(f"spec {spec}: more than one sharded dimension")
    return dims[0] if dims else None


def _index(entry, coords: Mapping[str, Tuple[int, int]]) -> Tuple[int, int]:
    names = entry_names(entry)
    idx = tuple(coords[a][0] for a in names)
    sizes = tuple(coords[a][1] for a in names)
    return int(np.ravel_multi_index(idx, sizes)), int(np.prod(sizes))


def shard_index(spec: Spec, coords: Mapping[str, Tuple[int, int]]) -> Tuple[int, int]:
    """(this rank's shard, number of shards) of a leaf with spec ``spec``:
    the row-major index over the entry's dimensions (pod-major)."""
    d = shard_dim(spec)
    return (0, 1) if d is None else _index(spec[d], coords)


def local_shard(t, spec: Spec, coords: Mapping[str, Tuple[int, int]]):
    """This rank's piece of ``t`` under ``spec`` (a view, of a tensor or an
    array; the whole of ``t`` where the spec shards nothing): every sharded
    dimension sliced by its entry's row-major index."""
    for d, e in enumerate(spec):
        if e is None:
            continue
        r, n = _index(e, coords)
        per = t.shape[d] // n
        if isinstance(t, torch.Tensor):
            t = t.narrow(d, r * per, per)
        else:
            t = t[(slice(None),) * d + (slice(r * per, (r + 1) * per),)]
    return t


@torch.no_grad()
def gather_shards(t: torch.Tensor, spec: Spec, axis) -> None:
    """Fill the whole of ``t`` from every rank's shard under ``spec`` (this
    rank's is in place), gathered over ``axis`` in rank order in pieces of
    at most SLICE elements."""
    d = shard_dim(spec)
    if d is None:
        return
    me, n = shard_index(spec, mesh_coords(axis.mesh))
    if (me, n) != (axis.index, axis.size):
        raise ValueError(f"spec {spec} shards over {n} ranks, the axis has {axis.size}")
    pre = math.prod(t.shape[:d])
    rest = math.prod(t.shape[d + 1:]) * (t.shape[d] // n)
    v = t.view(pre, n, rest)
    cap = max(1, SLICE // n)
    if pre == 1:
        for a in range(0, rest, cap):
            b = min(rest, a + cap)
            full = axis.gather_rows(v[0, me, a:b].contiguous())
            v[0, :, a:b].copy_(full.view(n, b - a))
    else:
        g = max(1, cap // rest)
        for a in range(0, pre, g):
            b = min(pre, a + g)
            full = axis.gather_rows(v[a:b, me].contiguous())
            v[a:b].copy_(full.view(n, b - a, rest).transpose(0, 1))


def gather_whole(t: torch.Tensor, spec: Spec, axis) -> torch.Tensor:
    """The whole of a tensor that ``spec`` shards, on every rank: each rank's
    ``t`` in its place along the sharded dimension, gathered over ``axis`` in
    rank order (:func:`gather_shards`); ``t`` itself where the spec shards
    nothing."""
    d = None if spec is None else shard_dim(spec)
    if d is None:
        return t
    shape = list(t.shape)
    shape[d] *= axis.size
    whole = t.new_empty(shape)
    local_shard(whole, spec, mesh_coords(axis.mesh)).copy_(t)
    gather_shards(whole, spec, axis)
    return whole
