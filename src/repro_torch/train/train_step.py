"""Train step factory — the port of ``repro.train.train_step``: the
weighted CE loss, microbatch gradient accumulation, the remat policies and
the AdamW update.

The loss takes per-example weights: that is where instance selection
enters training. Prototype examples carry their cluster mass
(``data/instance_selection.py``), so training on the reduced corpus
optimises an unbiased estimate of the full-corpus loss.

The step mutates the model and the optimizer state in place and returns
them with its metrics, which stay 0-d device tensors until the caller
reads them. The reference trains with ``impl="xla"``; the port's
counterpart is ``impl="ref"`` (plain attention under autograd), and the
hand-written kernels, which have no backward pass, refuse tensors that
require grad.

On a mesh of data ranks (``mesh=``, else the runtime's ``mesh``; one
process a rank, the dimensions ``pod`` and ``data``) a step is the one-device
step at ``microbatches = P`` spread over the P ranks: rank r takes rows r
of the global batch (``launch.mesh.batch_specs``, pod-major), the f32
gradients are summed across the ranks in rank order and divided by the
count (:meth:`~repro_torch.core._collectives.Axis.sum_scatter`, in buckets
of the optimizer's ``SLICE``; never a float ``all_reduce``, whose ring order
is not fixed), the grad norm is taken from the whole reduced gradient,
AdamW updates this rank's ZeRO-1 shard (``parallel.zero_stage``) and the
weights are gathered in rank order. With one microbatch a rank the losses,
grad norms and weights are those of the one-device step at ``microbatches
= P``, bit for bit; with m a rank, the gradient sums each rank's m first.

On a mesh with a "model" dimension (``("data", "model")``, ``("pod",
"data", "model")``) the model is sharded over it
(``models.tensor_parallel.shard_model``) and the step takes the cell's
``plan`` (``launch.mesh.make_plan``): the forward and backward run
tensor-parallel, the loss is the vocabulary-parallel cross-entropy, the
data-axis reduction and ZeRO-1 act on each rank's model slice, and the
grad norm adds the squares of model-sharded leaves over the model ranks
in rank order (replicated leaves once). Every model rank then holds the
same bits of every replicated leaf; the step is within rounding of the
one-device step (the row-parallel sums add in another order), not bitwise.
The MoE runs expert parallel, Mamba by heads and the enc-dec as the
dense family there; a plan with ``heads_mode="seq"`` (``plan.kv``) runs
the attention context-parallel.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ParallelConfig, ShapeConfig
from repro_torch.models.registry import ModelBundle
from repro_torch.models.tensor_parallel import entry_names
from repro_torch.runtime import active
from repro_torch.train.optimizer import (
    DATA_AXES,
    SLICE,
    OptConfig,
    adamw_update,
    gather_shards,
    local_shard,
    mesh_coords,
    restrict,
    zero_opt_specs,
)


def cross_entropy(
    logits: torch.Tensor,                    # (b, s, v) f32
    labels: torch.Tensor,                    # (b, s) int, -1 = masked
    weights: Optional[torch.Tensor] = None,  # (b,) example weights (IHTC masses)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (mean weighted token loss, total weight). The gold logit is
    taken with ``gather``, which adds no rounding (the reference's masked
    sum adds zeros to it)."""
    mask = (labels >= 0).to(torch.float32)
    lab = torch.where(labels >= 0, labels, 0).to(torch.int64)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lab[..., None])[..., 0]
    tok_loss = (logz - gold) * mask
    if weights is not None:
        w = weights.to(torch.float32)[:, None]
        tok_loss = tok_loss * w
        mask = mask * w
    tot = torch.clamp_min(torch.sum(mask), 1e-6)
    return torch.sum(tok_loss) / tot, tot


def make_loss_fn(bundle: ModelBundle, impl: str, remat: str, plan=None) -> Callable:
    """The step's loss: the cross-entropy (vocabulary-parallel for a model
    sharded over "model", which takes ``plan``) plus the MoE aux loss."""
    cfg = bundle.cfg

    def loss_fn(model, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        logits, aux = bundle.forward(model, batch, impl=impl, remat=remat, plan=plan)
        tp = getattr(model, "tp", None)
        ce = cross_entropy if tp is None else tp.cross_entropy
        loss, tot = ce(logits, batch["labels"], batch.get("weights"))
        total = loss + cfg.router_aux_coef * aux
        return total, {"loss": loss, "aux_loss": aux, "weight": tot}

    return loss_fn


def _split(batch: dict, n: int, i: int) -> dict:
    return {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))[i]
            for k, v in batch.items()}


def make_train_step(
    bundle: ModelBundle,
    opt_cfg: OptConfig,
    parallel: ParallelConfig = ParallelConfig(),
    impl: str = "ref",
    *,
    mesh=None,
    plan=None,
) -> Callable:
    """Builds ``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``.

    Microbatching: the batch is split on axis 0 into
    ``parallel.microbatches`` slices, each taken through forward and
    backward in order; the gradients accumulate in the parameters' f32
    ``.grad`` and are divided by the count, as the reference's scan
    accumulates from zero. The ``.grad`` of each parameter holds the step's
    gradient until the next step starts.

    ``mesh`` (default: the runtime's ``mesh``) makes it the data-parallel
    step of the module docstring; its ``opt_state`` comes from
    ``init_opt_state(model, mesh=, specs=mesh_opt_specs(...))``. ``plan``:
    the cell's ``make_plan``, which a model sharded over "model" needs.
    """
    loss_fn = make_loss_fn(bundle, impl, parallel.remat, plan)
    n_micro = max(parallel.microbatches, 1)
    mesh = active().mesh if mesh is None else mesh
    if mesh is not None:
        return _data_parallel_step(loss_fn, bundle.cfg, opt_cfg, parallel, mesh)

    def train_step(model, opt_state, batch):
        named = _trainable(model)
        totals, stack = _forward_backward(model, named, loss_fn, batch, n_micro)
        if n_micro == 1:
            loss, mets = totals[0], stack[0]
        else:
            with torch.no_grad():
                for p in named.values():
                    p.grad.div_(n_micro)
            loss = torch.mean(torch.stack(totals))
            mets = {k: torch.mean(torch.stack([m[k] for m in stack]))
                    for k in stack[0]}
        return _update(model, named, opt_state, opt_cfg, loss, mets)

    return train_step


def _trainable(model) -> Dict[str, torch.Tensor]:
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def _forward_backward(model, named: Dict[str, torch.Tensor], loss_fn: Callable,
                      batch: dict, n_micro: int) -> Tuple[List[torch.Tensor], List[dict]]:
    """Forward and backward over ``n_micro`` slices of ``batch`` in order,
    the gradients summed from zero in the parameters' ``.grad``: (each
    slice's total loss, each slice's metrics)."""
    for p in named.values():
        p.grad = None
    totals, stack = [], []
    for i in range(n_micro):
        l, m = loss_fn(model, _split(batch, n_micro, i) if n_micro > 1 else batch)
        l.backward()
        totals.append(l.detach())
        stack.append({k: v.detach() for k, v in m.items()})
    return totals, stack


def _update(model, named: Dict[str, torch.Tensor], opt_state: dict, opt_cfg: OptConfig,
            loss: torch.Tensor, mets: dict, local: Optional[Callable] = None,
            gnorm: Optional[torch.Tensor] = None):
    """AdamW on the step's gradients (``local``: on this rank's shards;
    ``gnorm``: the grad norm, where the model is sharded);
    (model, opt_state, metrics)."""
    model, opt_state, opt_mets = adamw_update(
        {n: p.grad for n, p in named.items()}, opt_state, model, opt_cfg, local=local,
        gnorm=gnorm)
    return model, opt_state, dict(mets, **opt_mets, total_loss=loss)


def mesh_opt_specs(params, mesh, *, zero_stage: int = 1, master: bool = False,
                   param_specs: Optional[dict] = None) -> dict:
    """The ZeRO specs of a model's optimizer state on a mesh: each moment
    takes its parameter's spec (``param_specs``; default: a sharded
    model's own, ``model.tp.specs``, else replicated) with the data axes
    folded in by :func:`~repro_torch.train.optimizer.zero_opt_specs`
    (``zero_stage=0``: the parameter's spec). The specs are of the whole
    tensors, whose shapes are the rank's parameters' times the model ranks
    along their model-sharded dimension."""
    from repro_torch.launch.mesh import data_axes

    if param_specs is None and isinstance(params, torch.nn.Module):
        tp = getattr(params, "tp", None)
        param_specs = tp.specs if tp is not None else None
    named = ({n: p for n, p in params.named_parameters() if p.requires_grad}
             if isinstance(params, torch.nn.Module) else dict(params))
    shape = {a: c[1] for a, c in mesh_coords(mesh).items()}
    pspecs = {n: tuple((param_specs or {}).get(n, ())) for n in named}

    def whole(n: str) -> tuple:
        dims = list(named[n].shape)
        for d, e in enumerate(pspecs[n]):
            for a in entry_names(e):
                if a not in DATA_AXES:
                    dims[d] *= shape[a]
        return tuple(dims)

    return zero_opt_specs(pspecs, {n: whole(n) for n in named}, data_axes(mesh),
                          shape, zero_stage=zero_stage, master=master)


def _local_rows(batch: dict, cfg, axis) -> Tuple[dict, bool]:
    """This rank's rows of the global batch by ``batch_specs`` (every key
    by the tokens' rows), and whether the rows are split (a batch the data
    ranks do not divide is taken whole on every rank)."""
    from repro_torch.launch.mesh import batch_specs

    b, s = batch["tokens"].shape[:2]
    spec = batch_specs(cfg, ShapeConfig("step", s, b, "train"), axis.mesh,
                       kind="train")["tokens"]
    if spec[0] is None:
        return batch, False
    per = b // axis.size
    return {k: v[axis.index * per:(axis.index + 1) * per] for k, v in batch.items()}, True


def _buckets(tensors: List[torch.Tensor]):
    """Flat pieces of ``tensors`` in order, packed into buckets of one dtype
    and at most SLICE elements (a tensor larger than that is split)."""
    bucket, size = [], 0
    for t in tensors:
        for piece in t.view(-1).split(SLICE):
            if bucket and (size + piece.numel() > SLICE
                           or piece.dtype != bucket[0].dtype):
                yield bucket
                bucket, size = [], 0
            bucket.append(piece)
            size += piece.numel()
    if bucket:
        yield bucket


@torch.no_grad()
def _reduce_grads(grads: List[torch.Tensor], axis, count: int) -> None:
    """Each gradient, in place, replaced by the rank-order sum of every
    rank's over ``count``: bucket by bucket, each rank sums its chunk of
    the bucket (``sum_scatter``), divides it, and the chunks are gathered."""
    for bucket in _buckets(grads):
        flat = bucket[0] if len(bucket) == 1 else torch.cat(bucket)
        pad = (-flat.numel()) % axis.size
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        chunk = axis.sum_scatter(flat)
        chunk.div_(count)
        full = axis.gather_rows(chunk)
        at = 0
        for piece in bucket:
            piece.copy_(full[at:at + piece.numel()])
            at += piece.numel()


def _data_parallel_step(loss_fn: Callable, cfg, opt_cfg: OptConfig,
                        parallel: ParallelConfig, mesh) -> Callable:
    from repro_torch.launch.mesh import data_axis

    axis = data_axis(mesh)
    coords = mesh_coords(mesh)
    n_micro = max(parallel.microbatches, 1)
    names = tuple(mesh.mesh_dim_names or ())
    tp_size = coords["model"][1] if "model" in names else 1

    def train_step(model, opt_state, batch):
        tp = getattr(model, "tp", None)
        if (tp.size if tp is not None else 1) != tp_size:
            raise ValueError(
                f"the mesh has {tp_size} model ranks and the model is sharded over "
                f"{tp.size if tp is not None else 1}: shard it with "
                f"models.tensor_parallel.shard_model(model, mesh)")
        named = _trainable(model)
        specs = {n: restrict(s, DATA_AXES) for n, s in mesh_opt_specs(
            named, mesh, zero_stage=parallel.zero_stage, master="master" in opt_state,
            param_specs=tp.specs if tp is not None else None)["m"].items()}
        for n, p in named.items():
            want = tuple(local_shard(p, specs[n], coords).shape)
            if tuple(opt_state["m"][n].shape) != want:
                raise ValueError(
                    f"{n}: the optimizer state holds {tuple(opt_state['m'][n].shape)}, "
                    f"zero_stage {parallel.zero_stage} on this mesh gives {want}; "
                    f"make it with init_opt_state(model, mesh=, specs=mesh_opt_specs())")
        local, split = _local_rows(batch, cfg, axis)
        totals, stack = _forward_backward(model, named, loss_fn, local, n_micro)
        grads = [p.grad for p in named.values()]
        if split:
            _reduce_grads(grads, axis, axis.size * n_micro)
        elif n_micro > 1:
            with torch.no_grad():
                for g in grads:
                    g.div_(n_micro)
        keys = list(stack[0])
        vals = torch.stack([torch.stack([t] + [m[k] for k in keys])
                            for t, m in zip(totals, stack, strict=True)])
        if split:
            vals = axis.gather_rows(vals)
        cols = vals.t().contiguous()  # (1 + len(keys), ranks x microbatches)
        loss = torch.mean(cols[0])  # the mean of one value is that value
        mets = {k: torch.mean(cols[j + 1]) for j, k in enumerate(keys)}
        model, opt_state, mets = _update(
            model, named, opt_state, opt_cfg, loss, mets,
            local=lambda n, t: local_shard(t, specs[n], coords),
            gnorm=None if tp is None else tp.grad_norm(
                {n: p.grad for n, p in named.items()}))
        for n, p in named.items():
            gather_shards(p.data, specs[n], axis)
        return model, opt_state, mets

    return train_step


def make_eval_step(bundle: ModelBundle, impl: str = "ref", *, plan=None) -> Callable:
    loss_fn = make_loss_fn(bundle, impl, "none", plan)

    @torch.no_grad()
    def eval_step(model, batch):
        _, mets = loss_fn(model, batch)
        return mets

    return eval_step
