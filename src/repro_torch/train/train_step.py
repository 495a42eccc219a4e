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
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ParallelConfig
from repro_torch.models.registry import ModelBundle
from repro_torch.train.optimizer import OptConfig, adamw_update


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


def make_loss_fn(bundle: ModelBundle, impl: str, remat: str) -> Callable:
    cfg = bundle.cfg

    def loss_fn(model, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        logits, aux = bundle.forward(model, batch, impl=impl, remat=remat)
        loss, tot = cross_entropy(logits, batch["labels"], batch.get("weights"))
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
) -> Callable:
    """Builds ``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``.

    Microbatching: the batch is split on axis 0 into
    ``parallel.microbatches`` slices, each taken through forward and
    backward in order; the gradients accumulate in the parameters' f32
    ``.grad`` and are divided by the count, as the reference's scan
    accumulates from zero. The ``.grad`` of each parameter holds the step's
    gradient until the next step starts.
    """
    loss_fn = make_loss_fn(bundle, impl, parallel.remat)
    n_micro = max(parallel.microbatches, 1)

    def train_step(model, opt_state, batch):
        params = [p for p in model.parameters() if p.requires_grad]
        for p in params:
            p.grad = None
        if n_micro == 1:
            loss, mets = loss_fn(model, batch)
            loss.backward()
            loss = loss.detach()
            mets = {k: v.detach() for k, v in mets.items()}
        else:
            losses, stack = [], []
            for i in range(n_micro):
                l, m = loss_fn(model, _split(batch, n_micro, i))
                l.backward()
                losses.append(l.detach())
                stack.append({k: v.detach() for k, v in m.items()})
            with torch.no_grad():
                for p in params:
                    p.grad.div_(n_micro)
            loss = torch.mean(torch.stack(losses))
            mets = {k: torch.mean(torch.stack([m[k] for m in stack]))
                    for k in stack[0]}
        grads = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
        model, opt_state, opt_mets = adamw_update(grads, opt_state, model, opt_cfg)
        mets = dict(mets, **opt_mets, total_loss=loss)
        return model, opt_state, mets

    return train_step


def make_eval_step(bundle: ModelBundle, impl: str = "ref") -> Callable:
    loss_fn = make_loss_fn(bundle, impl, "none")

    @torch.no_grad()
    def eval_step(model, batch):
        _, mets = loss_fn(model, batch)
        return mets

    return eval_step
