"""AdamW with a cosine schedule and global-norm clipping — the port of
``repro.train.optimizer`` (single device; the reference's ZeRO-1 specs,
``zero_opt_specs`` and ``_zero_spec_for``, wait for the mesh: ROADMAP.md,
Queue 1, item 7b).

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
from typing import Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn

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


def init_opt_state(params: Params, *, master: bool = False) -> dict:
    """Zero moments and step. ``master=True`` is mixed precision: the
    parameters are stored in a low precision and the state carries their
    f32 master copy, which the update applies to."""
    named = _named(params)
    dev = next(iter(named.values())).device if named else None
    out = {
        "m": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for n, p in named.items()},
        "v": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for n, p in named.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }
    if master:
        out["master"] = {n: p.detach().to(torch.float32).clone()
                         for n, p in named.items()}
    return out


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], opt_state: dict,
                 params: Params, cfg: OptConfig
                 ) -> Tuple[Params, dict, Dict[str, torch.Tensor]]:
    """One AdamW step, in place. Returns (params, opt_state, metrics
    {"grad_norm", "lr"}). With an f32 ``master`` copy in the state the
    update applies to it and the parameters are cast from it."""
    named = _named(params)
    model_cfg = getattr(params, "cfg", None)
    step = opt_state["step"] + 1
    gnorm = global_norm(dict(grads), cfg=model_cfg)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-12), 1.0)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    master: Optional[dict] = opt_state.get("master")
    for name, p in named.items():
        tensors = [grads[name], opt_state["m"][name], opt_state["v"][name], p]
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
