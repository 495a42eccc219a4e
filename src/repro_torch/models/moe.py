"""Mixture-of-Experts layer — the port of ``repro.models.moe``: top-k
routing, sort-based capacity dispatch, grouped expert products.

Token slots (a token's k chosen experts) are ranked within their expert's
queue by one stable sort, scattered into a static (G, E, C, d) buffer
(slots past an expert's capacity C are dropped), the experts run as
grouped matrix products ``(E, G·C, d) × (E, d, f)``, and the results
gather back to token order weighted by the renormalised router
probabilities. deepseek-style shared experts are one dense swiglu MLP of
width ``n_shared · d_ff`` added to every token.

The arithmetic follows the reference step by step: the router product
and softmax in f32 (TF32 off on the card), top-k ties toward the lowest
expert index, integer slot ranks (bitwise), the expert products in the
compute dtype, the weighted combine in f32 cast back at the end.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ref import no_tf32
from repro_torch.models.layers import COMPUTE_DTYPE, MLP, mlp_specs, weight


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of the last axis, largest first, ties toward
    the lowest index (``jax.lax.top_k``'s order; ``torch.topk`` gives no
    order among equal values): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def dispatch_indices(expert_ids: torch.Tensor, n_experts: int, capacity: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slot ranks within each expert queue, per group (one stable sort).

    expert_ids: (G, T·k) integer ids. Returns ``(flat, ok)``, both (G, T·k):
    ``flat = id·C + rank`` for a kept slot and ``E·C`` (the sink row) for an
    invalid id (outside [0, E)) or a slot past the expert's capacity.
    """
    tk = expert_ids.shape[-1]
    ids = expert_ids.long()
    sorted_e, order = torch.sort(ids, dim=-1, stable=True)
    experts = torch.arange(n_experts, device=ids.device).expand(
        ids.shape[:-1] + (n_experts,)).contiguous()
    first = torch.searchsorted(sorted_e.contiguous(), experts, right=False)
    rank_sorted = (torch.arange(tk, device=ids.device)
                   - torch.gather(first, -1, sorted_e.clamp(0, n_experts - 1)))
    rank = torch.empty_like(rank_sorted).scatter_(-1, order, rank_sorted)
    ok = (ids >= 0) & (ids < n_experts) & (rank < capacity)
    flat = torch.where(ok, ids * capacity + rank,
                       torch.full_like(ids, n_experts * capacity))
    return flat, ok


def token_slots(xt: torch.Tensor, k: int) -> torch.Tensor:
    """(T, d) tokens → (T·k, d) slot rows, token i's k slots contiguous.

    A broadcast, not an indexed gather: its backward sums each token's k
    slot gradients over k in a fixed order (in f32, rounded once), where a
    gather's (``index_put_`` with accumulate) adds them with atomics on the
    card, in a new order every run, so a top-6 router's training would not
    repeat bit for bit."""
    t, d = xt.shape
    return xt.reshape(t, 1, d).expand(t, k, d).reshape(t * k, d)


def capacity_of(cfg: ModelConfig, tokens: int, capacity_factor: Optional[float] = None
                ) -> Tuple[int, int]:
    """(groups, capacity) of a call over ``tokens`` tokens: the reference's
    ``max(int(k·Tg·cf / E), min(Tg·k, 8))`` with Tg tokens a group (the
    floor keeps decode steps free of drops)."""
    cf = cfg.moe_capacity_factor if capacity_factor is None else capacity_factor
    e, k = cfg.n_experts, cfg.n_experts_per_tok
    ng = cfg.moe_groups if cfg.moe_groups > 0 else 1
    if tokens % ng != 0:
        ng = 1
    tg = tokens // ng
    return ng, max(int(k * tg * cf / e), min(tg * k, 8))


def moe_specs(cfg: ModelConfig, tp: Optional[str] = "model", tp_size: int = 1) -> dict:
    """The reference's ``moe_specs``: the experts over ``tp`` where the
    model ranks divide their count (expert parallel), the router whole, the
    shared MLP as a dense one (``shared.<name>``)."""
    ep = (tp, None, None) if cfg.n_experts % max(tp_size, 1) == 0 else (None, None, None)
    p = {"router": (None, None), "gate": ep, "up": ep, "down": ep}
    if cfg.n_shared_experts:
        p.update({f"shared.{k}": v for k, v in mlp_specs("swiglu", tp).items()})
    return p


class MoE(nn.Module):
    """Router (d, E) in f32, experts ``gate``/``up`` (E, d, f) and ``down``
    (E, f, d), the shared swiglu MLP (``shared``) when the config has
    shared experts."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=COMPUTE_DTYPE,
                 requires_grad: bool = False):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        kw = dict(device=device, dtype=dtype, requires_grad=requires_grad)
        # the reference routes in f32: the router is never cast
        self.router = weight((d, e), device=device, dtype=torch.float32,
                             requires_grad=requires_grad)
        self.gate = weight((e, d, f), **kw)
        self.up = weight((e, d, f), **kw)
        self.down = weight((e, f, d), **kw)
        if cfg.n_shared_experts:
            self.shared = MLP(d, cfg.n_shared_experts * f, "swiglu", **kw)


def moe_apply(p: MoE, x: torch.Tensor, cfg: ModelConfig, *,
              capacity_factor: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(output (b, s, d) in x's dtype, aux load-balancing loss () f32)."""
    b, s, d = x.shape
    dt = x.dtype
    e, k = cfg.n_experts, cfg.n_experts_per_tok
    t = b * s
    xt = x.reshape(t, d)

    # route, in f32
    xf = xt.float()
    no_tf32(xf)
    probs = torch.softmax(xf @ p.router.float(), dim=-1)        # (T, E)
    topv, topi = top_k(probs, k)                                # (T, k)
    topv = topv / torch.clamp_min(topv.sum(dim=-1, keepdim=True), 1e-9)

    # aux loss (Switch): E · Σ_e fraction of slots_e · mean prob_e
    counts = torch.bincount(topi.reshape(-1), minlength=e).float()
    aux = e * torch.sum(counts / (t * k) * probs.mean(dim=0))

    # dispatch to (G, E, C, d)
    ng, capacity = capacity_of(cfg, t, capacity_factor)
    tg = t // ng
    flat, ok = dispatch_indices(topi.reshape(ng, tg * k), e, capacity)
    rows = e * capacity + 1                                     # + the sink row
    src = token_slots(xt, k)
    gidx = (flat + rows * torch.arange(ng, device=x.device)[:, None]).reshape(-1)
    buf = torch.zeros((ng * rows, d), dtype=dt, device=x.device)
    buf.index_copy_(0, gidx, src)  # dropped slots all land on the sink rows
    buf = buf.reshape(ng, rows, d)[:, :e * capacity].reshape(ng, e, capacity, d)

    # the experts: grouped products over the expert axis
    xe = buf.permute(1, 0, 2, 3).reshape(e, ng * capacity, d)
    g = torch.bmm(xe, p.gate.to(dt))
    u = torch.bmm(xe, p.up.to(dt))
    h = nn.functional.silu(g) * u
    out_buf = torch.bmm(h, p.down.to(dt))                       # (E, G·C, d)
    out_flat = out_buf.reshape(e, ng, capacity, d).permute(1, 0, 2, 3).reshape(
        ng * e * capacity, d)

    # combine back to token order, weighted in f32
    pick = (torch.clamp_max(flat, e * capacity - 1)
            + e * capacity * torch.arange(ng, device=x.device)[:, None])
    slot_out = out_flat.index_select(0, pick.reshape(-1))
    slot_out = torch.where(ok.reshape(-1, 1), slot_out,
                           torch.zeros((), dtype=dt, device=x.device))
    weighted = slot_out.float() * topv.reshape(-1)[:, None]
    out = weighted.reshape(t, k, d).sum(dim=1).to(dt)
    if cfg.n_shared_experts:
        out = out + p.shared(xt)
    return out.reshape(b, s, d), aux.float()
