"""Mamba-2 SSD block — the port of ``repro.models.mamba2``: the chunked
prefill and the O(1) recurrent decode step.

Chunked SSD (arXiv:2405.21060 §6): the sequence is cut into chunks of
Q = 128 tokens; within a chunk the output is a masked quadratic form,
across chunks a short recurrence over the chunk states (b, h, p, n). The
per-token state does not grow with the sequence.

The reference writes its contractions as three-operand einsums and lets
the compiler order them. Here each is spelled out in the order that never
materialises a (b, c, h, q, k, p) tensor (about 34 GB at jamba's prefill):
the decay-weighted Gram matrix ``G ⊙ L`` (b, c, h, q, k) first, then its
product with x. Everything inside ``ssd_chunked`` is f32 (TF32 off on the
card); the projections run in the compute dtype, as in the reference.

jamba uses Mamba-1; the reference substitutes this SSD block with jamba's
dimensions (state 16), and so does the port.

On a model axis (``tp``, ``models.tensor_parallel``) a rank runs its share
of the SSD heads where the ranks divide them
(``TensorParallel.mamba_operands``), else the whole block replicated.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ref import no_tf32
from repro_torch.models.layers import COMPUTE_DTYPE, rms_norm, weight

CHUNK = 128


def dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, SSD heads, head dim p, state n)."""
    d_in = cfg.ssm_expand * cfg.d_model
    return d_in, d_in // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state


def mamba_specs(cfg: ModelConfig, tp: Optional[str] = "model", tp_size: int = 1) -> dict:
    """The reference's ``mamba_specs``: the z/x projections by columns and
    the out projection by rows where the model ranks divide ``d_inner``,
    the per-head leaves where they divide the heads; B, C, the conv and
    the norm whole."""
    d_in, h, _, _ = dims(cfg)
    ts = max(tp_size, 1)
    col = (None, tp) if d_in % ts == 0 else (None, None)
    head = (tp,) if h % ts == 0 else (None,)
    return {
        "wz": col, "wx": col,
        "wB": (None, None), "wC": (None, None),
        "wdt": (None, tp) if h % ts == 0 else (None, None),
        "conv_w": (None, None), "conv_b": (None,),
        "A_log": head, "D": head, "dt_bias": head,
        "norm": (None,),
        "out": (tp, None) if d_in % ts == 0 else (None, None),
    }


class Mamba(nn.Module):
    """The block's weights in the reference's layout: the input
    projections ``wz``, ``wx`` (d, d_in), ``wB``, ``wC`` (d, n), ``wdt``
    (d, h); the depthwise conv ``conv_w`` (k, d_in + 2n) and ``conv_b``;
    ``out`` (d_in, d) — all cast to the compute dtype at use. ``A_log``,
    ``D``, ``dt_bias`` (h,) and the gate norm ``norm`` (d_in,) stay f32, as
    the reference applies them."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=COMPUTE_DTYPE,
                 requires_grad: bool = False):
        super().__init__()
        d = cfg.d_model
        d_in, h, _, n = dims(cfg)
        kw = dict(device=device, dtype=dtype, requires_grad=requires_grad)
        f32 = dict(device=device, dtype=torch.float32, requires_grad=requires_grad)
        self.wz = weight((d, d_in), **kw)
        self.wx = weight((d, d_in), **kw)
        self.wB = weight((d, n), **kw)
        self.wC = weight((d, n), **kw)
        self.wdt = weight((d, h), **kw)
        self.conv_w = weight((cfg.ssm_conv, d_in + 2 * n), **kw)
        self.conv_b = weight((d_in + 2 * n,), **kw)
        self.A_log = weight((h,), **f32)
        self.D = weight((h,), **f32)
        self.dt_bias = weight((h,), **f32)
        self.norm = weight((d_in,), **f32)
        self.out = weight((d_in, d), **kw)


def segsum_exp(a: torch.Tensor) -> torch.Tensor:
    """exp of the pairwise within-chunk decay sums. a: (..., q, h) per-step
    log decay → (..., h, q, q) lower-triangular L[i, j] = exp(Σ_{j<k≤i} a_k).

    The upper triangle is masked before the exp, not after it as in the
    reference (``repro.models.mamba2._segsum_exp``): there the sums are
    positive, and past ~88.7 within a chunk exp overflows, and the masked
    backward multiplies 0 by inf, giving NaN gradients (seen on the card
    training mamba2-370m; ROADMAP.md, Queue 3). The forward bits are the
    same, exp(-inf) being the zero the reference puts there."""
    q = a.shape[-2]
    cs = torch.cumsum(a, dim=-2).transpose(-1, -2)        # (..., h, q)
    diff = cs[..., :, None] - cs[..., None, :]            # (..., h, q, q)
    iq = torch.arange(q, device=a.device)
    mask = iq[:, None] >= iq[None, :]
    return torch.exp(torch.where(mask, diff, float("-inf")))


def ssd_chunked(
    x_dt: torch.Tensor,    # (b, l, h, p) inputs pre-multiplied by dt
    a_log: torch.Tensor,   # (b, l, h) per-step log decay (dt · A, negative)
    B: torch.Tensor,       # (b, l, n)
    C: torch.Tensor,       # (b, l, n)
    init_state: Optional[torch.Tensor] = None,  # (b, h, p, n)
    chunk: int = CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (b, l, h, p), final state (b, h, p, n)), f32. A ragged tail is
    padded with zeros (zero input, zero log decay) and cut from y."""
    b, l, h, p = x_dt.shape
    n = B.shape[-1]
    q = min(chunk, l)
    pad = (-l) % q
    if pad:
        x_dt = nn.functional.pad(x_dt, (0, 0, 0, 0, 0, pad))
        a_log = nn.functional.pad(a_log, (0, 0, 0, pad))
        B = nn.functional.pad(B, (0, 0, 0, pad))
        C = nn.functional.pad(C, (0, 0, 0, pad))
    nc = (l + pad) // q
    xc = x_dt.reshape(b, nc, q, h, p).float()
    no_tf32(xc)
    ac = a_log.reshape(b, nc, q, h).float()
    Bc = B.reshape(b, nc, q, n).float()
    Cc = C.reshape(b, nc, q, n).float()

    # 1. within each chunk: y[q] = Σ_k (C_q·B_k) L[h, q, k] x[k]
    G = Cc @ Bc.transpose(-1, -2)                         # (b, c, q, k)
    M = G[:, :, None] * segsum_exp(ac)                    # (b, c, h, q, k)
    xh = xc.permute(0, 1, 3, 2, 4)                        # (b, c, h, k, p)
    y_diag = (M @ xh).permute(0, 1, 3, 2, 4)              # (b, c, q, h, p)
    del G, M

    # 2. each chunk's output state: Σ_q B_q ⊗ (decay to the chunk end · x_q)
    a_cum = torch.cumsum(ac, dim=2)                       # (b, c, q, h)
    decay_out = torch.exp(a_cum[:, :, -1:, :] - a_cum)    # (b, c, q, h)
    xd = (decay_out[..., None] * xc).permute(0, 1, 3, 4, 2)  # (b, c, h, p, q)
    states = xd @ Bc[:, :, None]                          # (b, c, h, p, n)
    del xd

    # 3. the recurrence over chunks; prev[c] is the state before chunk c
    chunk_decay = torch.exp(a_cum[:, :, -1, :])           # (b, c, h)
    s = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x_dt.device)
         if init_state is None else init_state.float())
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_t = torch.stack(prev, dim=1)                     # (b, c, h, p, n)

    # 4. the carried-in state's contribution: (C_q · prev) · decay from
    # the chunk start
    y_off = (Cc @ prev_t.reshape(b, nc, h * p, n).transpose(-1, -2)).reshape(
        b, nc, q, h, p) * torch.exp(a_cum)[..., None]
    y = (y_diag + y_off).reshape(b, nc * q, h, p)[:, :l]
    return y, s


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                cache: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d. x: (batch, l, c); w: (k, c). Returns (out
    (batch, l, c), new cache (batch, k − 1, c)). The k products are summed
    in order, then b is added, each step in x's dtype (the reference's
    Python ``sum``)."""
    k, l = w.shape[0], x.shape[1]
    if cache is None:
        cache = torch.zeros((x.shape[0], k - 1, x.shape[-1]), dtype=x.dtype,
                            device=x.device)
    xin = torch.cat([cache, x], dim=1)                   # (batch, l + k − 1, c)
    out = xin[:, 0:l] * w[0]
    for i in range(1, k):
        out = out + xin[:, i:i + l] * w[i]
    return out + b, xin[:, -(k - 1):]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``F.softplus`` turns
    linear above 20 instead)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def mamba_apply(p: Mamba, u: torch.Tensor, cfg: ModelConfig, *,
                cache: Optional[dict] = None, tp=None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """The whole block on u (b, s, d). ``cache = {"ssm": (b, h, p, n) f32,
    "conv": (b, k − 1, d_in + 2n)}``: with s = 1 the recurrent step, else
    the chunked scan from the cached state. Returns (out, new cache or
    None). ``tp`` (a sharded model's ``TensorParallel``): this rank's heads
    and d_inner columns (the cache holds them: ``init_mamba_cache``'s
    ``tp_size``), the output summed over the model ranks; or, where the
    heads do not divide the ranks, the block replicated."""
    b, s, _ = u.shape
    dt_ = u.dtype
    d_in, h, hp, n = dims(cfg)
    part = None
    if tp is None:
        w = {k: getattr(p, k) for k in mamba_specs(cfg)}
    else:
        w, part = tp.mamba_operands(p)
    if part is None:
        def cols(name):
            return u @ w[name].to(dt_)
    else:  # this rank's columns (see TensorParallel.mamba_operands)
        d_in = part[1]
        h = d_in // hp
        uc = tp.copy(u.float())  # one sum of the three projections' gradients

        def cols(name):
            return (uc @ w[name].to(dt_).float()).to(dt_)

    z = cols("wz")
    x = cols("wx")
    Br = u @ w["wB"].to(dt_)  # B, C and their conv: whole on every rank
    Cr = u @ w["wC"].to(dt_)
    dt_raw = cols("wdt")

    xbc = torch.cat([x, Br, Cr], dim=-1)
    xbc, new_conv = causal_conv(xbc, w["conv_w"].to(dt_), w["conv_b"].to(dt_),
                                cache["conv"] if cache is not None else None)
    xbc = nn.functional.silu(xbc.float()).to(dt_)
    x, Br, Cr = torch.split(xbc, [d_in, n, n], dim=-1)
    Bf, Cf = Br.float(), Cr.float()  # the scan's operands
    if part is not None:  # into this rank's heads: their gradients summed in f32
        Bf, Cf = torch.split(tp.copy(torch.cat([Bf, Cf], dim=-1)), [n, n], dim=-1)

    dt = softplus(dt_raw.float() + w["dt_bias"].float())  # (b, s, h)
    A = -torch.exp(w["A_log"].float())
    xh = x.reshape(b, s, h, hp)
    x_dt = xh.float() * dt[..., None]
    a_log = dt * A

    new_cache = None
    if cache is not None and s == 1:  # the recurrent decode step
        st = cache["ssm"].float()                         # (b, h, p, n)
        dec = torch.exp(a_log[:, 0, :])
        outer = x_dt[:, 0, :, :, None] * Bf[:, 0][:, None, None, :]
        st = st * dec[..., None, None] + outer
        y = torch.einsum("bn,bhpn->bhp", Cf[:, 0], st)[:, None]
        new_cache = {"ssm": st, "conv": new_conv}
    else:
        init = cache["ssm"] if cache is not None else None
        y, final = ssd_chunked(x_dt, a_log, Bf, Cf, init_state=init)
        if cache is not None:
            new_cache = {"ssm": final, "conv": new_conv}

    y = y + w["D"].float()[None, None, :, None] * xh.float()
    y = y.reshape(b, s, d_in).to(dt_)
    gated = y * nn.functional.silu(z.float()).to(dt_)
    if part is None:
        gated = rms_norm(gated, w["norm"], cfg.norm_eps)
        return gated @ w["out"].to(dt_), new_cache
    gated = tp.rms_norm(gated, w["norm"], cfg.norm_eps, dims(cfg)[0])
    # the row-parallel partials add in f32 and round once, as one device's
    # product rounds once (bf16 partials would round every rank's share)
    out = gated.float() @ w["out"].to(dt_).float()
    return tp.reduce(out).to(dt_), new_cache


def init_mamba_cache(cfg: ModelConfig, batch: int, *, dtype=COMPUTE_DTYPE,
                     device=None, tp_size: int = 1) -> dict:
    """Zero state: ``ssm`` in f32, ``conv`` in the compute dtype.
    ``tp_size``: the ranks the heads are split over (1: the whole state);
    one rank's state holds its heads of ``ssm`` and its x channels then
    all of B and C of ``conv`` (``tensor_parallel.mamba_heads_local``
    decides where the split is taken)."""
    d_in, h, hp, n = dims(cfg)
    d_in, h = d_in // tp_size, h // tp_size
    return {"ssm": torch.zeros((batch, h, hp, n), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, d_in + 2 * n), dtype=dtype,
                                device=device)}
