"""GQA attention with a KV cache, local/global windows and the IHTC
prototype bias — the port of ``repro.models.attention``.

Two routes through :func:`attend`, named as the port's dispatch names
them (``repro_torch.kernels.ops.resolve``):

  * ``"auto"`` / ``"cuda"`` (the reference's ``impl="pallas"``):
    windowless calls go to ``ops.flash_attention`` — K5 for CUDA tensors,
    its plain version for CPU tensors; windowed prefill runs
    :func:`chunked_attention`;
  * ``"ref"`` (the reference's ``impl="xla"``): always
    :func:`chunked_attention`.

Decode attends one query per head against the whole cache buffer, with
the position mask (and the window) folded into ``kv_bias`` — the slot the
compressed cache's ``log(mass)`` bias uses too, so compressed and raw
caches share one path.

A cache is ``{"k", "v": (b, hkv, S, hd), "pos": int[, "bias", "mass":
(b, hkv, S) f32]}``. ``pos`` is a host integer (the reference keeps a
device scalar and a host mirror of it); the new k/v are written into the
cache tensors in place (the reference returns new arrays), and the
returned dict carries the advanced ``pos``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import no_tf32
from repro_torch.models.layers import COMPUTE_DTYPE, rope, weight
from repro_torch.runtime import active

_MASKED = -1e30


# ------------------------------------------------------------- core attend
def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    window: int = 0,
    kv_bias: Optional[torch.Tensor] = None,
    softcap: float = 0.0,
    scale: Optional[float] = None,
    chunk: int = 1024,
) -> torch.Tensor:
    """Flash-style GQA attention in plain PyTorch: a loop over kv chunks
    with an online softmax and grouped heads (kv never repeated).

    q: (b, hq, lq, dh); k/v: (b, hkv, lk, dh); kv_bias: (b, hkv, lk).
    Logits and statistics fold in f32; the probabilities meet v in bf16
    and the chunk's PV product is rounded to bf16, as in the reference.
    Chunks wholly outside every query's window are skipped.
    """
    b, hq, lq, dh = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    g = hq // hkv
    s = (1.0 / (dh ** 0.5)) if scale is None else scale
    no_tf32(q)
    qf = (q.float() * s).reshape(b, hkv, g, lq, dh)

    ck = min(chunk, lk)
    pad = (-lk) % ck
    if pad:
        k = nn.functional.pad(k, (0, 0, 0, pad))
        v = nn.functional.pad(v, (0, 0, 0, pad))
        if kv_bias is None:
            kv_bias = torch.zeros((b, hkv, lk), dtype=torch.float32,
                                  device=q.device)
        kv_bias = nn.functional.pad(kv_bias, (0, pad), value=_MASKED)
    nc = (lk + pad) // ck
    qpos = torch.arange(lq, device=q.device) + (lk - lq)

    m = torch.full((b, hkv, g, lq), _MASKED, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, g, lq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, lq, dh), dtype=torch.float32, device=q.device)
    for j in range(nc):
        k0 = j * ck
        if causal and k0 > (lk - 1):
            continue  # chunk entirely in the future of the last query
        if window > 0 and (k0 + ck) <= (lk - lq) - window + 1:
            continue  # chunk entirely outside every query's window
        kj = k[:, :, k0:k0 + ck].float()
        vj = v[:, :, k0:k0 + ck]
        logits = torch.einsum("bhgqd,bhkd->bhgqk", qf, kj)
        if softcap > 0.0:
            logits = softcap * torch.tanh(logits / softcap)
        if kv_bias is not None:
            logits = logits + kv_bias[:, :, k0:k0 + ck].float()[:, :, None, None, :]
        kpos = k0 + torch.arange(ck, device=q.device)
        if causal:
            logits = torch.where(kpos[None, :] <= qpos[:, None], logits, _MASKED)
        if window > 0:
            logits = torch.where(kpos[None, :] > qpos[:, None] - window, logits,
                                 _MASKED)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhgqk,bhkd->bhgqd", p.to(torch.bfloat16),
                          vj.to(torch.bfloat16))
        acc = acc * alpha[..., None] + pv.float()
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(b, hq, lq, dh).to(q.dtype)


def attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    kv_bias: Optional[torch.Tensor] = None,
    softcap: float = 0.0,
    scale: Optional[float] = None,
    impl: Optional[str] = None,
    chunk: int = 1024,
) -> torch.Tensor:
    """GQA dispatcher: flash attention (K5) or the chunked plain path."""
    route = active().impl if impl is None else impl
    if route != "ref" and window == 0:
        return ops.flash_attention(q, k, v, causal=causal, scale=scale,
                                   kv_bias=kv_bias, logit_softcap=softcap,
                                   impl=impl)
    if q.shape[2] == 1:  # decode: one chunk over the whole buffer
        chunk = k.shape[2]
    return chunked_attention(q, k, v, causal=causal, window=window,
                             kv_bias=kv_bias, softcap=softcap, scale=scale,
                             chunk=chunk)


# ------------------------------------------------------------- specs
def attention_specs(cfg: ModelConfig, tp: Optional[str] = "model",
                    tp_size: int = 1) -> dict:
    """The reference's ``attention_specs``: q and the out projection over
    ``tp`` by columns and rows; k and v by columns where the model ranks
    divide ``n_kv_heads · head_dim`` (a head may then be split), else
    whole. One tuple per dimension."""
    kv_dim = cfg.n_kv_heads * cfg.head_dim
    kv = (None, tp) if kv_dim % max(tp_size, 1) == 0 else (None, None)
    p = {"wq": (None, tp), "wk": kv, "wv": kv, "wo": (tp, None)}
    if cfg.qkv_bias:
        p.update(bq=(tp,), bk=(kv[1],), bv=(kv[1],))
    return p


# ------------------------------------------------------------- module
class Attention(nn.Module):
    """QKV/O projections of one attention layer (weights (d_in, d_out))."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=COMPUTE_DTYPE,
                 requires_grad: bool = False):
        super().__init__()
        hd, hq, hkv, d = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_model
        kw = dict(device=device, dtype=dtype, requires_grad=requires_grad)
        self.wq = weight((d, hq * hd), **kw)
        self.wk = weight((d, hkv * hd), **kw)
        self.wv = weight((d, hkv * hd), **kw)
        self.wo = weight((hq * hd, d), **kw)
        if cfg.qkv_bias:
            self.bq = weight((hq * hd,), **kw)
            self.bk = weight((hkv * hd,), **kw)
            self.bv = weight((hkv * hd,), **kw)


def attention_apply(
    p: Attention,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    layer: int,
    positions: torch.Tensor,
    cache: Optional[dict] = None,
    causal: bool = True,
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    impl: Optional[str] = None,
    tp=None,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """One attention block, self or cross. x: (b, s, d) bf16.

    With a cache, the new k/v go to slots [pos, pos + s). Decode (s = 1)
    attends over the whole buffer under a position mask; prefill (s > 1)
    attends over the fresh k/v (causally unless ``causal=False``) and only
    writes the cache (it starts at pos = 0, as the serving engine does).

    ``cross_kv``: the keys and values of a cross-attention, already
    projected and heads first, (b, hkv, s_kv, hd) each (the enc-dec
    decoder's, from the encoder output; the reference passes them as
    (b, s_kv, hkv, hd)). Then only q is projected, and neither q nor k is
    rotated, as in the reference; a cross call passes no cache.

    ``tp`` (a sharded model's ``TensorParallel``): this rank's heads, as
    ``models/tensor_parallel.py`` lays them out; the output is then summed
    over the model ranks (or computed whole, where the heads do not divide
    them).
    """
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    xq = xkv = x
    w = {n: getattr(p, n) for n in ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
         if hasattr(p, n)}
    kv_range, partial = None, False
    if tp is not None:
        lay = tp.attention_operands(p, x)
        xq, xkv, w, hq, hkv = (lay[n] for n in ("xq", "xkv", "w", "hq", "hkv"))
        kv_range, partial = lay["kv_range"], lay["partial"]

    q = xq @ w["wq"].to(dt)
    if cfg.qkv_bias:
        q = q + w["bq"].to(dt)
    q = q.reshape(b, s, hq, hd)
    if cross_kv is None:
        k = xkv @ w["wk"].to(dt)
        v = xkv @ w["wv"].to(dt)
        if cfg.qkv_bias:
            k = k + w["bk"].to(dt)
            v = v + w["bv"].to(dt)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k.reshape(b, s, hkv, hd), positions, cfg.rope_theta)
        v = v.reshape(b, s, hkv, hd)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (b, h, s, hd)
    else:
        q = q.transpose(1, 2)
        k, v = cross_kv

    window = cfg.local_window if cfg.attn_type(layer) == "local" else 0
    kv_bias = None
    new_cache = None
    if cache is not None:
        pos = int(cache["pos"])
        ck, cv = cache["k"], cache["v"]
        ck[:, :, pos:pos + s] = k.to(ck.dtype)
        cv[:, :, pos:pos + s] = v.to(cv.dtype)
        new_cache = {"k": ck, "v": cv, "pos": pos + s}
        if "bias" in cache:  # IHTC-compressed cache: log-mass prototype bias
            new_cache["bias"] = cache["bias"]
            new_cache["mass"] = cache["mass"]
        if s == 1:  # decode: the whole buffer under a position mask
            S = ck.shape[2]
            kpos = torch.arange(S, device=x.device)
            ok = kpos <= pos
            if window > 0:
                ok = ok & (kpos > pos - window)
            pm = torch.where(ok, 0.0, _MASKED).to(torch.float32)
            kv_bias = pm.expand(b, ck.shape[1], S)
            if "bias" in cache:
                kv_bias = kv_bias + cache["bias"]
            k, v = ck, cv
            causal = False  # the position mask subsumes causality and window
            window = 0
    if kv_range is not None:  # the kv heads this rank's query heads use
        lo, hi = kv_range
        k, v = k[:, lo:hi], v[:, lo:hi]
        if kv_bias is not None:
            kv_bias = kv_bias[:, lo:hi]
    scale = 1.0 / (hd ** 0.5)
    if cfg.name.startswith("gemma2"):
        scale = 1.0 / (256.0 ** 0.5)  # query_pre_attn_scalar

    out = attend(q, k.to(dt), v.to(dt), causal=causal, window=window,
                 kv_bias=kv_bias, softcap=cfg.attn_logit_softcap, scale=scale,
                 impl=impl, chunk=cfg.attn_chunk)
    out = out.transpose(1, 2).reshape(b, s, hq * hd) @ w["wo"].to(dt)
    return (tp.reduce(out) if partial else out), new_cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               dtype=COMPUTE_DTYPE, device=None, kv_heads: int = 0) -> dict:
    """A zero cache of ``kv_heads`` heads (0: the config's)."""
    shape = (batch, kv_heads or cfg.n_kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": 0}
