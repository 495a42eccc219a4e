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
(b, hkv, S) f32][, "seq", "slots"]}``. ``pos`` is a host integer (the
reference keeps a device scalar and a host mirror of it); the new k/v are
written into the cache tensors in place (the reference returns new
arrays), and the returned dict carries the advanced ``pos``. A cache split
along the sequence over a model axis (``"seq"``: the ranks' collective
axis, ``"slots"``: the logical slot count) holds this rank's S slots,
from ``seq.index · S``.

On a model axis (``tp``): heads-parallel projections, context-parallel
self-attention under ``heads_mode="seq"``, and the decode of a
sequence-split cache through K5's lse entry and a rank-order merge
(:func:`attention_apply`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import merge_lse
from repro_torch.kernels.ref import no_tf32
from repro_torch.models import tensor_parallel
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

    ``tp`` (a sharded model's ``TensorParallel``, bound to the cell's plan):
    this rank's heads, as ``models/tensor_parallel.py`` lays them out; the
    output is then summed over the model ranks (or computed whole, where
    the heads do not divide them). Under context parallelism (``tp.
    context_parallel``; self-attention, train and prefill) this rank's rows
    of the sequence (:func:`_context_parallel`). A cache split along the
    sequence (its ``"seq"`` axis, ``tensor_parallel.cache_layout``) holds
    this rank's slots: a rank writes the new k/v where it owns their slots,
    and a decode step merges the ranks' attention (:func:`_seq_decode`).
    """
    if (tp is not None and tp.context_parallel and cross_kv is None
            and x.shape[1] > 1):
        return _context_parallel(p, x, cfg, layer=layer, positions=positions,
                                 cache=cache, causal=causal, impl=impl, tp=tp)
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

    q = tensor_parallel.column_mm(xq, w["wq"], dt)
    if cfg.qkv_bias:
        q = q + w["bq"].to(dt)
    q = q.reshape(b, s, hq, hd)
    if cross_kv is None:
        k = tensor_parallel.column_mm(xkv, w["wk"], dt)
        v = tensor_parallel.column_mm(xkv, w["wv"], dt)
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
    scale = _scale(cfg)
    if cache is not None:
        pos = int(cache["pos"])
        new_cache = _write(cache, k, v, pos)
        if s == 1:  # decode: the whole buffer under a position mask
            kv_bias = _decode_bias(cache, pos, window, b)
            k, v = cache["k"], cache["v"]
            causal = False  # the position mask subsumes causality and window
            window = 0
            if "seq" in cache:  # this rank's slots: the ranks' attention merged
                out = _seq_decode(q, k.to(dt), v.to(dt), kv_bias, cache["seq"], cfg,
                                  scale=scale, impl=impl, tp=tp if partial else None)
                return _out_proj(out, w["wo"], dt, tp if partial else None), new_cache
    if kv_range is not None:  # the kv heads this rank's query heads use
        lo, hi = kv_range
        k, v = k[:, lo:hi], v[:, lo:hi]
        if kv_bias is not None:
            kv_bias = kv_bias[:, lo:hi]

    out = attend(q, k.to(dt), v.to(dt), causal=causal, window=window,
                 kv_bias=kv_bias, softcap=cfg.attn_logit_softcap, scale=scale,
                 impl=impl, chunk=cfg.attn_chunk)
    return _out_proj(out, w["wo"], dt, tp if partial else None), new_cache


def _out_proj(out: torch.Tensor, wo: torch.Tensor, dt: torch.dtype, tp) -> torch.Tensor:
    """The heads' output (b, h, s, hd) through ``wo``: row-parallel and
    summed over the ranks with ``tp`` (``TensorParallel.row_reduce``)."""
    b, h, s, hd = out.shape
    out = out.transpose(1, 2).reshape(b, s, h * hd)
    return out @ wo.to(dt) if tp is None else tp.row_reduce(out, wo, dt)


def _scale(cfg: ModelConfig) -> float:
    if cfg.name.startswith("gemma2"):
        return 1.0 / (256.0 ** 0.5)  # query_pre_attn_scalar
    return 1.0 / (cfg.head_dim ** 0.5)


def _write(cache: dict, k: torch.Tensor, v: torch.Tensor, pos: int) -> dict:
    """The new k/v (b, h, s, hd) written to slots [pos, pos + s) of the
    cache, in place, where this rank holds them (a cache split along the
    sequence holds slots [index·S, (index + 1)·S) of its ``"seq"`` axis);
    the cache with ``pos`` advanced."""
    ck, cv = cache["k"], cache["v"]
    n = ck.shape[2]
    first = cache["seq"].index * n if "seq" in cache else 0
    if pos + k.shape[2] > cache.get("slots", n):
        raise ValueError(f"the cache holds {cache.get('slots', n)} slots; the new k/v "
                         f"go to [{pos}, {pos + k.shape[2]})")
    a, e = max(pos, first), min(pos + k.shape[2], first + n)
    if e > a:
        ck[:, :, a - first:e - first] = k[:, :, a - pos:e - pos].to(ck.dtype)
        cv[:, :, a - first:e - first] = v[:, :, a - pos:e - pos].to(cv.dtype)
    return dict(cache, pos=pos + k.shape[2])


def _decode_bias(cache: dict, pos: int, window: int, b: int) -> torch.Tensor:
    """The decode step's (b, hkv, S) f32 bias over this rank's slots: the
    position mask (slots past ``pos``, and outside the window) plus a
    compressed cache's log-mass bias."""
    ck = cache["k"]
    n = ck.shape[2]
    first = cache["seq"].index * n if "seq" in cache else 0
    kpos = first + torch.arange(n, device=ck.device)
    ok = kpos <= pos
    if window > 0:
        ok = ok & (kpos > pos - window)
    pm = torch.where(ok, 0.0, _MASKED).to(torch.float32)
    kv_bias = pm.expand(b, ck.shape[1], n)
    if "bias" in cache:
        kv_bias = kv_bias + cache["bias"]
    return kv_bias


def _seq_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                kv_bias: torch.Tensor, seq, cfg: ModelConfig, *, scale: float,
                impl: Optional[str], tp) -> torch.Tensor:
    """One decode step's attention over a cache split along the sequence
    over ``seq``'s ranks: every query head the cache's kv heads serve
    (``tp``, where this rank's query heads are its share but the cache
    holds every kv head: q gathered along heads, an exact copy), attended
    over this rank's slots by K5's lse entry (its plain version for a CPU
    tensor or ``impl="ref"``), the ranks' (o, lse) gathered (an exact copy)
    and merged in rank order (``flash_attention.merge_lse``); returns this
    rank's query heads of the result, (b, hq, 1, hd) in q's dtype."""
    b, hq, s, hd = q.shape
    gathered = tp is not None and not tp.kv_local
    if gathered:  # the cache holds every kv head: every query head attends
        q = tensor_parallel.gather_dim(q, tp.axis, 1)
    o, lse = ops.flash_attention_lse(q, k, v, kv_bias=kv_bias, causal=False, scale=scale,
                                     logit_softcap=cfg.attn_logit_softcap, impl=impl)
    h = q.shape[1]
    flat = torch.cat([o.reshape(b * h * s, hd), lse.reshape(b * h * s, 1)], dim=1)
    every = seq.gather_rows(flat[None].contiguous())  # (ranks, b·h·s, hd + 1)
    out = merge_lse(every[..., :hd], every[..., hd])
    tensor_parallel.CALLS["seq_merge"] += 1
    out = out.view(b, h, s, hd).to(q.dtype)
    if gathered:
        out = out[:, tp.index * hq:(tp.index + 1) * hq]
    return out


def _context_parallel(p: Attention, x: torch.Tensor, cfg: ModelConfig, *, layer: int,
                      positions: torch.Tensor, cache: Optional[dict], causal: bool,
                      impl: Optional[str], tp) -> Tuple[torch.Tensor, Optional[dict]]:
    """Context-parallel self-attention (``tensor_parallel``'s module
    docstring): this rank's rows [lo, hi) of the sequence attend, with
    every head, over the keys up to hi (all of them without ``causal``);
    k and v are whole on every rank (a prefill writes them to the cache),
    the output rows are gathered along the sequence."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    tensor_parallel.CALLS["context_parallel"] += 1
    lay = tp.context_operands(p, x)
    xq, w, lo, hi = lay["xq"], lay["w"], lay["lo"], lay["hi"]
    n = hi - lo
    q = xq @ w["wq"].to(dt)
    k = x @ w["wk"].to(dt)
    v = x @ w["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + w["bq"].to(dt)
        k = k + w["bk"].to(dt)
        v = v + w["bv"].to(dt)
    q = rope(q.reshape(b, n, hq, hd), positions[:, lo:hi], cfg.rope_theta)
    k = rope(k.reshape(b, s, hkv, hd), positions, cfg.rope_theta)
    v = v.reshape(b, s, hkv, hd)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (b, h, rows, hd)
    new_cache = None
    if cache is not None:
        new_cache = _write(cache, k, v, int(cache["pos"]))
    if k.requires_grad:  # the chunks' partial k/v gradients add in one rank sum
        k, v = tp.copy_many(k, v)
    window = cfg.local_window if cfg.attn_type(layer) == "local" else 0
    end = hi if causal else s
    if n:
        out = attend(q, k[:, :, :end].to(dt), v[:, :, :end].to(dt), causal=causal,
                     window=window, softcap=cfg.attn_logit_softcap, scale=_scale(cfg),
                     impl=impl, chunk=cfg.attn_chunk)
    else:  # an empty chunk (the ranks do not divide s): no row attends, but k
        # and v stay in the graph, so this rank's backward joins their sums
        out = q + 0 * (k.sum() + v.sum()).to(dt)
    out = out.transpose(1, 2).reshape(b, n, hq * hd) @ w["wo"].to(dt)
    return tensor_parallel.seq_gather(out, tp.axis, s, lay["c"]), new_cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               dtype=COMPUTE_DTYPE, device=None, kv_heads: int = 0, seq=None) -> dict:
    """A zero cache of ``kv_heads`` heads (0: the config's). ``seq`` (the
    collective axis a decode cache's sequence is split over,
    ``tensor_parallel.cache_layout``): this rank's slice of the
    ``max_len`` slots, ``ceil(max_len / seq.size)`` of them from
    ``seq.index`` times that; the cache then carries ``"seq"`` and its
    logical ``"slots"`` (``max_len``; the last slice's slots past it are
    never written and the position mask hides them)."""
    n = max_len if seq is None else -(-max_len // seq.size)
    shape = (batch, kv_heads or cfg.n_kv_heads, n, cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device),
             "pos": 0}
    if seq is not None:
        cache.update(seq=seq, slots=max_len)
    return cache
