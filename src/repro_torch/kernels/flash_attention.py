"""Flash-attention forward (K5) — the attention of the LM serving path.

The port of ``repro.kernels.flash_attention``: online-softmax attention
with gemma2's logit softcap, an additive per-key bias (the IHTC
``log(mass)`` correction of a compressed KV cache, and the decode
position mask) and a causal mask aligned to the end of kv. Two versions
of one function:

  * :func:`flash_attention` — the wrapper of the CUDA kernels
    ``csrc/flash_attention.cu``. It takes grouped-query heads as they are
    (kv head ``h // (hq / hkv)``), so k and v are never repeated. A call
    with few query rows per kv head (every decode step) takes the split-kv
    route, a bf16 call at head_dim 64/96/128/256 (every prefill of the LM) the
    tensor-core tiled route, the rest the tiled kernel (:func:`route`).
    For a CPU tensor it runs :func:`flash_attention_plain`.
  * :func:`flash_attention_plain` — repeats the kv heads, as the
    reference's ``ops.flash_attention`` does, and runs the dense softmax
    of :func:`repro_torch.kernels.ref.flash_attention`.

The softmax statistics. The Pallas kernel computes (o, m, l) and its
wrapper keeps o alone. :func:`flash_attention_lse` is the split-kv route
with them: (o in f32, lse = m + log l in f32), lse −inf for a row that
sees no unmasked key; :func:`flash_attention_lse_plain` is its plain
version. A model axis whose decode cache is split along the sequence
(``models/attention.py``) attends each rank's slots through it and merges
the ranks' pairs (:func:`merge_lse`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _cuda, meta, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MASKED = -1e30

#: the split-kv route takes calls with at most this many packed query rows
#: (hq / hkv · lq) per kv head; its splits hold SPLIT_MIN_KEYS keys, doubled
#: until at most SPLIT_MAX_SPLITS of them cover the keys (csrc/flash_attention.cu)
SPLIT_MAX_ROWS, SPLIT_MIN_KEYS, SPLIT_MAX_SPLITS = 8, 64, 32


#: a row's max logit at or below this saw no unmasked key: its lse is −inf
#: (``kNoKey`` of csrc/flash_attention.cu; masked logits sit near −1e30)
NO_KEY = -1e29

#: head_dims of the tensor-core tiled route (bf16 q, k and v)
MMA_HEAD_DIMS = (64, 96, 128, 256)


def route(hq: int, hkv: int, lq: int, dtype: torch.dtype = torch.float32,
          dh: int = 0) -> str:
    """Which kernel of ``csrc/flash_attention.cu`` a call takes: "split_kv"
    (the key axis split across blocks, then a combine kernel) when the
    hq / hkv query heads of a kv head times lq rows fit SPLIT_MAX_ROWS —
    every decode step; else "tiled_mma" (128 packed rows a block, bf16
    ``mma.sync`` for q·k and for p·v with p split into two bf16) for bf16
    at a head_dim of MMA_HEAD_DIMS — every prefill of the LM; else "tiled"
    (64 packed rows a block, f32 on the CUDA cores)."""
    if (hq // hkv) * lq <= SPLIT_MAX_ROWS:
        return "split_kv"
    if dtype == torch.bfloat16 and dh in MMA_HEAD_DIMS:
        return "tiled_mma"
    return "tiled"


def split_keys(lk: int) -> int:
    """Keys of one split of the split-kv route at kv length ``lk``."""
    s = SPLIT_MIN_KEYS
    while -(-lk // s) > SPLIT_MAX_SPLITS:
        s *= 2
    return s


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           kv_bias: Optional[torch.Tensor], causal: bool) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: want q (b, hq, lq, dh) and k, v "
                         f"(b, hkv, lk, dh), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, _, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or k.shape[1] < 1 or hq % k.shape[1]:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not match "
                         f"q {tuple(q.shape)} (kv heads must divide q heads)")
    if kv_bias is not None and (
            kv_bias.ndim != 3 or kv_bias.shape[0] != b
            or kv_bias.shape[1] not in (k.shape[1], hq)
            or kv_bias.shape[2] != k.shape[2]):
        raise ValueError(f"flash_attention: kv_bias has shape "
                         f"{tuple(kv_bias.shape)}, want (b, hkv or hq, lk)")
    if causal and q.shape[2] > k.shape[2]:
        # the first lq - lk rows would see no key at all
        raise ValueError(f"flash_attention: causal with more queries "
                         f"({q.shape[2]}) than keys ({k.shape[2]})")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_bias: Optional[torch.Tensor] = None,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    logit_softcap: float = 0.0,
) -> torch.Tensor:
    """Attention of q (b, hq, lq, dh) over k, v (b, hkv, lk, dh), with
    kv_bias (b, hkv or hq, lk) added to the logits. Folds in f32 and
    returns q's dtype (f32 or bf16 on the card).

    ``causal`` needs lq <= lk: a query row with no key in its past has no
    answer (the reference's dense softmax gives NaN there). A row whose
    visible keys all carry a −1e30 bias has none either: every logit it
    sees is −1e30, so each version averages v over the keys it happens to
    visit — the Pallas kernel over its padded 128-key blocks, the dense
    plain version over the visible keys, the tiled kernels over their
    32- or 64-key tiles up to the block's causal end, the split-kv kernel
    over all lk keys. The LM path forms no such row: the slot being
    decoded is always visible with a finite bias."""
    _check(q, k, v, kv_bias, causal)
    if q.is_meta:
        return meta.flash_attention(q, k, v, kv_bias, causal, route(
            q.shape[1], k.shape[1], q.shape[2], q.dtype, q.shape[3]))
    if not _cuda.on_card(q):
        return flash_attention_plain(q, k, v, kv_bias, causal=causal,
                                     scale=scale, logit_softcap=logit_softcap)
    _cuda.forbid_grad("flash_attention", q, k, v, kv_bias)
    dev = _cuda.require_cuda("flash_attention", q, k, v, kv_bias)
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: the kernel takes f32 or bf16 q, "
                        f"got {q.dtype}")
    b, hq, lq, dh = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    lib = _cuda.library("flash_attention")
    if dh > lib.repro_flash_attention_max_dh():
        raise ValueError(f"flash_attention: head_dim {dh} above the kernel's "
                         f"{lib.repro_flash_attention_max_dh()}")
    qc = q.contiguous()
    kc = k.to(q.dtype).contiguous()
    vc = v.to(q.dtype).contiguous()
    way = route(hq, hkv, lq, q.dtype, dh)
    if way == "tiled_mma":
        # its 16-byte copies need 16-byte aligned rows (a view may start
        # anywhere)
        qc, kc, vc = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (qc, kc, vc))
    bc = None if kv_bias is None else kv_bias.to(torch.float32).contiguous()
    out = torch.empty_like(qc)
    s = 1.0 / dh ** 0.5 if scale is None else float(scale)
    # the split-kv route's partials (0 bytes on the tiled route)
    nbytes = lib.repro_flash_attention_scratch_bytes(b, hq, hkv, lq, lk, dh)
    scratch = (torch.empty((nbytes,), dtype=torch.uint8, device=dev)
               if nbytes else None)
    with torch.cuda.device(dev):
        _cuda.call("flash_attention", _cuda.ptr(qc), _cuda.ptr(kc),
                   _cuda.ptr(vc), _cuda.ptr(bc), _cuda.ptr(out),
                   _DTYPES[q.dtype], b, hq, hkv, lq, lk, dh,
                   0 if bc is None else bc.shape[1], int(bool(causal)), s,
                   float(logit_softcap), _cuda.ptr(scratch), _cuda.stream(dev))
    if out.numel():
        flash_attention.launches += 1
        if way == "split_kv":
            flash_attention.launches_decode += 1
        flash_attention.route_launches[way] = flash_attention.route_launches.get(way, 0) + 1
    return out


#: every launch, those of the split-kv route (``launches_decode``), and
#: per route (``route_launches``)
flash_attention.launches = 0
flash_attention.launches_decode = 0
flash_attention.route_launches = {}


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_bias: Optional[torch.Tensor] = None,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    logit_softcap: float = 0.0,
) -> torch.Tensor:
    """The plain version: kv heads (and a per-kv-head bias) repeated to the
    query heads, then the dense f32 softmax."""
    _check(q, k, v, kv_bias, causal)
    hq, hkv = q.shape[1], k.shape[1]
    if hkv != hq:
        rep = hq // hkv
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
        if kv_bias is not None and kv_bias.shape[1] != hq:
            kv_bias = torch.repeat_interleave(kv_bias, rep, dim=1)
    return ref.flash_attention(q, k, v, causal=causal, scale=scale,
                               kv_bias=kv_bias, logit_softcap=logit_softcap)


def flash_attention_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_bias: Optional[torch.Tensor] = None,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    logit_softcap: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention` with its softmax statistics: (o (b, hq, lq,
    dh) f32, lse (b, hq, lq) f32), lse = m + log l of each row (the Pallas
    kernel's m and l), −inf where the row's largest logit is at or below
    :data:`NO_KEY` (every key it sees masked) or it has no key. The
    split-kv route takes at most SPLIT_MAX_ROWS packed rows a kv head
    (decode): with more query heads a kv head (granite's 48 over one), the
    heads of each kv head go in groups that fit, one launch a group (a
    row's result does not depend on its group). For a CPU tensor it runs
    :func:`flash_attention_lse_plain`."""
    _check(q, k, v, kv_bias, causal)
    b, hq, lq, dh = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    g = hq // hkv
    if g * lq > SPLIT_MAX_ROWS:
        if lq > SPLIT_MAX_ROWS:
            raise ValueError(f"flash_attention_lse: {lq} query rows exceed the split-kv "
                             f"route's {SPLIT_MAX_ROWS}")
        step = SPLIT_MAX_ROWS // lq
        qg = q.view(b, hkv, g, lq, dh)
        per_q = kv_bias is not None and kv_bias.shape[1] == hq and hq != hkv
        outs, lses = [], []
        for a in range(0, g, step):
            e = min(g, a + step)
            bias = kv_bias
            if per_q:
                bias = kv_bias.view(b, hkv, g, lk)[:, :, a:e].reshape(b, -1, lk)
            o, l = flash_attention_lse(qg[:, :, a:e].reshape(b, hkv * (e - a), lq, dh),
                                       k, v, bias, causal=causal, scale=scale,
                                       logit_softcap=logit_softcap)
            outs.append(o.view(b, hkv, e - a, lq, dh))
            lses.append(l.view(b, hkv, e - a, lq))
        return (torch.cat(outs, dim=2).view(b, hq, lq, dh),
                torch.cat(lses, dim=2).view(b, hq, lq))
    if q.is_meta:
        return meta.flash_attention_lse(q, k, v, kv_bias, causal)
    if not _cuda.on_card(q):
        return flash_attention_lse_plain(q, k, v, kv_bias, causal=causal, scale=scale,
                                         logit_softcap=logit_softcap)
    _cuda.forbid_grad("flash_attention_lse", q, k, v, kv_bias)
    dev = _cuda.require_cuda("flash_attention_lse", q, k, v, kv_bias)
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention_lse: the kernel takes f32 or bf16 q, "
                        f"got {q.dtype}")
    lib = _cuda.library("flash_attention")
    qc = q.contiguous()
    kc = k.to(q.dtype).contiguous()
    vc = v.to(q.dtype).contiguous()
    bc = None if kv_bias is None else kv_bias.to(torch.float32).contiguous()
    out = torch.empty(q.shape, dtype=torch.float32, device=dev)
    lse = torch.empty((b, hq, lq), dtype=torch.float32, device=dev)
    s = 1.0 / dh ** 0.5 if scale is None else float(scale)
    nbytes = lib.repro_flash_attention_scratch_bytes(b, hq, hkv, lq, lk, dh)
    scratch = torch.empty((max(nbytes, 1),), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        _cuda.call("flash_attention", _cuda.ptr(qc), _cuda.ptr(kc), _cuda.ptr(vc),
                   _cuda.ptr(bc), _cuda.ptr(out), _cuda.ptr(lse), _DTYPES[q.dtype],
                   b, hq, hkv, lq, lk, dh, 0 if bc is None else bc.shape[1],
                   int(bool(causal)), s, float(logit_softcap), _cuda.ptr(scratch),
                   _cuda.stream(dev), entry="repro_flash_attention_lse")
    if out.numel():
        flash_attention_lse.launches += 1
    return out, lse


#: every launch of the lse entry
flash_attention_lse.launches = 0


def flash_attention_lse_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_bias: Optional[torch.Tensor] = None,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    logit_softcap: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`flash_attention_lse`: kv heads repeated,
    the dense f32 softmax with masked logits at −1e30 (the kernel's), the
    row's max m and sum l, o = Σ exp(s − m) v / max(l, 1e-30) and lse = m +
    log l (−inf where m <= NO_KEY or the row has no key)."""
    _check(q, k, v, kv_bias, causal)
    hq, hkv = q.shape[1], k.shape[1]
    if hkv != hq:
        rep = hq // hkv
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
        if kv_bias is not None and kv_bias.shape[1] != hq:
            kv_bias = torch.repeat_interleave(kv_bias, rep, dim=1)
    q, k, v = q.float(), k.float(), v.float()
    ref.no_tf32(q)
    dh = q.shape[-1]
    s = 1.0 / dh ** 0.5 if scale is None else scale
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * s
    if logit_softcap and logit_softcap > 0.0:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    if kv_bias is not None:
        logits = logits + kv_bias.float()[:, :, None, :]
    lq, lk = logits.shape[-2], logits.shape[-1]
    if causal:
        qpos = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
        kpos = torch.arange(lk, device=q.device)[None, :]
        logits = torch.where(kpos <= qpos, logits, _MASKED)
    if lk == 0:
        shape = q.shape[:3]
        return (torch.zeros(q.shape, dtype=torch.float32, device=q.device),
                torch.full(shape, -torch.inf, dtype=torch.float32, device=q.device))
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    l = p.sum(dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v) / torch.clamp_min(l, 1e-30)[..., None]
    lse = torch.where(m > NO_KEY, m + torch.log(l), -torch.inf)
    return out, lse


def merge_lse(outs: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """The attention over every part's keys from each part's (o, lse) of
    :func:`flash_attention_lse`: outs (P, ..., dh) f32 and lses (P, ...) f32
    in part order. M = the largest finite lse, w_p = exp(lse_p − M) (0 for
    a part with lse −inf), out = Σ_p w_p o_p / Σ_p w_p, folded in part
    order (no atomics: the same bits on every rank). A row no part sees
    (every lse −inf) comes out 0, not NaN."""
    seen = torch.isfinite(lses)
    top = torch.where(seen, lses, -torch.inf).amax(dim=0)
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    acc = torch.zeros_like(outs[0])
    den = torch.zeros_like(lses[0])
    for p in range(outs.shape[0]):
        w = torch.where(seen[p], torch.exp(lses[p] - top), torch.zeros_like(top))
        acc = acc + w[..., None] * outs[p]
        den = den + w
    return acc / torch.clamp_min(den, 1e-30)[..., None]
