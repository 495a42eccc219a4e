"""The arithmetic of K5's split-kv route (decode), emulated on the CPU.

``csrc/flash_attention.cu``'s split-kv kernels cannot run here (no card,
no nvcc). What can be held here is what they compute, written out in
torch with the kernel's own split rule (``flash_attention.split_keys``):
per split of the key axis and per warp's quarter of it, the partial
``(m, l, acc)`` of an online softmax that starts at m = -1e30 and gives
keys past the range no weight; the warps' partials joined in warp order;
then the fixed-order combine over the splits, M = max m_s, L = sum l_s
exp(m_s - M), out = sum acc_s exp(m_s - M) / max(L, 1e-30). It is held
against the JAX package's Pallas kernel in interpret mode
(``repro.kernels.ops.flash_attention(impl="pallas")``) and its dense
oracle (``impl="ref"``), on the same numpy inputs. Everything folds in
f32, as in ``tests/test_torch_flash_attention.py``, so the tolerance is
that file's: rtol = atol = 1e-5 on O(1) outputs.

Cases: the gemma2 decode geometry at a small size (b 2, hq 8, hkv 4, lq 1,
dh 256, lk 300: five splits of 64, the last of 44), lk smaller than one
split, lk one key past a split, a split wholly masked (-1e30) in the
middle and a masked tail (the decode position mask), a bias per query
head, softcap 0 and 50, and lq 2 under the causal mask. Then the route
rule: every decode call of the served LM takes the split-kv route, its
prefill the tiled kernel.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.configs import ARCHS
from repro_torch.kernels import flash_attention as fa

torch.set_num_threads(1)

# f32 inputs, f32 folds on every side: a few ulps of O(1) outputs
TOL = dict(rtol=1e-5, atol=1e-5)
MASKED = -1e30
WARPS = 4  # warps of a split_kv_kernel block, each a quarter of the split


def _partial(logits, v):
    """(m, l, acc) of one range of keys: logits (..., n), v (..., n, dh)
    broadcast over the leading axes; an empty range keeps (-1e30, 0, 0)."""
    m = torch.clamp_min(logits.amax(-1), MASKED) if logits.shape[-1] else \
        torch.full(logits.shape[:-1], MASKED)
    p = torch.exp(logits - m[..., None])
    return m, p.sum(-1), torch.einsum("...k,...kd->...d", p, v)


def _join(parts):
    """Partials joined in order: M = max m, weights exp(m - M)."""
    mm = torch.stack([m for m, _, _ in parts]).amax(0)
    w = [torch.exp(m - mm) for m, _, _ in parts]
    ll = sum(l * wi for (_, l, _), wi in zip(parts, w))
    acc = sum(a * wi[..., None] for (_, _, a), wi in zip(parts, w))
    return mm, ll, acc


def split_kv(q, k, v, kv_bias=None, *, causal, scale, softcap):
    """The split-kv route in torch: q (b, hq, lq, dh), k/v (b, hkv, lk, dh),
    kv_bias (b, hkv or hq, lk). Rows are packed per kv head as the kernel
    packs them (row = head in group * lq + query row)."""
    b, hq, lq, dh = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    g = hq // hkv
    qr = q.float().reshape(b, hkv, g * lq, dh)
    vf = v.float()[:, :, None]                           # (b, hkv, 1, lk, dh)
    x = torch.einsum("bhrd,bhkd->bhrk", qr, k.float()) * scale
    if softcap > 0:
        x = softcap * torch.tanh(x / softcap)
    if kv_bias is not None:
        kb = kv_bias.float()
        if kb.shape[1] == hq:                            # per query head
            kb = kb.reshape(b, hkv, g, 1, lk).expand(b, hkv, g, lq, lk)
            x = x + kb.reshape(b, hkv, g * lq, lk)
        else:
            x = x + kb[:, :, None, :]
    if causal:
        qpos = torch.arange(g * lq) % lq + (lk - lq)
        x = torch.where(torch.arange(lk)[None, :] > qpos[:, None], MASKED, x)
    keys = fa.split_keys(lk)
    per = keys // WARPS
    splits = []
    for s0 in range(0, max(lk, 1), keys):
        warps = []
        for w in range(WARPS):
            lo = min(lk, s0 + w * per)
            hi = min(lk, s0 + keys, lo + per)
            warps.append(_partial(x[..., lo:hi], vf[..., lo:hi, :]))
        splits.append(_join(warps))
    _, ll, acc = _join(splits)
    out = acc / torch.clamp_min(ll, 1e-30)[..., None]
    return out.reshape(b, hq, lq, dh)


def _inputs(rng, b, hq, hkv, lq, lk, dh, bias):
    q = (rng.normal(size=(b, hq, lq, dh)) * 4).astype(np.float32)
    k = rng.normal(size=(b, hkv, lk, dh)).astype(np.float32)
    v = rng.normal(size=(b, hkv, lk, dh)).astype(np.float32)
    kb = None
    if bias is not None:
        kb = rng.normal(size=(b, hq if bias == "q_heads" else hkv, lk)).astype(np.float32)
        if bias == "masked_split":   # split 1 wholly masked, and the tail
            kb[..., 64:128] = MASKED
            kb[..., lk - 37:] = MASKED
        if bias == "tail":            # the decode position mask
            kb[..., lk // 3:] = MASKED
    return q, k, v, kb


CASES = [
    # b, hq, hkv, lq, lk, dh, causal, bias
    (2, 8, 4, 1, 300, 256, False, "tail"),           # gemma2 decode geometry
    (2, 8, 4, 1, 300, 256, False, "masked_split"),   # split 1 and the tail masked
    (2, 8, 4, 1, 40, 256, False, "kv"),              # lk < one split
    (1, 8, 4, 1, 65, 64, False, "kv"),               # one key past a split
    (1, 8, 4, 1, 130, 64, False, "q_heads"),         # a bias per query head
    (1, 4, 2, 1, 200, 16, False, None),              # no bias, narrow heads
    (1, 8, 4, 2, 150, 64, True, None),               # lq 2, causal
    (1, 8, 4, 2, 150, 64, True, "kv"),               # lq 2, causal, bias
]


@pytest.mark.parametrize("cap", [0.0, 50.0])
@pytest.mark.parametrize("b,hq,hkv,lq,lk,dh,causal,bias", CASES)
def test_split_kv_matches_pallas_and_reference(rng, b, hq, hkv, lq, lk, dh, causal,
                                               bias, cap):
    assert fa.route(hq, hkv, lq) == "split_kv"
    q, k, v, kb = _inputs(rng, b, hq, hkv, lq, lk, dh, bias)
    kw = dict(causal=causal, scale=1.0 / 16, logit_softcap=cap)
    jb = None if kb is None else jnp.asarray(kb)
    pallas = np.asarray(jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), kv_bias=jb,
                                             impl="pallas", **kw))
    oracle = np.asarray(jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), kv_bias=jb,
                                             impl="ref", **kw))
    got = split_kv(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                   None if kb is None else torch.from_numpy(kb),
                   causal=causal, scale=1.0 / 16, softcap=cap).numpy()
    assert got.shape == q.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)


def test_masked_split_drops_out_exactly(rng):
    """A split whose logits are all -1e30 ends with m = -1e30 and l = its
    key count; once another split holds a key with a finite bias, its
    weight exp(-1e30 - M) is exactly 0, so the answer is the one without
    those keys."""
    q, k, v, kb = _inputs(rng, 1, 2, 1, 1, 192, 16, "kv")
    kb[..., 64:128] = MASKED
    t = torch.from_numpy
    m, ll, _ = _partial(torch.full((3, 64), MASKED), torch.zeros((3, 64, 4)))
    assert bool((m == MASKED).all()) and bool((ll == 64).all())
    assert float(torch.exp(torch.tensor(MASKED) - torch.tensor(-50.0))) == 0.0
    got = split_kv(t(q), t(k), t(v), t(kb), causal=False, scale=0.25, softcap=0.0)
    keep = np.r_[0:64, 128:192]
    want = split_kv(t(q), t(k[:, :, keep]), t(v[:, :, keep]), t(kb[..., keep]),
                    causal=False, scale=0.25, softcap=0.0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("lk,keys,splits", [
    (0, 64, 1), (1, 64, 1), (64, 64, 1), (65, 64, 2), (300, 64, 5),
    (1232, 64, 20), (2048, 64, 32), (2049, 128, 17), (2208, 128, 18),
    (100_000, 4096, 25),
])
def test_split_rule(lk, keys, splits):
    assert fa.split_keys(lk) == keys
    assert max(1, math.ceil(lk / keys)) == splits
    assert splits <= fa.SPLIT_MAX_SPLITS and keys % (WARPS * 4) == 0


@pytest.mark.parametrize("hq,hkv,lq,want", [
    (8, 4, 1, "split_kv"),       # gemma2 decode: 2 rows a kv head
    (8, 4, 2048, "tiled"),       # gemma2 prefill
    (8, 4, 4, "split_kv"),       # 8 rows: the route's limit
    (8, 4, 5, "tiled"),
    (8, 8, 1, "split_kv"),       # MHA decode
    (40, 8, 1, "split_kv"),      # 5 query heads a kv head
    (48, 1, 1, "tiled"),         # 48 query heads on one kv head
    (2, 1, 3, "split_kv"),
])
def test_route(hq, hkv, lq, want):
    assert fa.route(hq, hkv, lq) == want


def test_every_lm_decode_call_takes_split_kv():
    """The served LM (gemma2-2b): a decode step attends one query row per
    head (models/attention.py), a prefill its whole prompt."""
    cfg = ARCHS["gemma2-2b"]
    assert fa.route(cfg.n_heads, cfg.n_kv_heads, 1) == "split_kv"
    for prompt in (16, 2048):
        assert fa.route(cfg.n_heads, cfg.n_kv_heads, prompt) == "tiled"
