"""The arithmetic of K5's tensor-core prefill route ("tiled_mma"), emulated
on the CPU.

``csrc/flash_attention.cu``'s ``flash_mma_kernel`` (bf16 q, k and v at
head_dim 64, 128 or 256: every prefill of the served LM) cannot run here
(no card, no nvcc). What can be held here is what it computes, written
out in torch: the g = hq / hkv query heads of a kv head packed into one
row space, 128 packed rows a block, the block's keys up to its causal
end in 64-key tiles; per tile the logits q·k of bf16 operands (each product
exact in f32, summed in f32), then scale, softcap·tanh(s / softcap), the
bias, the causal -1e30 and -inf past lk, the online softmax from
m = -1e30, and p·v with p split into two bf16, ``p_hi = bf16(p)``,
``p_lo = bf16(p - p_hi)``, each times v (exact bf16) summed in f32; the
output divided by max(l, 1e-30) and rounded to bf16 once.

It is held against the JAX package's Pallas kernel in interpret mode
(``repro.kernels.ops.flash_attention(impl="pallas")``) and against the
port's plain version (``flash_attention_plain``), on the same bf16 inputs
made with numpy, within ATTN_TOL_BF16 (rtol 2^-7, atol 1e-5: the
tolerance ``chip_smoke.py`` holds the kernel to; both sides round the
output to bf16 once). Before that rounding it is within 1e-4 of the
dense f32 oracle, which a single-bf16 p misses. Cases: causal with
lk > lq, a bias per kv head and per query head, softcap 0 and 50, g 1, 2
and 4, lq not a multiple of 128 (a block straddles two query heads), a
wholly masked first tile, head_dim 64, 128 and 256. Then the split's
accuracy and the route rule.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.configs import ARCHS
from repro_torch.kernels import flash_attention as fa

torch.set_num_threads(1)

ATTN_TOL_BF16 = dict(rtol=2 ** -7, atol=1e-5)
MASKED = -1e30
ROWS, KEYS = 128, 64  # packed rows a block, keys a kv tile


def split_p(p: torch.Tensor):
    """p (f32) as two bf16: p_hi = bf16(p), p_lo = bf16(p - p_hi)."""
    hi = p.bfloat16()
    return hi, (p - hi.float()).bfloat16()


def tiled_mma(q, k, v, kv_bias=None, *, causal, scale, softcap, split=True):
    """The route in torch: q (b, hq, lq, dh) bf16, k/v (b, hkv, lk, dh)
    bf16, kv_bias (b, hkv or hq, lk) f32. Returns the f32 output before the
    bf16 rounding. ``split=False`` rounds p to one bf16 instead."""
    b, hq, lq, dh = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    g = hq // hkv
    n_rows = g * lq
    qr = q.float().reshape(b, hkv, n_rows, dh)
    kf, vf = k.float(), v.float()
    rows = torch.arange(n_rows)
    head_in_group, qpos = rows // lq, rows % lq + lk - lq
    if kv_bias is not None:
        kb = kv_bias.float()
        if kb.shape[1] == hq:  # per query head: the packed row's head
            kb = kb.reshape(b, hkv, g, lk)[:, :, head_in_group]
        else:
            kb = kb[:, :, None, :].expand(b, hkv, n_rows, lk)
    out = torch.zeros((b, hkv, n_rows, dh))
    for r0 in range(0, n_rows, ROWS):
        r1 = min(n_rows, r0 + ROWS)
        kv_end = lk
        if causal:  # the last key any row of the block sees, + 1
            max_i = lq - 1 if (r1 - 1) // lq != r0 // lq else (r1 - 1) % lq
            kv_end = min(lk, max_i + lk - lq + 1)
        m = torch.full((b, hkv, r1 - r0), MASKED)
        l = torch.zeros((b, hkv, r1 - r0))
        o = torch.zeros((b, hkv, r1 - r0, dh))
        for k0 in range(0, kv_end, KEYS):
            k1 = min(lk, k0 + KEYS)
            x = torch.einsum("bhrd,bhkd->bhrk", qr[:, :, r0:r1], kf[:, :, k0:k1]) * scale
            if softcap > 0:
                x = softcap * torch.tanh(x / softcap)
            if kv_bias is not None:
                x = x + kb[:, :, r0:r1, k0:k1]
            if causal:
                future = torch.arange(k0, k1)[None, :] > qpos[r0:r1, None]
                x = torch.where(future, MASKED, x)
            m_new = torch.maximum(m, x.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(x - m_new[..., None])
            l = l * alpha + p.sum(-1)
            m = m_new
            hi, lo = split_p(p) if split else (p.bfloat16(), torch.zeros_like(p).bfloat16())
            vt = vf[:, :, k0:k1]
            o = o * alpha[..., None] + (torch.einsum("bhrk,bhkd->bhrd", hi.float(), vt)
                                        + torch.einsum("bhrk,bhkd->bhrd", lo.float(), vt))
        out[:, :, r0:r1] = o / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(b, hq, lq, dh)


def _inputs(rng, b, hq, hkv, lq, lk, dh, bias):
    q = torch.from_numpy((rng.normal(size=(b, hq, lq, dh)) * 4).astype(np.float32)).bfloat16()
    k = torch.from_numpy(rng.normal(size=(b, hkv, lk, dh)).astype(np.float32)).bfloat16()
    v = torch.from_numpy(rng.normal(size=(b, hkv, lk, dh)).astype(np.float32)).bfloat16()
    kb = None
    if bias is not None:
        kb = rng.normal(size=(b, hq if bias == "q_heads" else hkv, lk)).astype(np.float32)
        if bias == "first_tile":  # every key of the first kv tile masked
            kb[..., :KEYS] = MASKED
        kb = torch.from_numpy(kb)
    return q, k, v, kb


def _jax(q, k, v, kb, **kw):
    def j(t):
        return jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)
    out = jops.flash_attention(j(q), j(k), j(v), impl="pallas",
                               kv_bias=None if kb is None else jnp.asarray(kb.numpy()), **kw)
    return torch.from_numpy(np.asarray(out, dtype=np.float32))


CASES = [
    # b, hq, hkv, lq, lk, dh, causal, bias
    (1, 4, 2, 100, 160, 64, True, None),            # causal, lk > lq; a block straddles heads
    (1, 4, 4, 70, 70, 64, True, "kv"),              # g 1, square causal, bias per kv head
    (1, 8, 2, 33, 130, 128, True, "q_heads"),       # g 4, bias per query head
    (1, 2, 1, 70, 200, 64, True, "first_tile"),     # the first kv tile wholly masked
    (2, 4, 2, 20, 20, 256, True, None),             # gemma2's head_dim
    (1, 4, 2, 50, 90, 64, False, "kv"),             # no causal mask
]


@pytest.mark.parametrize("cap", [0.0, 50.0])
@pytest.mark.parametrize("b,hq,hkv,lq,lk,dh,causal,bias", CASES)
def test_tiled_mma_matches_pallas_and_plain(rng, b, hq, hkv, lq, lk, dh, causal, bias, cap):
    assert fa.route(hq, hkv, lq, torch.bfloat16, dh) == "tiled_mma"
    q, k, v, kb = _inputs(rng, b, hq, hkv, lq, lk, dh, bias)
    kw = dict(causal=causal, scale=1.0 / 16, logit_softcap=cap)
    got32 = tiled_mma(q, k, v, kb, causal=causal, scale=1.0 / 16, softcap=cap)
    got = got32.bfloat16().float()
    assert got.shape == q.shape and bool(torch.isfinite(got).all())
    plain = fa.flash_attention_plain(q, k, v, kb, **kw).float()
    torch.testing.assert_close(got, plain, **ATTN_TOL_BF16)
    torch.testing.assert_close(got, _jax(q, k, v, kb, **kw), **ATTN_TOL_BF16)
    # before the output's rounding: the f32 oracle on the widened inputs
    oracle = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                      kb, **kw)
    torch.testing.assert_close(got32, oracle, rtol=0, atol=1e-4)


def test_single_bf16_p_misses_what_the_split_holds(rng):
    """p rounded to one bf16 moves the f32 output by about 2^-9 of |v|;
    p_hi + p_lo keeps it within 1e-4 (the test above)."""
    q, k, v, kb = _inputs(rng, 1, 4, 2, 100, 160, 64, "kv")
    kw = dict(causal=True, scale=1.0 / 16, softcap=50.0)
    one = tiled_mma(q, k, v, kb, split=False, **kw)
    oracle = fa.flash_attention_plain(q.float(), k.float(), v.float(), kb, causal=True,
                                      scale=1.0 / 16, logit_softcap=50.0)
    assert float((one - oracle).abs().max()) > 1e-3


def test_p_split_keeps_16_bits():
    rng = np.random.default_rng(0)
    p = torch.from_numpy(np.concatenate([rng.random(100_000), 10.0 ** -rng.uniform(0, 30, 100_000)])
                         .astype(np.float32))
    hi, lo = split_p(p)
    assert torch.equal(p - hi.float(), (p.double() - hi.double()).float())  # exact in f32
    err = (p.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -16 * p.double()).all())


def test_wholly_masked_tile_leaves_no_trace(rng):
    """A tile whose logits are all -1e30 (m stays -1e30, each p is 1) is
    wiped by alpha = exp(-1e30 - m) = 0 at the first real key: the answer
    is the one without those keys."""
    q, k, v, kb = _inputs(rng, 1, 2, 1, 10, 192, 64, "kv")
    kb[..., :KEYS] = MASKED
    kw = dict(causal=False, scale=0.25, softcap=0.0)
    got = tiled_mma(q, k, v, kb, **kw)
    want = tiled_mma(q, k[:, :, KEYS:], v[:, :, KEYS:], kb[..., KEYS:], **kw)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("hq,hkv,lq,dtype,dh,want", [
    (8, 4, 2048, torch.bfloat16, 256, "tiled_mma"),   # gemma2 prefill
    (8, 4, 5, torch.bfloat16, 64, "tiled_mma"),
    (4, 4, 9, torch.bfloat16, 128, "tiled_mma"),
    (48, 1, 1, torch.bfloat16, 256, "tiled_mma"),     # 48 rows on one kv head
    (8, 4, 2048, torch.float32, 256, "tiled"),        # f32 stays on the CUDA cores
    (8, 4, 2048, torch.bfloat16, 100, "tiled"),       # a head_dim the tiles do not take
    (8, 4, 2048, torch.bfloat16, 32, "tiled"),
    (8, 4, 1, torch.bfloat16, 256, "split_kv"),       # decode
    (8, 4, 4, torch.bfloat16, 256, "split_kv"),
])
def test_route(hq, hkv, lq, dtype, dh, want):
    assert fa.route(hq, hkv, lq, dtype, dh) == want


def test_every_lm_prefill_takes_tiled_mma():
    cfg = ARCHS["gemma2-2b"]
    dh = cfg.head_dim
    assert fa.route(cfg.n_heads, cfg.n_kv_heads, 1, torch.bfloat16, dh) == "split_kv"
    for prompt in (16, 2048):
        assert fa.route(cfg.n_heads, cfg.n_kv_heads, prompt, torch.bfloat16, dh) == "tiled_mma"
