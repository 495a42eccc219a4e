#!/usr/bin/env python3
"""Time K5's decode and prefill calls, K2's compression call, K1's
quantized shortlist calls, K1 f32 and K4 at the main path's shapes of one
checkout on a GPU.

    python3 chip_ab.py ROOT          # ROOT: a checkout holding src/repro_torch
    python3 chip_ab.py ROOT --k4     # K4 alone
    python3 chip_ab.py ROOT --lm     # the lm phase's generate, its tokens hashed

Builds that checkout's top-k and flash-attention kernels (into
ROOT/build/repro_torch/), then, at the shapes of ``chip_smoke.py``'s lm and
online phases (K5 decode: q 4 x 8 x 1 x 256 bf16 over a 1232-slot
compressed cache with its log-mass bias; K5 prefill: q 4 x 8 x 2048 x 256
bf16, causal, softcap 50; K2: 2208 bf16-valued rows of d 256, 2048 valid,
k 1; K1-bf16 and K1-int8: 5000 queries against the 5,393-row stand-in
index, d 6, k 8, the keys packed as the index packs them; K1 f32: the
fit's level 0, 8192 x 581,632, d 6, k 2, the stream's block, 8192 x
131,072, k 2, the serve shape at k 1 and at k 8, and the headline's 8192
x 10^6, d 2, k 1; K4: k-means over 2390 prototypes and 7 centres, d 6,
and 15,625 against 3, d 2, HAC's 4,096^2 at d 2 and DBSCAN's 50,000^2 at
d 6, each output's bytes also hashed with SHA-1, so that two trees' K4
can be compared bit for bit; with ``--lm`` instead chip_smoke.py's lm-phase
generate of the full gemma2-2b, the SHA-1 of its tokens and its walls, so
that two trees' served tokens can be compared), prints one line ``AB {...}``: each call's median time
between CUDA events (``ms``), its device time with the calls queued behind
a spin kernel (``device_ms``), its largest error against the plain version
(at the K1 f32 shapes on the first 512 queries: the plain version takes
seconds there), and the card's name and power limit. To compare two commits on one card, unpack the other commit beside
this one (``git archive``) and run the two in turns on that card: parent,
change, change, parent.
"""
import hashlib
import json
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs


def sha1(t: torch.Tensor) -> str:
    """SHA-1 of a tensor's bytes, copied to the host 256 MB at a time."""
    h = hashlib.sha1()
    flat = t.reshape(-1)
    step = 1 << 26
    for i in range(0, flat.numel(), step):
        h.update(flat[i:i + step].cpu().numpy())
    return h.hexdigest()


def k4_rows(out: dict) -> None:
    """K4 at the four shapes of chip_smoke.py's kernels phase."""
    from repro_torch.data import gmm_sample
    from repro_torch.kernels import pairwise_l2 as pw

    x, _ = cs._analog(cs.SIZES["covertype"])
    npro, mc = cs.SIZES["protos"], cs.SIZES["centres"]
    g1 = cs.dev(gmm_sample(cs.SIZES["lloyd_n"] + 3, seed=1)[0])
    g2 = cs.dev(gmm_sample(cs.HAC["budget"], seed=2)[0])
    xd = cs._dbscan_data()
    cases = {"k4_fit": (x[:npro].contiguous(), x[npro:npro + mc].contiguous(), None),
             "k4_lloyd": (g1[:-3].contiguous(), g1[-3:].contiguous(),
                          cs.dev(np.array([True, True, True]))),
             "k4_hac": (g2, g2, None), "k4_dbscan": (xd, xd, None)}
    for name, (a, b, v) in cases.items():
        def k4(a=a, b=b, v=v):
            return pw.pairwise_sq_l2(a, b, v)

        out[name] = {"n": a.shape[0], "m": b.shape[0], "d": a.shape[1],
                     "sha1": sha1(k4()), "ms": cs.cuda_ms(k4, reps=10),
                     "device_ms": cs.device_ms(k4, reps=10)}
        torch.cuda.empty_cache()


def lm_tokens(out: dict) -> None:
    """chip_smoke.py's lm-phase generate, its tokens hashed."""
    *_, engine, prompts = cs.lm_engine()
    res = engine.generate({"tokens": prompts})
    out["lm_tokens_sha1"] = hashlib.sha1(res["tokens"].cpu().numpy().tobytes()).hexdigest()
    out["lm_prefill_ms"] = res["timings"]["prefill_s"] * 1e3
    out["lm_decode_s"] = res["timings"]["decode_s"]


def main() -> int:
    args = sys.argv[1:]
    k4_only = "--k4" in args
    lm_only = "--lm" in args
    args = [a for a in args if a not in ("--k4", "--lm")]
    if len(args) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, args[0] + "/src")
    from repro_torch.kernels import _cuda

    keep = ("pairwise_l2",) if k4_only else (
        "topk", "topk_bf16", "topk_int8", "flash_attention", "pairwise_l2")
    if not lm_only:  # the lm path runs every library
        _cuda.SOURCES = {n: _cuda.SOURCES[n] for n in keep}
    build_s = _cuda.build_all()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py runs
    if lm_only:
        out = {"tree": args[0], "build_s": build_s, "card": card}
        lm_tokens(out)
        print("AB " + json.dumps(out), flush=True)
        return 0
    if k4_only:
        out = {"tree": args[0], "build_s": build_s, "card": card}
        k4_rows(out)
        print("AB " + json.dumps(out), flush=True)
        return 0
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_assign, knn_topk, ref

    g = torch.Generator(device="cuda").manual_seed(7)
    B, hq, hkv, dh = cs.LM["batch"], 8, 4, 256
    P = (cs.LM["prompt"] + cs.LM["new_tokens"]) // cs.LM["t"]
    lk = P + cs.LM["tail"]
    bias = torch.full((B, hkv, lk), -1e30, device="cuda")
    bias[..., :P] = torch.log(torch.randint(1, 5, (B, hkv, P), generator=g,
                                            device="cuda").float())
    bias[..., P] = 0.0
    q, k, v, _ = cs._attn_inputs(B, hq, hkv, 1, lk, dh, torch.bfloat16, 8)
    kw = dict(causal=False, scale=1.0 / 16, logit_softcap=50.0)

    def k5():
        return fa.flash_attention(q, k, v, bias, **kw)

    err5 = float((k5().float()
                  - fa.flash_attention_plain(q, k, v, bias, **kw).float()).abs().max())
    n = cs.LM["prompt"] + cs.LM["new_tokens"]
    x = cs._head_keys(n, 256, 3)
    valid = torch.arange(n, device="cuda") < cs.LM["prompt"]

    def k2():
        return knn_topk.knn_topk(x, 1, valid)

    gd = k2()[0]
    rd = ref.knn(x, 1, valid=valid)[0]
    ok = torch.isfinite(rd)
    err2 = float((gd[ok] - rd[ok]).abs().max())
    out = {"tree": args[0], "build_s": build_s, "card": card,
           "k5_decode": {"ms": cs.cuda_ms(k5, reps=50),
                         "device_ms": cs.device_ms(k5, reps=100), "max_abs_err": err5},
           "k2_compress": {"ms": cs.cuda_ms(k2, reps=50),
                           "device_ms": cs.device_ms(k2, reps=100), "max_abs_err": err2}}

    # K5 prefill of one global layer
    qp, kp, vp, _ = cs._attn_inputs(B, hq, hkv, cs.LM["prompt"], cs.LM["prompt"], dh,
                                    torch.bfloat16, 8)
    kwp = dict(causal=True, scale=1.0 / 16, logit_softcap=50.0)

    def k5p():
        return fa.flash_attention(qp, kp, vp, None, **kwp)

    errp = float((k5p().float()
                  - fa.flash_attention_plain(qp, kp, vp, None, **kwp).float()).abs().max())
    out["k5_prefill"] = {"ms": cs.cuda_ms(k5p, reps=20), "device_ms": cs.device_ms(k5p, reps=20),
                         "max_abs_err": errp}

    # K1's quantized shortlist at the serve shape
    protos, pvalid, queries = cs._standin_index()
    q8, scale, zero = fused_assign.quantize_keys(protos, pvalid)
    k = cs.ONLINE["shortlist"]
    for name, (q1, keys, kw1) in {
            "k1_bf16": (queries.bfloat16(), protos.bfloat16(), {}),
            "k1_int8": (queries, q8, dict(keys_scale=scale, keys_zero=zero))}.items():
        def k1(q1=q1, keys=keys, kw1=kw1):
            return fused_assign.fused_topk(q1, keys, k, pvalid, **kw1)

        rd = fused_assign.fused_topk_plain(q1, keys, k, pvalid, **kw1)[0]
        out[name] = {"ms": cs.cuda_ms(k1, reps=50), "device_ms": cs.device_ms(k1, reps=100),
                     "max_abs_err": float((k1()[0] - rd).abs().max())}

    # K1 f32 at the shapes of chip_smoke.py's kernels phase
    bq = cs.SIZES["blocked_q"]
    x, _ = cs._analog(cs.SIZES["covertype"])
    n_pad = -(-x.shape[0] // bq) * bq
    xp = torch.nn.functional.pad(x, (0, 0, 0, n_pad - x.shape[0]))
    q0 = (n_pad // bq // 2) * bq
    xs, _ = cs._stream_chunk()
    from repro_torch.data import gmm_sample

    gm = cs.dev(gmm_sample(cs.SIZES["gmm"], seed=0)[0])
    g_pad = -(-gm.shape[0] // bq) * bq
    gp = torch.nn.functional.pad(gm, (0, 0, 0, g_pad - gm.shape[0]))
    h0 = (g_pad // bq // 2) * bq
    rows = torch.arange(bq, dtype=torch.int32, device="cuda")
    f32_cases = {
        "k1_f32_level0": (xp[q0:q0 + bq].contiguous(), xp,
                          torch.arange(n_pad, device="cuda") < x.shape[0], rows + q0, 2),
        "k1_f32_stream": (xs[:bq].contiguous(), xs, None, rows, cs.ONLINE["t"] - 1),
        "k1_f32_serve_k1": (queries, protos, pvalid, None, 1),
        "k1_f32_serve_k8": (queries, protos, pvalid, None, k),
        "k1_f32_headline": (gp[h0:h0 + bq].contiguous(), gp,
                            torch.arange(g_pad, device="cuda") < gm.shape[0], rows + h0, 1),
    }
    for name, (q1, keys, kv, gidx, kk) in f32_cases.items():
        def k1(q1=q1, keys=keys, kv=kv, gidx=gidx, kk=kk):
            return fused_assign.fused_topk(q1, keys, kk, kv, q_gidx=gidx)

        m = min(512, q1.shape[0])
        rd = fused_assign.fused_topk_plain(q1[:m], keys, kk, kv,
                                           q_gidx=None if gidx is None else gidx[:m])[0]
        out[name] = {"nq": q1.shape[0], "p": keys.shape[0], "d": q1.shape[1], "k": kk,
                     "ms": cs.cuda_ms(k1, reps=20), "device_ms": cs.device_ms(k1, reps=50),
                     "max_abs_err": float((k1()[0][:m] - rd).abs().max())}
    k4_rows(out)
    print("AB " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
