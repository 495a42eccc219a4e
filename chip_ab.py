#!/usr/bin/env python3
"""Time K5's decode call and K2's compression call of one checkout on a GPU.

    python3 chip_ab.py ROOT      # ROOT: a checkout holding src/repro_torch

Builds that checkout's top-k and flash-attention kernels (into
ROOT/build/repro_torch/), then, at the lm phase's shapes of
``chip_smoke.py`` (K5: q 4 x 8 x 1 x 256 bf16 over a 1232-slot compressed
cache with its log-mass bias; K2: 2208 bf16-valued rows of d 256, 2048
valid, k 1), prints one line ``AB {...}``: each call's median time between
CUDA events (``ms``), its device time with the calls queued behind a spin
kernel (``device_ms``), its largest error against the plain version, and
the card's name and power limit. To compare two commits on one card, unpack
the other commit beside this one (``git archive``) and run the two in turns
in one session: parent, change, change, parent.
"""
import json
import subprocess
import sys

import torch

import chip_smoke as cs


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, sys.argv[1] + "/src")
    from repro_torch.kernels import _cuda

    _cuda.SOURCES = {n: _cuda.SOURCES[n] for n in ("topk", "flash_attention")}
    build_s = _cuda.build_all()
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import knn_topk, ref

    torch.backends.cuda.matmul.allow_tf32 = False
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
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    out = {"tree": sys.argv[1], "build_s": build_s, "card": card,
           "k5_decode": {"ms": cs.cuda_ms(k5, reps=50),
                         "device_ms": cs.device_ms(k5, reps=100), "max_abs_err": err5},
           "k2_compress": {"ms": cs.cuda_ms(k2, reps=50),
                           "device_ms": cs.device_ms(k2, reps=100), "max_abs_err": err2}}
    print("AB " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
