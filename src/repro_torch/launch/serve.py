"""Serving launcher: batched generation with optional IHTC KV compression,
on the card unless ``--device cpu``.

    python -m repro_torch.launch.serve --arch gemma2-2b --compress
    python -m repro_torch.launch.serve --arch gemma2-2b --smoke --device cpu
    python -m repro_torch.launch.serve --arch deepseek-moe-16b --compress
    python -m repro_torch.launch.serve --arch mamba2-370m --smoke --device cpu
    python -m repro_torch.launch.serve --arch phi-3-vision-4.2b --compress
    python -m repro_torch.launch.serve --arch seamless-m4t-large-v2

``--arch`` takes every family: dense, MoE (deepseek-moe-16b,
llama4-scout), SSM (mamba2-370m), hybrid (jamba), VLM (phi-3-vision) and
the audio encoder-decoder (seamless-m4t). ``--compress`` needs a decoder-
only model with an attention layer (mamba2-370m has none, and an
encoder-decoder's cache is not compressed: the engine refuses both).
Full-width jamba (104 GB of bf16 weights) and llama4-scout (218 GB) do not
fit one 80 GB card: run them with ``--smoke``.

Weights are random, drawn from ``--seed`` (no checkpoint is loaded); the
prompts are ``--batch`` rows of ``--prompt-len`` ids drawn uniformly over
the vocabulary from the same seed. A VLM gets its 256-token patch prefix
and an enc-dec model ``--prompt-len`` encoder frames, drawn from the seed
as ``make_batch`` draws them (the front ends are stubs).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.data.pipeline import frontend_batch
from repro_torch.kernels import _cuda
from repro_torch.models import build
from repro_torch.runtime import resolve_device
from repro_torch.serve import ServeConfig, ServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--compress-t", type=int, default=2)
    ap.add_argument("--compress-m", type=int, default=1)
    ap.add_argument("--compress-tail", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = smoke_config(ARCHS[args.arch]) if args.smoke else ARCHS[args.arch]
    dev = resolve_device(args.device)
    if dev.type == "cuda":  # build the kernels now, not inside the prefill
        print(f"kernels built in {_cuda.build_all():.1f}s")
    bundle = build(cfg)
    model = bundle.init(torch.Generator(device=dev).manual_seed(args.seed),
                        device=dev)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size, size=(args.batch, args.prompt_len))
    batch = {"tokens": prompts, **frontend_batch(
        cfg, prng.PRNGKey(args.seed), args.batch, args.prompt_len, device=dev)}
    cache_kw = {"enc_len": args.prompt_len} if "frames" in batch else {}

    eng = ServeEngine(bundle, model, ServeConfig(
        max_new_tokens=args.new_tokens, temperature=args.temperature,
        compress=args.compress, compress_t=args.compress_t,
        compress_m=args.compress_m, compress_tail=args.compress_tail))
    out = eng.generate(batch, **cache_kw)
    tm = out["timings"]
    toks = args.batch * out["n_steps"]
    print(f"generated {tuple(out['tokens'].shape)} on {dev}: prefill "
          f"{tm['prefill_s']:.3f}s, decode {toks / tm['decode_s']:.1f} tok/s, "
          f"{len(tm['compress'])} compressions "
          f"({out['compressions']} in flight, "
          f"{sum(c['seconds'] for c in tm['compress']):.3f}s)")


if __name__ == "__main__":
    main()
