"""Serving launcher: batched generation with optional IHTC KV compression,
on the card unless ``--device cpu``.

    python -m repro_torch.launch.serve --arch gemma2-2b --compress
    python -m repro_torch.launch.serve --arch gemma2-2b --smoke --device cpu
    python -m repro_torch.launch.serve --arch deepseek-moe-16b --compress
    python -m repro_torch.launch.serve --arch mamba2-370m --smoke --device cpu

``--arch`` takes the dense, MoE (deepseek-moe-16b, llama4-scout), SSM
(mamba2-370m) and hybrid (jamba) families; ``--compress`` needs an
attention layer (mamba2-370m has none: the engine refuses it). Full-width
jamba (104 GB of bf16 weights) and llama4-scout (218 GB) do not fit one
80 GB card: run them with ``--smoke``.

Weights are random, drawn from ``--seed`` (no checkpoint is loaded); the
prompts are ``--batch`` rows of ``--prompt-len`` ids drawn uniformly over
the vocabulary from the same seed.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCHS, smoke_config
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

    eng = ServeEngine(bundle, model, ServeConfig(
        max_new_tokens=args.new_tokens, temperature=args.temperature,
        compress=args.compress, compress_t=args.compress_t,
        compress_m=args.compress_m, compress_tail=args.compress_tail))
    out = eng.generate({"tokens": prompts})
    tm = out["timings"]
    toks = args.batch * out["n_steps"]
    print(f"generated {tuple(out['tokens'].shape)} on {dev}: prefill "
          f"{tm['prefill_s']:.3f}s, decode {toks / tm['decode_s']:.1f} tok/s, "
          f"{len(tm['compress'])} compressions "
          f"({out['compressions']} in flight, "
          f"{sum(c['seconds'] for c in tm['compress']):.3f}s)")


if __name__ == "__main__":
    main()
