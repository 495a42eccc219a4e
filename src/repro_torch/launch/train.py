"""Training launcher — the port of ``repro.launch.train``, on one card
unless ``--device cpu``.

    python -m repro_torch.launch.train --arch gemma2-2b --steps 20
    python -m repro_torch.launch.train --arch deepseek-moe-16b --layers 4
    python -m repro_torch.launch.train --arch seamless-m4t-large-v2 --smoke --device cpu

Every arch of ``ARCHS`` trains: dense, MoE, SSM, hybrid, the VLM (its
batches carry the stubbed 256-token patch prefix) and the audio
encoder-decoder (its batches carry encoder frames). The reference's flags:
``--shape`` sets the batch and sequence (cut to at most 8 × 256 unless
``--batch`` / ``--seq`` say otherwise), ``--remat`` and ``--microbatches``
the step, ``--ckpt-dir`` / ``--ckpt-every`` / ``--resume`` the
checkpoints. Added here: ``--smoke`` takes the arch's ``smoke_config``
(CPU-sized), ``--layers`` keeps the first N decoder layers at full width.

The trainer is single-device: ``--mesh`` takes ``single``; the
reference's ``debug``, ``pod1`` and ``pod2`` meshes wait for ROADMAP.md,
Queue 1, item 7b. Training holds 16 bytes a parameter (f32 weights and
gradients, AdamW's two f32 moments); a model whose state exceeds the
card's memory (llama4-scout, jamba, deepseek-moe-16b, granite-20b,
minitron-8b and qwen2.5-32b at full depth) raises before it is built:
cut its depth or wait for item 7b. Weights are random from a seeded
generator, in f32; the batches are the pure-function synthetic pipeline.
A missing GPU raises; nothing falls back to the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch.configs import ARCHS, SHAPES, smoke_config
from repro_torch.configs.base import ModelConfig, ParallelConfig, ShapeConfig
from repro_torch.data import make_batch
from repro_torch.models import build, encdec, transformer
from repro_torch.runtime import resolve_device
from repro_torch.train import (
    CheckpointManager,
    OptConfig,
    init_opt_state,
    make_train_step,
)
from repro_torch.train.fault_tolerance import StepStats, run_training

MESHES = ("single", "debug", "pod1", "pod2")
#: training state a parameter: f32 weights and gradients, AdamW's m and v
STATE_BYTES_PER_PARAM = 16


def check_mesh(mesh: str) -> None:
    if mesh != "single":
        raise NotImplementedError(
            f"--mesh {mesh}: the port's trainer runs on one device; the "
            f"meshes wait for ROADMAP.md, Queue 1, item 7b")


def param_count(cfg: ModelConfig) -> int:
    """The trainable model's parameters, counted on the meta device."""
    make = encdec.EncDec if cfg.family == "encdec-audio" else transformer.LM
    return sum(p.numel() for p in make(cfg, device="meta", trainable=True).parameters())


def check_fits(cfg: ModelConfig, device: torch.device) -> None:
    """Raise if the training state of ``cfg`` exceeds the card's memory."""
    if device.type != "cuda":
        return
    n = param_count(cfg)
    need, have = STATE_BYTES_PER_PARAM * n, torch.cuda.get_device_properties(
        device).total_memory
    if need > have:
        raise ValueError(
            f"{cfg.name} at {cfg.n_layers} layers: training holds "
            f"{need / 1e9:.1f} GB ({n / 1e9:.2f}e9 parameters x "
            f"{STATE_BYTES_PER_PARAM} B of f32 weights, gradients and AdamW "
            f"moments), more than the card's {have / 1e9:.1f} GB; cut the "
            f"depth (--layers) or train across devices (ROADMAP.md, Queue 1, "
            f"item 7b)")


def batch_dims(shape: ShapeConfig, batch: int = 0, seq: int = 0) -> Tuple[int, int]:
    """The launcher's (batch, seq): the shape's, cut to 8 × 256 unless given."""
    return batch or min(shape.global_batch, 8), seq or min(shape.seq_len, 256)


def batch_fn(cfg: ModelConfig, shape: ShapeConfig, b: int, s: int,
             device: torch.device) -> Callable[[int], dict]:
    """step -> the step's batch, drawn on ``device`` (a pure function of
    step: the draws are the same bits on every device)."""
    def bfs(step: int) -> dict:
        return make_batch(cfg, shape, step, batch_override=b, seq_override=s,
                          device=device)
    return bfs


def init_state(cfg: ModelConfig, *, device=None, seed: int = 0):
    """(bundle, trainable f32 model drawn from ``seed``, zero AdamW state)."""
    dev = resolve_device(device)
    bundle = build(cfg)
    model = bundle.init(torch.Generator(device=dev).manual_seed(seed), device=dev,
                        trainable=True)
    return bundle, model, init_opt_state(model)


def print_metrics(step: int, m: dict) -> None:
    if step % 10 == 0:
        print(f"step {step:>6} loss {float(m['loss']):.4f} "
              f"gnorm {float(m['grad_norm']):.2f}", flush=True)


def train(cfg: ModelConfig, shape: ShapeConfig, *, steps: int, batch: int = 0,
          seq: int = 0, microbatches: int = 1, remat: str = "block",
          ckpt_dir: str = "", ckpt_every: int = 100, resume: bool = False,
          mesh: str = "single", device=None,
          opt_cfg: Optional[OptConfig] = None,
          on_metrics: Optional[Callable[[int, dict], None]] = print_metrics
          ) -> Tuple[torch.nn.Module, dict, StepStats, int]:
    """Train ``steps`` steps (``opt_cfg`` default: the reference launcher's
    ``OptConfig(decay_steps=max(steps, 100))``). Returns (model,
    opt_state, stats, start step)."""
    check_mesh(mesh)
    check_fits(cfg, resolve_device(device))
    bundle, model, opt = init_state(cfg, device=device)
    dev = next(model.parameters()).device
    opt_cfg = opt_cfg or OptConfig(decay_steps=max(steps, 100))
    step = make_train_step(bundle, opt_cfg,
                           ParallelConfig(remat=remat, microbatches=microbatches))
    b, s = batch_dims(shape, batch, seq)
    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    if ckpt and resume and ckpt.latest_step():
        start = ckpt.latest_step()
        state = ckpt.restore(start, {"params": model, "opt": opt})
        model, opt = state["params"], state["opt"]
        print(f"resumed from step {start}")
    model, opt, stats = run_training(
        train_step=step, init_state=(model, opt),
        batch_for_step=batch_fn(cfg, shape, b, s, dev), n_steps=steps,
        start_step=start, ckpt=ckpt, ckpt_every=ckpt_every, on_metrics=on_metrics)
    return model, opt, stats, start


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--shape", default="train_4k", choices=sorted(SHAPES))
    ap.add_argument("--mesh", default="single", choices=MESHES)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=0, help="override batch")
    ap.add_argument("--seq", type=int, default=0, help="override seq")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="block", choices=("none", "block", "dots"))
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--layers", type=int, default=0,
                    help="keep the first N decoder layers (full width)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = smoke_config(ARCHS[args.arch]) if args.smoke else ARCHS[args.arch]
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    _, _, stats, start = train(
        cfg, SHAPES[args.shape], steps=args.steps, batch=args.batch,
        seq=args.seq, microbatches=args.microbatches, remat=args.remat,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, resume=args.resume,
        mesh=args.mesh, device=args.device)
    q = stats.quantiles()
    print(f"done: {args.steps - start} steps, p50 {q.get('p50', 0):.3f}s, "
          f"p99 {q.get('p99', 0):.3f}s, stragglers {stats.stragglers()}")


if __name__ == "__main__":
    main()
