"""Training launcher — the port of ``repro.launch.train``, on one card
unless ``--device cpu``.

    python -m repro_torch.launch.train --arch gemma2-2b --steps 20

The reference's flags: ``--shape`` sets the batch and sequence (cut to at
most 8 × 256 unless ``--batch`` / ``--seq`` say otherwise), ``--remat``
and ``--microbatches`` the step, ``--ckpt-dir`` / ``--ckpt-every`` /
``--resume`` the checkpoints. The trainer is single-device: ``--mesh``
takes ``single``; the reference's ``debug``, ``pod1`` and ``pod2`` meshes
wait for ROADMAP.md, Queue 1, item 7. Weights are random from a seeded
generator, in f32; the batches are the pure-function synthetic pipeline.
A missing GPU raises; nothing falls back to the CPU.
"""
from __future__ import annotations

import argparse
from typing import Callable, Optional, Tuple

import torch

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.configs.base import ModelConfig, ParallelConfig, ShapeConfig
from repro_torch.data import make_batch
from repro_torch.models import build
from repro_torch.runtime import resolve_device
from repro_torch.train import (
    CheckpointManager,
    OptConfig,
    init_opt_state,
    make_train_step,
)
from repro_torch.train.fault_tolerance import StepStats, run_training

MESHES = ("single", "debug", "pod1", "pod2")


def check_mesh(mesh: str) -> None:
    if mesh != "single":
        raise NotImplementedError(
            f"--mesh {mesh}: the port's trainer runs on one device; the "
            f"meshes wait for ROADMAP.md, Queue 1, item 7")


def batch_dims(shape: ShapeConfig, batch: int = 0, seq: int = 0) -> Tuple[int, int]:
    """The launcher's (batch, seq): the shape's, cut to 8 × 256 unless given."""
    return batch or min(shape.global_batch, 8), seq or min(shape.seq_len, 256)


def batch_fn(cfg: ModelConfig, shape: ShapeConfig, b: int, s: int,
             device: torch.device) -> Callable[[int], dict]:
    """step -> the step's batch on ``device`` (a pure function of step)."""
    def bfs(step: int) -> dict:
        batch = make_batch(cfg, shape, step, batch_override=b, seq_override=s)
        return {k: v.to(device) for k, v in batch.items()}
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
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    _, _, stats, start = train(
        ARCHS[args.arch], SHAPES[args.shape], steps=args.steps, batch=args.batch,
        seq=args.seq, microbatches=args.microbatches, remat=args.remat,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, resume=args.resume,
        mesh=args.mesh, device=args.device)
    q = stats.quantiles()
    print(f"done: {args.steps - start} steps, p50 {q.get('p50', 0):.3f}s, "
          f"p99 {q.get('p99', 0):.3f}s, stragglers {stats.stragglers()}")


if __name__ == "__main__":
    main()
