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

``--mesh`` takes ``single``; the reference's ``debug``, ``pod1`` and
``pod2`` meshes carry a model axis and wait for ROADMAP.md, Queue 1, item
7c. Over data ranks, :func:`train` runs in every rank's process under
``runtime.configure(mesh=...)`` (a mesh of ``("data",)`` or ``("pod",
"data")``; ``launch.mesh.spawn_ranks`` starts the ranks): the
data-parallel step, AdamW's moments sharded by ZeRO-1, collective
checkpoints that restore on any number of data ranks. Training holds 16
bytes a parameter on one device (f32 weights and gradients, AdamW's two
f32 moments), 8 + 8/P a rank over P data ranks; a model whose state
exceeds the card's memory (llama4-scout, jamba, deepseek-moe-16b,
granite-20b, minitron-8b and qwen2.5-32b at full depth on one card)
raises before it is built: cut its depth or spread it over ranks. Weights
are random from a seeded generator, in f32; the batches are the
pure-function synthetic pipeline. A missing GPU raises; nothing falls back
to the CPU.
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
from repro_torch.launch.mesh import axis_size, data_axes
from repro_torch.runtime import active, resolve_device
from repro_torch.train import (
    CheckpointManager,
    OptConfig,
    init_opt_state,
    make_train_step,
)
from repro_torch.train.fault_tolerance import StepStats, run_training
from repro_torch.train.train_step import mesh_opt_specs

MESHES = ("single", "debug", "pod1", "pod2")
#: training state a parameter on one device: f32 weights and gradients,
#: AdamW's m and v
STATE_BYTES_PER_PARAM = 16


def check_mesh(mesh: str) -> None:
    if mesh != "single":
        raise NotImplementedError(
            f"--mesh {mesh}: this mesh carries a model axis; the port's "
            f"trainer runs on one device or over data ranks (runtime.configure("
            f"mesh=...)), and the model axis waits for ROADMAP.md, Queue 1, "
            f"item 7c")


def param_count(cfg: ModelConfig) -> int:
    """The trainable model's parameters, counted on the meta device."""
    make = encdec.EncDec if cfg.family == "encdec-audio" else transformer.LM
    return sum(p.numel() for p in make(cfg, device="meta", trainable=True).parameters())


def state_bytes_per_rank(n_params: int, data_ranks: int = 1, *,
                         zero_stage: int = 1, master: bool = False) -> float:
    """Training state a rank holds: f32 weights and gradients (8 B a
    parameter) and AdamW's f32 moments (8 B, and 4 B more for a ``master``
    copy), the moments split over the ``data_ranks`` by ZeRO-1."""
    moments = 8 + (4 if master else 0)
    share = data_ranks if zero_stage >= 1 else 1
    return n_params * (8 + moments / share)


def check_fits(cfg: ModelConfig, device: torch.device, *, data_ranks: int = 1,
               ranks_per_card: int = 1, zero_stage: int = 1,
               master: bool = False) -> None:
    """Raise if the training state of ``cfg`` exceeds the card's memory:
    :func:`state_bytes_per_rank` times the ranks that share one card."""
    if device.type != "cuda":
        return
    n = param_count(cfg)
    per_rank = state_bytes_per_rank(n, data_ranks, zero_stage=zero_stage,
                                    master=master)
    need = per_rank * ranks_per_card
    have = torch.cuda.get_device_properties(device).total_memory
    if need > have:
        raise ValueError(
            f"{cfg.name} at {cfg.n_layers} layers: training holds "
            f"{need / 1e9:.1f} GB on the card ({n / 1e9:.2f}e9 parameters x "
            f"{per_rank / n:g} B of f32 weights, gradients and AdamW moments "
            f"over {data_ranks} data rank(s), x {ranks_per_card} rank(s) on "
            f"the card), more than its {have / 1e9:.1f} GB; cut the depth "
            f"(--layers) or spread the state over data ranks on more cards "
            f"(ROADMAP.md, Queue 1, item 7b; the model axis waits for item 7c)")


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


def init_state(cfg: ModelConfig, *, device=None, seed: int = 0, mesh=None,
               zero_stage: int = 1):
    """(bundle, trainable f32 model drawn from ``seed``, zero AdamW state;
    on ``mesh`` this rank's ZeRO shards of it)."""
    dev = resolve_device(device)
    bundle = build(cfg)
    model = bundle.init(torch.Generator(device=dev).manual_seed(seed), device=dev,
                        trainable=True)
    if mesh is None:
        return bundle, model, init_opt_state(model)
    specs = mesh_opt_specs(model, mesh, zero_stage=zero_stage)
    return bundle, model, init_opt_state(model, mesh=mesh, specs=specs)


def ranks_per_card(mesh, device: torch.device) -> int:
    """Ranks of ``mesh`` that share one card (spawn_ranks and torchrun put
    rank r on card r % cards)."""
    if device.type != "cuda":
        return 1
    return -(-mesh.size() // torch.cuda.device_count())


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
    ``OptConfig(decay_steps=max(steps, 100))``), over the data ranks of the
    runtime's ``mesh`` when one is set. Returns (model, opt_state, stats,
    start step)."""
    check_mesh(mesh)
    ranks = active().mesh
    dev = resolve_device(device)
    parallel = ParallelConfig(remat=remat, microbatches=microbatches)
    if ranks is None:
        check_fits(cfg, dev)
    else:
        check_fits(cfg, dev, data_ranks=axis_size(ranks, data_axes(ranks)),
                   ranks_per_card=ranks_per_card(ranks, dev),
                   zero_stage=parallel.zero_stage)
    bundle, model, opt = init_state(cfg, device=device, mesh=ranks,
                                    zero_stage=parallel.zero_stage)
    dev = next(model.parameters()).device
    opt_cfg = opt_cfg or OptConfig(decay_steps=max(steps, 100))
    step = make_train_step(bundle, opt_cfg, parallel, mesh=ranks)
    opt_specs = (mesh_opt_specs(model, ranks, zero_stage=parallel.zero_stage)
                 if ranks is not None else None)
    b, s = batch_dims(shape, batch, seq)
    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    if ckpt and resume and ckpt.latest_step():
        start = ckpt.latest_step()
        state = ckpt.restore(start, {"params": model, "opt": opt}, mesh=ranks,
                             specs={"opt": opt_specs})
        model, opt = state["params"], state["opt"]
        print(f"resumed from step {start}")
    model, opt, stats = run_training(
        train_step=step, init_state=(model, opt),
        batch_for_step=batch_fn(cfg, shape, b, s, dev), n_steps=steps,
        start_step=start, ckpt=ckpt, ckpt_every=ckpt_every, on_metrics=on_metrics,
        mesh=ranks, opt_specs=opt_specs)
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
