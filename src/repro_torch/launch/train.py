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

``--mesh`` takes ``single`` or the reference's meshes with a model axis:
``debug`` (``make_debug_mesh(2, 4)``: 8 ranks, spawned on this host
through ``launch.mesh.spawn_ranks``, gloo and the ranks' mailboxes, or
run under ``torchrun`` with 8 ranks), ``pod1`` and ``pod2`` ((16, 16) and
(2, 16, 16): ``torchrun`` with exactly 256 or 512 ranks, else they
raise). On such a mesh the model is sharded over "model"
(``bundle.init(mesh=)``: each rank draws its slices, one whole leaf at a
time) and the step takes the cell's
``make_plan``; every family runs there: dense, VLM, MoE (expert
parallel), SSM, hybrid and the audio encoder-decoder.

Over data ranks alone, :func:`train` runs in every rank's process under
``runtime.configure(mesh=...)`` (a mesh of ``("data",)`` or ``("pod",
"data")``): the data-parallel step, AdamW's moments sharded by ZeRO-1,
collective checkpoints that restore on any number of data ranks.
Training holds 16 bytes a parameter on one device (f32 weights and
gradients, AdamW's two f32 moments); a rank holds 8 + 8/D bytes of each
of its parameters over D data ranks, its parameters being the replicated
ones and its share of the model-sharded ones. A model whose state exceeds
the card's memory (llama4-scout, jamba, deepseek-moe-16b, granite-20b,
minitron-8b and qwen2.5-32b at full depth on one card) raises before it
is built: cut its depth or spread it over ranks. Weights are random from a
seeded generator, in f32; the batches are the pure-function synthetic
pipeline. A missing GPU raises; nothing falls back to the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Callable, Optional, Tuple

import torch

from repro_torch.configs import ARCHS, SHAPES, smoke_config
from repro_torch.configs.base import ModelConfig, ParallelConfig, ShapeConfig
from repro_torch.data import make_batch
from repro_torch.models import build, encdec, transformer
from repro_torch.launch.mesh import (
    MeshShape,
    PRODUCTION_MESHES,
    axis_size,
    data_axes,
    make_debug_mesh,
    make_plan,
    make_production_mesh,
    spawn_ranks,
)
from repro_torch.models.tensor_parallel import model_dim
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
#: the meshes with a model axis: their shapes
MESH_SHAPES = {"debug": MeshShape(("data", "model"), (2, 4)), **PRODUCTION_MESHES}
#: training state a parameter on one device: f32 weights and gradients,
#: AdamW's m and v
STATE_BYTES_PER_PARAM = 16


def _meta_params(cfg: ModelConfig) -> dict:
    """{name: parameter} of the trainable model on the meta device."""
    make = encdec.EncDec if cfg.family == "encdec-audio" else transformer.LM
    return dict(make(cfg, device="meta", trainable=True).named_parameters())


def param_count(cfg: ModelConfig) -> int:
    """The trainable model's parameters, counted on the meta device."""
    return sum(p.numel() for p in _meta_params(cfg).values())


def rank_param_count(cfg: ModelConfig, model_ranks: int) -> int:
    """The parameters one rank holds over ``model_ranks`` model ranks: its
    share of each model-sharded leaf, every replicated one whole."""
    specs = build(cfg).param_specs(tp="model", tp_size=model_ranks)
    return sum(p.numel() // (model_ranks if model_dim(specs[n]) is not None else 1)
               for n, p in _meta_params(cfg).items())


def largest_leaf_bytes(cfg: ModelConfig) -> int:
    """f32 bytes of the model's largest parameter: a rank of a model axis
    draws each leaf whole before it keeps its slice
    (``tensor_parallel.init_sharded``)."""
    return 4 * max(p.numel() for p in _meta_params(cfg).values())


def init_bytes_per_rank(cfg: ModelConfig, n_params: int, data_ranks: int = 1, *,
                        model_ranks: int = 1, zero_stage: int = 1,
                        master: bool = False) -> float:
    """What a rank holds at its peak while the model is drawn: its f32
    weights and AdamW state, and on a model axis the whole leaf being drawn
    (the gradients do not exist yet)."""
    state = state_bytes_per_rank(n_params, data_ranks, zero_stage=zero_stage,
                                 master=master) - 4 * n_params
    return state + (largest_leaf_bytes(cfg) if model_ranks > 1 else 0)


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
               master: bool = False, model_ranks: int = 1) -> None:
    """Raise if the training state of ``cfg`` exceeds the card's memory:
    :func:`state_bytes_per_rank` of a rank's parameters
    (:func:`rank_param_count` over ``model_ranks``), or its peak while the
    model is drawn (:func:`init_bytes_per_rank`) where that is more, times
    the ranks that share one card. Activations, the collectives' buffers
    and mailboxes and each process's CUDA context come on top."""
    if device.type != "cuda":
        return
    n = param_count(cfg) if model_ranks <= 1 else rank_param_count(cfg, model_ranks)
    per_rank = max(state_bytes_per_rank(n, data_ranks, zero_stage=zero_stage,
                                        master=master),
                   init_bytes_per_rank(cfg, n, data_ranks, model_ranks=model_ranks,
                                       zero_stage=zero_stage, master=master))
    need = per_rank * ranks_per_card
    have = torch.cuda.get_device_properties(device).total_memory
    if need > have:
        raise ValueError(
            f"{cfg.name} at {cfg.n_layers} layers: training holds "
            f"{need / 1e9:.1f} GB on the card ({n / 1e9:.2f}e9 parameters x "
            f"{per_rank / n:g} B of f32 weights, gradients and AdamW moments "
            f"(or, while the model is drawn, one whole leaf in their place) "
            f"over {data_ranks} data rank(s) and {model_ranks} model rank(s), x "
            f"{ranks_per_card} rank(s) on the card), more than its "
            f"{have / 1e9:.1f} GB; cut the depth (--layers) or spread the state "
            f"over data and model ranks on more cards (--mesh: the model axis of "
            f"ROADMAP.md, Queue 1, item 7c, and its rest, item 7d, both done)")


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
    on ``mesh`` this rank's ZeRO shards of it, and on a mesh with "model"
    this rank's slices of the one-device draw, drawn one leaf at a time:
    ``bundle.init(mesh=)``)."""
    dev = resolve_device(device)
    bundle = build(cfg)
    model = bundle.init(torch.Generator(device=dev).manual_seed(seed), device=dev,
                        trainable=True, mesh=mesh)
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
    start step). ``mesh``: "single" (the runtime's mesh, if any) or a mesh
    with a model axis of :data:`MESH_SHAPES`, built over this process
    group (every rank calls ``train``; :func:`main` starts them)."""
    dev = resolve_device(device)
    ranks = active().mesh if mesh == "single" else _mesh_named(mesh, dev)
    parallel = ParallelConfig(remat=remat, microbatches=microbatches)
    b, s = batch_dims(shape, batch, seq)
    plan = None
    if ranks is None:
        check_fits(cfg, dev)
    else:
        names = tuple(ranks.mesh_dim_names or ())
        tp = axis_size(ranks, "model") if "model" in names else 1
        check_fits(cfg, dev, data_ranks=axis_size(ranks, data_axes(ranks)),
                   ranks_per_card=ranks_per_card(ranks, dev),
                   zero_stage=parallel.zero_stage, model_ranks=tp)
        if tp > 1:
            plan = make_plan(cfg, ShapeConfig(shape.name, s, b, "train"), ranks)
    bundle, model, opt = init_state(cfg, device=device, mesh=ranks,
                                    zero_stage=parallel.zero_stage)
    dev = next(model.parameters()).device
    opt_cfg = opt_cfg or OptConfig(decay_steps=max(steps, 100))
    step = make_train_step(bundle, opt_cfg, parallel, mesh=ranks, plan=plan)
    opt_specs = (mesh_opt_specs(model, ranks, zero_stage=parallel.zero_stage)
                 if ranks is not None else None)
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


def _mesh_named(name: str, device: torch.device):
    """The mesh ``name`` of :data:`MESH_SHAPES` over this process group."""
    if name != "debug":
        return make_production_mesh(multi_pod=name == "pod2", device_type=device.type)
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != MESH_SHAPES["debug"].size():
        raise RuntimeError(f"the debug mesh (2, 4) needs a process group of 8 ranks; "
                           f"this process has {world or 'none'}")
    return make_debug_mesh(2, 4, device_type=device.type)


def mesh_rank(rank: int, cfg: ModelConfig, shape: str, mesh: str, kw: dict) -> dict:
    """One rank of a launch on ``mesh`` (spawned by :func:`launch_mesh`, or
    the process itself under ``torchrun``): :func:`train`, rank 0 printing
    the metrics; the rank's losses, step times, the collectives of its last
    step (``_collectives.op_counts``: calls and bytes by op, whatever the
    route) and peak memory on the card (None on the CPU)."""
    from repro_torch.core._collectives import op_counts, reset_op_counts

    losses, step_ops = [], {}

    def on_metrics(step: int, m: dict) -> None:
        losses.append(float(m["loss"]))
        step_ops.clear()
        step_ops.update(op_counts())
        reset_op_counts()
        if rank == 0:
            print_metrics(step, m)

    reset_op_counts()

    _, _, stats, start = train(cfg, SHAPES[shape], mesh=mesh, on_metrics=on_metrics,
                               **kw)
    on_card = resolve_device(kw.get("device")).type == "cuda"
    return {"rank": rank, "start": start, "losses": losses,
            "step_collectives": dict(step_ops),
            "quantiles": stats.quantiles(), "stragglers": stats.stragglers(),
            "peak_bytes": torch.cuda.max_memory_allocated() if on_card else None}


def launch_mesh(cfg: ModelConfig, shape: str, mesh: str, kw: dict, *,
                timeout: float = 3600.0) -> list:
    """Train on ``mesh`` (debug, pod1, pod2): under ``torchrun`` this
    process is one rank (the launch must have exactly the mesh's ranks);
    else ``debug`` spawns its 8 ranks on this host (gloo; on one card the
    copies go through the ranks' device mailboxes), and ``pod1``/``pod2``
    raise. Returns every rank's :func:`mesh_rank` (this rank's alone under
    ``torchrun``)."""
    import torch.distributed as dist

    need = MESH_SHAPES[mesh].size()
    dev = resolve_device(kw.get("device"))
    if "WORLD_SIZE" in os.environ:  # torchrun
        world = int(os.environ["WORLD_SIZE"])
        if world != need:
            raise RuntimeError(f"--mesh {mesh} {MESH_SHAPES[mesh].sizes} needs exactly "
                               f"{need} torchrun ranks; this launch has {world}")
        if not dist.is_initialized():
            local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
            cards = torch.cuda.device_count() if dev.type == "cuda" else 0
            dist.init_process_group("nccl" if 0 < local <= cards else "gloo")
            if dev.type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)) % cards)
        return [mesh_rank(dist.get_rank(), cfg, shape, mesh, kw)]
    if mesh != "debug":
        raise RuntimeError(
            f"--mesh {mesh} is {MESH_SHAPES[mesh].sizes} over "
            f"{MESH_SHAPES[mesh].mesh_dim_names}: launch it with torchrun and exactly "
            f"{need} ranks (e.g. torchrun --nnodes ... --nproc-per-node ... -m "
            f"repro_torch.launch.train --mesh {mesh} ...)")
    return spawn_ranks(mesh_rank, need, backend="gloo", device=str(dev),
                       args=(cfg, shape, mesh, kw), timeout=timeout)


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
    kw = dict(steps=args.steps, batch=args.batch, seq=args.seq,
              microbatches=args.microbatches, remat=args.remat,
              ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, resume=args.resume,
              device=args.device)
    if args.mesh != "single":
        outs = launch_mesh(cfg, args.shape, args.mesh, kw)
        start, q, strag = outs[0]["start"], outs[0]["quantiles"], outs[0]["stragglers"]
    else:
        _, _, stats, start = train(cfg, SHAPES[args.shape], **kw)
        q, strag = stats.quantiles(), stats.stragglers()
    if args.mesh == "single" or outs[0]["rank"] == 0:
        peak = ""
        if args.mesh != "single" and outs[0].get("peak_bytes") is not None:
            peak = f", peak {max(o['peak_bytes'] for o in outs) / 1e9:.2f} GB a rank"
        print(f"done: {args.steps - start} steps, p50 {q.get('p50', 0):.3f}s, "
              f"p99 {q.get('p99', 0):.3f}s, stragglers {strag}{peak}")


if __name__ == "__main__":
    main()
