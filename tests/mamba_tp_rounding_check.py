"""How far mamba2's step-0 gradients on a model axis sit from one device's,
in bf16 and in f32: the Mamba layout's rounding, measured on the CPU.

One step's gradients of the cross-entropy loss (``train_step.make_loss_fn``)
of mamba2-370m cut to ``--layers`` (full width, or ``--smoke`` widths) on
one device and on 4 gloo ranks of a (data 1, model 4) mesh, from the same
seeded draw and batch (b 2, s 64). For each leaf, the largest difference
over 8 bf16 ulps of the leaf's largest |g| (the bound of
``chip_smoke.GRAD_ULPS``); the worst leaves are printed. ``--f32`` runs
the whole model in f32 (the compute dtype patched in every rank), which
removes bf16 rounding and leaves the layout's arithmetic: a fault in the
layout shows there as a ratio near 1 or above, rounding as ~1e-4.

    PYTHONPATH=src python tests/mamba_tp_rounding_check.py --layers 8          # ~2 min
    PYTHONPATH=src python tests/mamba_tp_rounding_check.py --layers 8 --smoke --f32
"""
import argparse
import dataclasses

import numpy as np
import torch

torch.set_num_threads(1)
MODEL_RANKS = 4
B, S = 2, 64


def _setup(layers: int, smoke: bool, f32: bool):
    from repro_torch.configs import ARCHS, SHAPES, smoke_config
    from repro_torch.data import make_batch
    from repro_torch.models import attention, layers as layer_mod, mamba2, moe, transformer

    if f32:
        for mod in (layer_mod, transformer, mamba2, moe, attention):
            mod.COMPUTE_DTYPE = torch.float32
    cfg = ARCHS["mamba2-370m"]
    cfg = dataclasses.replace(smoke_config(cfg) if smoke else cfg, n_layers=layers)
    batch = make_batch(cfg, SHAPES["train_4k"], 0, batch_override=B, seq_override=S,
                       device="cpu")
    return cfg, batch


def _grads(cfg, batch, mesh=None) -> dict:
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_plan
    from repro_torch.models import build
    from repro_torch.train.train_step import make_loss_fn

    bundle = build(cfg)
    model = bundle.init(torch.Generator().manual_seed(0), device="cpu", trainable=True,
                        mesh=mesh)
    plan = None if mesh is None else make_plan(cfg, ShapeConfig("c", S, B, "train"), mesh)
    loss, _ = make_loss_fn(bundle, "ref", "none", plan)(model, batch)
    loss.backward()
    return model, {n: p.grad.detach() for n, p in model.named_parameters()}


def rank(rank: int, layers: int, smoke: bool, f32: bool) -> dict:
    """One rank: its gradients, each gathered whole over the model ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models.tensor_parallel import gather_dim, model_dim

    cfg, batch = _setup(layers, smoke, f32)
    mesh = init_device_mesh("cpu", (1, MODEL_RANKS), mesh_dim_names=("data", "model"))
    model, grads = _grads(cfg, batch, mesh)
    tp = model.tp
    return {n: (g if (d := model_dim(tp.specs[n])) is None else gather_dim(g, tp.axis, d))
            .float().numpy() for n, g in grads.items()}


def main() -> None:
    from repro_torch.launch.mesh import spawn_ranks

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--smoke", action="store_true", help="smoke_config widths")
    ap.add_argument("--f32", action="store_true", help="the whole model in f32")
    args = ap.parse_args()
    cfg, batch = _setup(args.layers, args.smoke, args.f32)
    _, one = _grads(cfg, batch)
    mesh = spawn_ranks(rank, MODEL_RANKS, backend="gloo", device="cpu", timeout=1200.0,
                       args=(args.layers, args.smoke, args.f32))[0]

    def ulp(x: float) -> float:
        return float(2.0 ** (np.floor(np.log2(abs(x))) - 7))

    ratios = sorted((float(np.abs(mesh[n] - g.float().numpy()).max())
                     / (8 * ulp(float(g.abs().max()))), n) for n, g in one.items())
    print(f"mamba2-370m, {args.layers} layers, {'smoke' if args.smoke else 'full'} widths, "
          f"{'f32' if args.f32 else 'bf16'}: the largest differences over 8 bf16 ulps of a "
          f"leaf's largest |g|:")
    for r, n in ratios[-4:]:
        print(f"  {n}: {r:.4g}")


if __name__ == "__main__":
    main()
