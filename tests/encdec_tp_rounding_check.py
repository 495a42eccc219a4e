"""How far seamless's step-0 gradients on a model axis sit from one
device's, beside how far one device sits from itself: the enc-dec layout's
rounding, measured on the CPU.

One step's gradients of the cross-entropy loss (``train_step.make_loss_fn``)
of seamless-m4t-large-v2 at full width cut to ``--layers`` encoder and
decoder layers (its vocabulary cut to 1,024 rows: the embedding is exact
over the ranks), from the same seeded draw and batch (b 2, s 64), on:

  * one device, and the same step at 2 microbatches on one device (its
    sums in another order: how far one device sits from itself);
  * 4 gloo ranks of a (data 1, model 4) mesh.

For each leaf, the largest difference over 8 bf16 ulps of the leaf's
largest |g| (the bound of ``chip_smoke.GRAD_ULPS``); the worst leaves are
printed. ``--f32`` runs the whole model in f32 with a dense f32 attention
(the compute dtype patched in every rank; the route's bf16 probabilities
would round otherwise), which removes bf16 rounding and leaves the
layout's arithmetic: a fault in the layout shows there as a ratio near 1
or above, rounding as ~1e-4.

    PYTHONPATH=src python tests/encdec_tp_rounding_check.py --layers 2          # ~1 min
    PYTHONPATH=src python tests/encdec_tp_rounding_check.py --layers 2 --f32
"""
import argparse
import dataclasses

import numpy as np
import torch

torch.set_num_threads(1)
MODEL_RANKS = 4
B, S = 2, 64


def _setup(layers: int, f32: bool):
    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.data import make_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention, encdec, layers as layer_mod

    if f32:
        for mod in (layer_mod, attention, encdec):
            mod.COMPUTE_DTYPE = torch.float32

        def dense(q, k, v, *, causal=True, window=0, kv_bias=None, softcap=0.0,
                  scale=None, impl=None, chunk=0):
            return fa.flash_attention_plain(q, k, v, kv_bias, causal=causal, scale=scale,
                                            logit_softcap=softcap)

        attention.attend = dense
    cfg = dataclasses.replace(ARCHS["seamless-m4t-large-v2"], n_layers=layers,
                              n_enc_layers=layers, vocab_size=1024)
    batch = make_batch(cfg, SHAPES["train_4k"], 0, batch_override=B, seq_override=S,
                       device="cpu")
    return cfg, batch


def _grads(cfg, batch, mesh=None, microbatches: int = 1) -> tuple:
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_plan
    from repro_torch.models import build
    from repro_torch.train.train_step import make_loss_fn

    bundle = build(cfg)
    model = bundle.init(torch.Generator().manual_seed(0), device="cpu", trainable=True,
                        mesh=mesh)
    plan = None if mesh is None else make_plan(cfg, ShapeConfig("c", S, B, "train"), mesh)
    loss_fn = make_loss_fn(bundle, "ref", "none", plan)
    n = B // microbatches
    for i in range(microbatches):
        loss, _ = loss_fn(model, {k: v[i * n:(i + 1) * n] for k, v in batch.items()})
        (loss / microbatches).backward()
    return model, {n: p.grad.detach() for n, p in model.named_parameters()}


def rank(rank: int, layers: int, f32: bool) -> dict:
    """One rank: its gradients, each gathered whole over the model ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models.tensor_parallel import gather_dim, model_dim

    cfg, batch = _setup(layers, f32)
    mesh = init_device_mesh("cpu", (1, MODEL_RANKS), mesh_dim_names=("data", "model"))
    model, grads = _grads(cfg, batch, mesh)
    tp = model.tp
    return {n: (g if (d := model_dim(tp.specs[n])) is None else gather_dim(g, tp.axis, d))
            .float().numpy() for n, g in grads.items()}


def main() -> None:
    from repro_torch.launch.mesh import spawn_ranks

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--f32", action="store_true",
                    help="the whole model in f32, a dense f32 attention")
    args = ap.parse_args()
    cfg, batch = _setup(args.layers, args.f32)
    _, one = _grads(cfg, batch)
    _, two = _grads(cfg, batch, microbatches=2)
    mesh = spawn_ranks(rank, MODEL_RANKS, backend="gloo", device="cpu", timeout=1200.0,
                       args=(args.layers, args.f32))[0]

    def ulp(x: float) -> float:
        return float(2.0 ** (np.floor(np.log2(abs(x))) - 7))

    def worst(other) -> list:
        return sorted((float(np.abs(np.asarray(other[n], np.float32)
                                    - g.float().numpy()).max())
                       / (8 * ulp(float(g.abs().max()))), n) for n, g in one.items())[-4:]

    print(f"seamless-m4t-large-v2, {args.layers} + {args.layers} layers, full widths, "
          f"{'f32' if args.f32 else 'bf16'}: the largest differences over 8 bf16 ulps "
          f"of a leaf's largest |g|")
    for what, other in (("one device at 2 microbatches", {n: g.float().numpy()
                                                          for n, g in two.items()}),
                        (f"{MODEL_RANKS} model ranks", mesh)):
        print(f"  {what}:")
        for r, n in worst(other):
            print(f"    {n}: {r:.4g}")


if __name__ == "__main__":
    main()
