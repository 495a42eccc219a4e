"""Rank functions of tests/test_torch_tp.py (the model axis on gloo ranks).

``repro_torch.launch.mesh.spawn_ranks`` starts each rank in a fresh
process and calls :func:`tp_jobs` by name, so it lives in a module that
imports neither jax nor the JAX package. Each job returns host numpy
arrays; the test holds them against the port's one-device paths in its own
process. The helpers here (:func:`train_run`, :func:`forced_route`) serve
both sides: with ``mesh=None`` they are the one-device oracle (the test
holds both against the reference as well). :func:`serve_inputs` makes the
prompts the test's reference route takes too.
"""
import numpy as np
import torch

torch.set_num_threads(1)

#: the smoke trainer's schedule (tests/test_torch_train.py)
SCHED = dict(peak_lr=1e-2, warmup_steps=5, decay_steps=60)
B, S = 8, 32
METRICS = ("loss", "grad_norm", "lr", "weight", "total_loss")
#: the serving check: rows, prompt, cache room, forced decode steps, the
#: compression (t, m, tail)
SERVE = dict(batch=4, prompt=40, steps=6, t=2, m=1, tail=8)


def _np(t):
    """A host copy (bf16 widened to f32: exact, so equality still holds)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def mesh_of(shape):
    """(data, model) or (pod, data, model) ranks on the CPU."""
    from torch.distributed.device_mesh import init_device_mesh

    names = ("pod", "data", "model")[-len(shape):]
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=names)


def model_of(cfg, tree, *, trainable, mesh=None):
    """The reference's parameters in a port model, sliced for this rank of
    ``mesh``'s model dimension."""
    from repro_torch.models.convert import params_from_tree
    from repro_torch.models.tensor_parallel import shard_model

    model = params_from_tree(cfg, tree, device="cpu", trainable=trainable)
    return model if mesh is None else shard_model(model, mesh)


def whole(t, name, model):
    """A rank's parameter or gradient ``t`` gathered whole over the model
    ranks (itself on one device or where it is replicated)."""
    from repro_torch.models.tensor_parallel import gather_dim, model_dim

    tp = getattr(model, "tp", None)
    d = None if tp is None else model_dim(tp.specs.get(name))
    return t if d is None else gather_dim(t, tp.axis, d)


def train_run(cfg, tree, steps, *, mesh=None, microbatches=1, ckpt_dir="",
              restore_dir=""):
    """``steps`` train steps at b 8, s 32, remat "block": every step's
    metrics, the step-0 gradients and the final weights (whole), and on a
    mesh each rank's own bits of its replicated leaves; ``ckpt_dir``: a
    checkpoint after the last step; ``restore_dir``: the weights restored
    from its step-``steps`` checkpoint before training (then no steps)."""
    from repro_torch.configs import SHAPES, ParallelConfig
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_batch
    from repro_torch.launch.mesh import make_plan
    from repro_torch.models import build
    from repro_torch.train import (CheckpointManager, OptConfig, init_opt_state,
                                   make_train_step, mesh_opt_specs)

    bundle = build(cfg)
    model = model_of(cfg, tree, trainable=True, mesh=mesh)
    plan = specs = None
    if mesh is not None:
        plan = make_plan(cfg, ShapeConfig("tp", S, B, "train"), mesh)
        specs = mesh_opt_specs(model, mesh)
    opt = init_opt_state(model, mesh=mesh, specs=specs)
    out = {}
    if restore_dir:
        got = CheckpointManager(restore_dir).restore(
            steps, {"params": model, "opt": opt}, mesh=mesh,
            specs={"opt": specs} if mesh is not None else None)
        model = got["params"]
        out["local"] = {n: _np(p) for n, p in model.named_parameters()}
        return out
    step = make_train_step(bundle, OptConfig(**SCHED),
                           ParallelConfig(remat="block", microbatches=microbatches),
                           mesh=mesh, plan=plan)
    mets = []
    for s in range(steps):
        batch = make_batch(cfg, SHAPES["train_4k"], s, batch_override=B, seq_override=S,
                           device="cpu")
        model, opt, m = step(model, opt, batch)
        mets.append({k: float(m[k]) for k in METRICS})
        if s == 0:
            out["grads0"] = {n: _np(whole(p.grad, n, model))
                             for n, p in model.named_parameters()}
    out["mets"] = mets
    tp = getattr(model, "tp", None)
    if tp is not None:
        from repro_torch.models.tensor_parallel import model_dim

        out["replicated"] = {n: _np(p) for n, p in model.named_parameters()
                             if model_dim(tp.specs[n]) is None}
    if ckpt_dir:
        CheckpointManager(ckpt_dir).save(steps, {"params": model, "opt": opt},
                                         mesh=mesh, specs={"opt": specs})
    if tp is not None:
        from repro_torch.models.tensor_parallel import gather_params

        gather_params(model)
    out["params"] = {n: _np(p) for n, p in model.named_parameters()}
    return out


def serve_inputs(cfg):
    """SERVE's seeded prompts (n, prompt), forced tokens (n, steps) and, for
    the VLM, the stubbed patch prefix (n, 256, d) in f32 (bf16 values)."""
    from repro_torch.models.frontends import VISION_PREFIX_TOKENS

    rng = np.random.default_rng(7)
    n, p = SERVE["batch"], SERVE["prompt"]
    prompts = rng.integers(0, cfg.vocab_size, (n, p))
    forced = rng.integers(0, cfg.vocab_size, (n, SERVE["steps"]))
    patches = None
    if cfg.frontend == "vision":
        patches = torch.from_numpy(rng.standard_normal(
            (n, VISION_PREFIX_TOKENS, cfg.d_model)).astype(np.float32)).bfloat16()
        patches = patches.float().numpy()
    return prompts, forced, patches


def forced_route(cfg, tree, *, mesh=None):
    """Prefill SERVE's prompts (seeded), compress the caches once, then
    ``steps`` teacher-forced decode steps: the last position's logits of
    the prefill and of each step (b, vocab), whole, and this rank's raw
    and compressed caches with the rows and kv heads they hold (None: all
    the kv heads)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import data_axis, make_plan
    from repro_torch.models import build
    from repro_torch.models.tensor_parallel import gather_dim
    from repro_torch.serve.kv_compression import compress_model_caches

    n, p = SERVE["batch"], SERVE["prompt"]
    prompts, forced, patches = serve_inputs(cfg)
    prompts, forced = torch.from_numpy(prompts), torch.from_numpy(forced)
    inputs = {}
    if patches is not None:  # the stubbed patch prefix, bf16
        inputs["patch_embeds"] = torch.from_numpy(patches).bfloat16()
    bundle = build(cfg)
    model = model_of(cfg, tree, trainable=False, mesh=mesh)
    tp = getattr(model, "tp", None)
    plan, rows, lo, tp_size = None, None, 0, 1
    if mesh is not None:
        plan = make_plan(cfg, ShapeConfig("tp", p, n, "decode"), mesh)
        rows = data_axis(mesh)
        per = n // rows.size
        lo = rows.index * per
        prompts, forced = prompts[lo:lo + per], forced[lo:lo + per]
        inputs = {k: v[lo:lo + per] for k, v in inputs.items()}
        tp_size = tp.size if tp is not None else 1

    def full(logits):
        x = logits[:, -1:]
        if tp is not None:
            x = gather_dim(x, tp.axis, 2)
        x = x[:, 0].float()
        return x if rows is None else rows.gather_rows(x)

    with torch.inference_mode():
        caches = bundle.init_caches(prompts.shape[0], p + SERVE["steps"], device="cpu",
                                    tp_size=tp_size)
        logits, caches = bundle.prefill(model, caches, {"tokens": prompts, **inputs},
                                        plan=plan)
        out = [full(logits)]
        raw = [{k: _np(c[k]) for k in ("k", "v")} | {"pos": c["pos"]}
               for c in caches["layers"]]
        caches = compress_model_caches(caches, SERVE["t"], SERVE["m"], tail=SERVE["tail"])
        kept = [{k: _np(c[k]) for k in ("k", "v", "mass")} | {"pos": c["pos"]}
                for c in caches["layers"]]
        for i in range(SERVE["steps"]):
            logits, caches = bundle.decode_step(model, caches,
                                                {"tokens": forced[:, i:i + 1]}, plan=plan)
            out.append(full(logits))
    heads = None
    if tp is not None and tp.kv_local:
        per_h = cfg.n_kv_heads // tp.size
        heads = (tp.index * per_h, (tp.index + 1) * per_h)
    return {"logits": [_np(x) for x in out], "caches": kept,
            "raw": {"layers": raw, "n_prefix": caches["n_prefix"],
                    "period": caches["period"]},
            "rows": (lo, lo + prompts.shape[0]), "heads": heads}


def drawn(cfg, *, trainable, mesh=None):
    """The model drawn from seed 11 (``bundle.init``; on ``mesh``, this
    rank's slices drawn one leaf at a time): {name: host array}."""
    from repro_torch.models import build

    model = build(cfg).init(torch.Generator().manual_seed(11), device="cpu",
                            trainable=trainable, mesh=mesh)
    return {n: _np(p) for n, p in model.named_parameters()}


def tp_jobs(rank, jobs):
    """Every job of ``jobs`` in order on this rank: ``{"kind": "train" |
    "serve" | "init", "shape": ([pod,] data, model), "cfg", "tree", ...}``
    (train: ``steps``, ``ckpt_dir``, ``restore_dir``; init: ``trainable``,
    no tree); ``mailboxes`` (directory, bytes) of the
    first job sends the copies through host mailboxes, as ranks sharing a
    card do."""
    from repro_torch.core._collectives import use_host_mailboxes

    if jobs and jobs[0].get("mailboxes"):
        use_host_mailboxes(*jobs[0]["mailboxes"])
    meshes, outs = {}, []
    for job in jobs:
        shape = tuple(job["shape"])
        if shape not in meshes:
            meshes[shape] = mesh_of(shape)
        mesh = meshes[shape]
        if job["kind"] == "train":
            res = train_run(job["cfg"], job["tree"], job["steps"], mesh=mesh,
                            ckpt_dir=job.get("ckpt_dir", ""),
                            restore_dir=job.get("restore_dir", ""))
        elif job["kind"] == "init":
            res = {"local": drawn(job["cfg"], trainable=job["trainable"], mesh=mesh)}
        else:
            res = forced_route(job["cfg"], job["tree"], mesh=mesh)
        outs.append(dict(res, rank=rank, coords={a: int(mesh.get_local_rank(a))
                                                 for a in mesh.mesh_dim_names}))
    return outs
