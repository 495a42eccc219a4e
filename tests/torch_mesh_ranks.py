"""Rank functions of tests/test_torch_train_mesh.py.

``repro_torch.launch.mesh.spawn_ranks`` starts each rank in a fresh
process and calls one of these by name, so they live in a module that
imports neither jax nor the JAX package. Each returns host numpy arrays;
the test compares them with the one-device port and the reference in its
own process.
"""
import numpy as np
import torch

torch.set_num_threads(1)

#: the smoke trainer's schedule and batch (tests/test_torch_train.py)
SCHED = dict(peak_lr=1e-2, warmup_steps=5, decay_steps=60)
B, S = 8, 32
METRICS = ("loss", "grad_norm", "lr", "weight", "aux_loss", "total_loss")
#: the launcher's run in the test of its mesh path (both sides)
LAUNCHER_KW = dict(seq=16, batch=4, device="cpu", on_metrics=None,
                   opt_cfg=None)


def _np(t):
    """A host copy (bf16 widened to f32: exact, so equality still holds)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def _setup(init_tree, *, master=False):
    """The smoke gemma2-2b model carried from the reference's initial
    parameters (bf16 matrices under ``master``, norms in f32)."""
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.models import build
    from repro_torch.models.convert import params_from_tree

    cfg = smoke_config(ARCHS["gemma2-2b"])
    model = params_from_tree(cfg, init_tree, device="cpu", trainable=True)
    if master:
        with torch.no_grad():
            for n, p in model.named_parameters():
                if "ln" not in n:
                    p.data = p.data.to(torch.bfloat16)
    return cfg, build(cfg), model


def batch_for(cfg, batch: int = B):
    from repro_torch.configs import SHAPES
    from repro_torch.data import make_batch

    return lambda step: make_batch(cfg, SHAPES["train_4k"], step,
                                   batch_override=batch, seq_override=S)


def full_moments(opt, model, mesh, specs):
    """Every moment (and master copy) whole, gathered from the ranks'
    shards in rank order."""
    from repro_torch.launch.mesh import data_axis
    from repro_torch.train.optimizer import gather_shards, local_shard, mesh_coords

    axis, coords = data_axis(mesh), mesh_coords(mesh)
    named = dict(model.named_parameters())
    out = {}
    for key in [k for k in ("m", "v", "master") if k in opt]:
        out[key] = {}
        for n, t in opt[key].items():
            full = torch.zeros(named[n].shape, dtype=t.dtype)
            local_shard(full, specs[key][n], coords).copy_(t)
            gather_shards(full, specs[key][n], axis)
            out[key][n] = _np(full)
    return out


def _record(mets):
    return {k: np.asarray(_np(mets[k])) for k in METRICS}


def mesh_run(rank, job):
    """One data-parallel run on this rank: ``job`` names the mesh
    (``shape``, ``names``), ``steps``, ``microbatches``, ``zero_stage``,
    ``master``, ``batch``, an optional ``restore`` step of ``ckpt_dir``
    (the elastic restore), ``ckpt_every`` into ``ckpt_dir`` and a
    ``fail_at`` step that fails once on every rank; ``mailboxes``
    (directory, bytes) sends the copies through host mailboxes. Returns the
    per-step metrics, the final weights, the whole moments and the
    retries."""
    from repro_torch.configs import ParallelConfig
    from repro_torch.train import (CheckpointManager, OptConfig, init_opt_state,
                                   make_train_step, mesh_opt_specs)
    from repro_torch.train.fault_tolerance import run_training

    if job.get("mailboxes"):
        from repro_torch.core._collectives import use_host_mailboxes

        use_host_mailboxes(*job["mailboxes"])
    mesh = _mesh(job["shape"], job["names"])
    cfg, bundle, model = _setup(job["init"], master=job.get("master", False))
    parallel = ParallelConfig(remat="none", microbatches=job.get("microbatches", 1),
                              zero_stage=job.get("zero_stage", 1))
    specs = mesh_opt_specs(model, mesh, zero_stage=parallel.zero_stage,
                           master=job.get("master", False))
    opt = init_opt_state(model, master=job.get("master", False), mesh=mesh,
                         specs=specs)
    step = make_train_step(bundle, OptConfig(**SCHED), parallel, mesh=mesh)
    start = 0
    ckpt = CheckpointManager(job["ckpt_dir"]) if job.get("ckpt_dir") else None
    if job.get("restore"):
        start = job["restore"]
        state = ckpt.restore(start, {"params": model, "opt": opt}, mesh=mesh,
                             specs={"opt": specs})
        model, opt = state["params"], state["opt"]
    fail_at = job.get("fail_at")
    hook = (None if fail_at is None
            else (lambda s, attempt: s == fail_at and attempt == 0))
    mets = []
    model, opt, stats = run_training(
        train_step=step, init_state=(model, opt),
        batch_for_step=batch_for(cfg, job.get("batch", B)), n_steps=job["steps"],
        start_step=start, ckpt=ckpt, ckpt_every=job.get("ckpt_every", 0),
        guard_kwargs={"failure_hook": hook}, on_metrics=lambda s, m: mets.append(_record(m)),
        mesh=mesh, opt_specs=specs)
    local_shapes = {n: tuple(t.shape) for n, t in opt["m"].items()}
    return dict(rank=rank, mets=mets, retries=stats.retries,
                params={n: _np(p) for n, p in model.named_parameters()},
                moments=full_moments(opt, model, mesh, specs), step=int(opt["step"]),
                local_shapes=local_shapes)


def mailbox_ops(rank, job):
    """Every copy of ``Axis`` over ``job["ranks"]`` gloo ranks on this rank's
    seeded inputs, through gloo and then through host mailboxes of
    ``job["nbytes"]`` in ``job["dir"]``: both results of each op, and what
    went through the mailboxes."""
    from repro_torch.core import _collectives as col

    mesh = _mesh((job["ranks"],), ("data",))
    axis = col.Axis(mesh, "data")
    g = torch.Generator().manual_seed(100 + rank)
    x = torch.randn(axis.size * 37, generator=g) * 10.0 ** torch.randint(-3, 4, (1,), generator=g)
    rows = torch.randint(-9, 9, (3, 5), generator=g, dtype=torch.int64)
    flags = torch.rand(7, generator=g) > 0.5

    def ops():
        return {"sum_scatter": axis.sum_scatter(x),
                "gather_rows": axis.gather_rows(rows),
                "gather_rows_bool": axis.gather_rows(flags),
                "gather_rows_f32": axis.gather_rows(x.view(axis.size, 37)),
                "broadcast": axis.broadcast(rows, src=axis.size - 1),
                "ring_shift": axis.ring_shift(x)}

    plain = ops()
    col.reset_staging_counts()
    col.use_host_mailboxes(job["dir"], job["nbytes"])
    via = ops()
    ipc = col.ipc_counts()
    col.release_mailboxes()
    col.use_host_mailboxes(None)
    return dict(rank=rank, ipc=ipc,
                plain={k: _np(v) for k, v in plain.items()},
                via={k: _np(v) for k, v in via.items()})


def compress_run(rank, job):
    """The int8 error-feedback collectives on this rank's row of ``x``
    over a 1-D ``("pod",)`` mesh: the one-shot mean, 16 rounds of
    ``psum_with_error_feedback`` (every round's mean and error) and
    ``tree_compressed_psum`` of a two-leaf tree."""
    from repro_torch.train.compression import (compressed_psum,
                                               psum_with_error_feedback,
                                               tree_compressed_psum)

    mesh = _mesh((job["ranks"],), ("pod",))
    x = torch.from_numpy(job["x"][rank:rank + 1])
    out = {"rank": rank, "one_shot": _np(compressed_psum(x, "pod", mesh=mesh))}
    err = torch.zeros_like(x)
    rounds = []
    for _ in range(job["rounds"]):
        o, err = psum_with_error_feedback(x, err, "pod", mesh=mesh)
        rounds.append((_np(o), _np(err)))
    out["rounds"] = rounds
    tree = {"b": x * 3.0, "a": [x, x[:, :64] - 1.0]}
    errs = {"b": torch.zeros_like(x), "a": [torch.full_like(x, 0.01),
                                            torch.zeros_like(x[:, :64])]}
    means, new_errs = tree_compressed_psum(tree, errs, "pod", mesh=mesh)
    out["tree"] = (_np(means["b"]), _np(means["a"][0]), _np(means["a"][1]),
                   _np(new_errs["b"]), _np(new_errs["a"][0]), _np(new_errs["a"][1]))
    return out


def launcher_run(rank, job):
    """``launcher.train`` under ``runtime.configure(mesh=)``: 2 steps with a
    checkpoint, then a resume to step 4 at one microbatch a rank."""
    import os

    from repro_torch import runtime
    from repro_torch.configs import ARCHS, SHAPES, smoke_config
    from repro_torch.launch import train as launcher
    from repro_torch.train import CheckpointManager

    mesh = _mesh(job["shape"], job["names"])
    cfg = smoke_config(ARCHS["gemma2-2b"])
    kw = dict(LAUNCHER_KW, ckpt_dir=job["ckpt_dir"], ckpt_every=2)
    with runtime.configure(mesh=mesh):
        launcher.train(cfg, SHAPES["train_4k"], steps=2, **kw)
        model, _, _, start = launcher.train(cfg, SHAPES["train_4k"], steps=4,
                                            resume=True, **kw)
    assert os.path.isdir(job["ckpt_dir"])
    return dict(rank=rank, start=start,
                latest=CheckpointManager(job["ckpt_dir"]).latest_step(),
                params={n: _np(p) for n, p in model.named_parameters()})


def rank_jobs(rank, jobs):
    """Several jobs in one spawn, in order: ``launcher_run`` for a job of
    kind "launcher", else ``mesh_run``."""
    return [launcher_run(rank, j) if j.get("kind") == "launcher" else mesh_run(rank, j)
            for j in jobs]
