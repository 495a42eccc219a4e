"""Meshes of the port, the reference's sharding plans, and a launcher of
ranks on one host.

The reference simulates its devices inside one process; PyTorch runs one
process per rank. :func:`spawn_ranks` starts them (forked from a fresh
server process that has imported :data:`RANK_PRELOAD` and never touched
CUDA: a process that has cannot be forked, and one started from nothing
spends seconds importing torch), gives each an initialized process group
(a ``file://`` rendezvous, a timeout on every collective), and returns
what each rank's function returned, or raises if any rank failed or
outlived the limit. Under ``torchrun`` nothing needs starting:
:func:`make_data_mesh` initializes the group from the launch variables.

The trainer's meshes: ``("data",)`` and ``("pod", "data")`` (data ranks),
:func:`make_debug_mesh` ``("data", "model")`` and
:func:`make_production_mesh`'s (16, 16) ``("data", "model")`` and (2,
16, 16) ``("pod", "data", "model")``. :func:`batch_specs` gives the rows
of a batch over ``("pod", "data")``, :func:`make_plan` the reference's
activation plan of a cell (``models.transformer.ShardingPlan``);
:func:`data_axis` and :func:`model_axis` the collective axes. The plans,
``batch_specs`` and ``axis_size`` read only a mesh's dimension names and
sizes, so a :class:`MeshShape` (no process group) stands in for a mesh
of 256 or 512 ranks; a :class:`TracedMesh` is one rank of such a mesh
whose axes record their calls (the dry run's).
"""
from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
import uuid
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core._collectives import Axis, RecordingAxis, release_mailboxes
from repro_torch.core.distributed import check_nccl_ranks, make_data_mesh  # noqa: F401
from repro_torch.models.transformer import ShardingPlan

#: seconds a spawned rank may take, collectives included (each test and
#: phase passes its own)
DEFAULT_TIMEOUT_S = 120.0
#: modules the rank server imports once; every rank starts with them loaded
#: (``torch.utils.checkpoint``, the train step's remat, imports
#: ``torch._dynamo`` at its first call)
RANK_PRELOAD = ("numpy", "torch", "torch.distributed", "torch._dynamo",
                "repro_torch.launch.train", "repro_torch.core.distributed",
                "repro_torch.train")


@dataclass(frozen=True)
class MeshShape:
    """A mesh's dimension names and sizes with no process group behind it
    (what the plans read of a ``DeviceMesh``)."""
    mesh_dim_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def size(self, dim: Optional[int] = None) -> int:
        return int(np.prod(self.sizes)) if dim is None else int(self.sizes[dim])


@dataclass(frozen=True)
class TracedMesh(MeshShape):
    """A mesh's shape seen from its first rank (index 0 on every
    dimension), with no process group: :func:`data_axis` and
    :func:`model_axis` give :class:`RecordingAxis` es over it, which count
    each collective and return a tensor of its shape. ``launch.dryrun``
    traces one rank's step on it, on the "meta" device."""

    def get_local_rank(self, name: str) -> int:
        if name not in self.mesh_dim_names:
            raise ValueError(f"mesh has no dimension {name!r}")
        return 0


def traced_mesh(shape: MeshShape) -> TracedMesh:
    return TracedMesh(shape.mesh_dim_names, shape.sizes)


#: the reference's production meshes (``make_production_mesh``)
PRODUCTION_MESHES = {
    "pod1": MeshShape(("data", "model"), (16, 16)),
    "pod2": MeshShape(("pod", "data", "model"), (2, 16, 16)),
}


def make_production_mesh(*, multi_pod: bool = False, device_type: Optional[str] = None):
    """The reference's production mesh over this process group: (16, 16)
    ``("data", "model")``, or with ``multi_pod`` (2, 16, 16) ``("pod",
    "data", "model")``. The group must have exactly 256 or 512 ranks
    (``torchrun``); :data:`PRODUCTION_MESHES` holds the shapes alone."""
    import torch.distributed as dist

    shape = PRODUCTION_MESHES["pod2" if multi_pod else "pod1"]
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != shape.size():
        raise RuntimeError(
            f"the {'pod2' if multi_pod else 'pod1'} mesh {shape.sizes} needs a "
            f"process group of exactly {shape.size()} ranks (torchrun "
            f"--nproc-per-node ... with {shape.size()} ranks in all); this process "
            f"has {world or 'none'}")
    return _device_mesh(shape, device_type)


def _device_mesh(shape: MeshShape, device_type: Optional[str]):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.runtime import active

    if device_type is None:
        device_type = torch.device(active().device).type
    return init_device_mesh(device_type, shape.sizes,
                            mesh_dim_names=shape.mesh_dim_names)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *,
                    device_type: Optional[str] = None):
    """A small 2-D ``("data", "model")`` mesh over ``n_data · n_model``
    ranks (the process group must have exactly that many)."""
    return _device_mesh(MeshShape(("data", "model"), (n_data, n_model)), device_type)


def data_axes(mesh) -> Tuple[str, ...]:
    """The mesh dimensions the data is split over ("pod", "data")."""
    return tuple(a for a in (mesh.mesh_dim_names or ()) if a in ("pod", "data"))


def axis_size(mesh, axes) -> int:
    """Ranks along ``axes`` (a name, a tuple of names, or None: 1)."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    names = tuple(mesh.mesh_dim_names or ())
    return int(np.prod([mesh.size(names.index(a)) for a in axes]))


def data_axis(mesh) -> Axis:
    """The data ranks of a trainer's mesh as one collective axis (pod-major
    over ``("pod", "data")``; on a mesh with "model", the data ranks of
    this rank's model index)."""
    axes = data_axes(mesh)
    if not axes:
        raise ValueError(f"mesh {tuple(mesh.mesh_dim_names or ())} has no data "
                         f"dimension (pod, data)")
    return _axis(mesh, axes)


def model_axis(mesh) -> Axis:
    """The model ranks of this rank's data index (tensor parallelism)."""
    return _axis(mesh, "model")


def _axis(mesh, names):
    if isinstance(mesh, TracedMesh):
        return RecordingAxis(mesh, names)
    return Axis(mesh, names)


def _entry(names):
    """A spec entry as ``PartitionSpec`` keeps it: None, a name, or a tuple
    of two or more names."""
    if names is None or isinstance(names, str):
        return names
    names = tuple(names)
    return None if not names else names[0] if len(names) == 1 else names


def make_plan(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
              heads_mode: str = "auto") -> ShardingPlan:
    """The reference's activation plan of one (arch x shape x mesh) cell.

    heads_mode, for archs whose query heads do not divide the model ranks:
      auto: attention replicated over "model" (the port gathers q and the
            out projection; the reference leaves it to SPMD propagation);
      seq:  context parallelism, q sequence-sharded over "model" and k/v
            replicated (``plan.kv``; train and prefill): each rank attends
            its chunk of the sequence (``models.tensor_parallel``)."""
    from repro_torch.models.mamba2 import dims

    dp = data_axes(mesh)
    dp_size = axis_size(mesh, dp)
    names = tuple(mesh.mesh_dim_names or ())
    tp_size = axis_size(mesh, "model") if "model" in names else 1
    b = shape.global_batch

    batch_axes = _entry(dp) if (b % dp_size == 0 and b >= dp_size) else None
    heads_ok = cfg.n_heads % tp_size == 0 if cfg.n_heads else False
    kv_ok = cfg.n_kv_heads % tp_size == 0 if cfg.n_kv_heads else False
    kv_spec = None
    if heads_ok:
        heads_spec = (batch_axes, "model", None, None)
    elif heads_mode == "seq" and shape.kind in ("train", "prefill"):
        heads_spec = (batch_axes, None, "model", None)
        kv_spec = (batch_axes, None, None, None)
    else:
        heads_spec = None
    mamba_ok = bool(cfg.ssm_state) and dims(cfg)[1] % tp_size == 0

    if shape.kind == "decode":
        if b == 1:
            seq_axes = _entry(dp + ("model",) if not kv_ok else dp)
            cache = (None, "model" if kv_ok else None, seq_axes, None)
        elif kv_ok:
            cache = (batch_axes, "model", None, None)
        else:
            cache = (batch_axes, None, "model", None)
    else:
        cache = (batch_axes, "model" if kv_ok else None, None, None)

    if cfg.n_experts and cfg.n_experts % tp_size == 0:
        ep = ((batch_axes, "model", None, None) if cfg.moe_groups > 1
              else ("model", None, None))
    elif cfg.n_experts:
        ep = (None, None, None)
    else:
        ep = None
    return ShardingPlan(
        resid=(batch_axes, None, None),
        heads=heads_spec,
        kv=kv_spec,
        mamba_heads=(batch_axes, None, "model" if mamba_ok else None, None),
        ep=ep,
        cache=cache,
        logits=(batch_axes, None, "model"),
    )


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh, *, kind: str) -> dict:
    """The spec of each key of a batch of this cell (a tuple, one entry a
    dimension): its rows over the data axes, or None where the global batch
    does not divide over them (then every rank takes the whole batch). One
    data axis is named alone, as a ``PartitionSpec`` holds it."""
    dp = data_axes(mesh)
    dp_size = axis_size(mesh, dp)
    b = shape.global_batch
    bx = _entry(dp) if (b % dp_size == 0 and b >= dp_size) else None
    specs = {"tokens": (bx, None)}
    if kind == "train":
        specs["labels"] = (bx, None)
    if cfg.frontend == "vision" and kind != "decode":
        specs["patch_embeds"] = (bx, None, None)
    if cfg.frontend == "audio" and kind != "decode":
        specs["frames"] = (bx, None, None)
    return specs


def start_rank_server() -> None:
    """Start the server that :func:`spawn_ranks` forks its ranks from, if it
    is not running yet (it imports :data:`RANK_PRELOAD` in the background;
    a caller may start it early to hide that)."""
    import multiprocessing.forkserver as forkserver

    import torch.multiprocessing as mp

    mp.get_context("forkserver").set_forkserver_preload(list(RANK_PRELOAD))
    forkserver.ensure_running()


def stop_rank_server() -> None:
    """Stop the rank server if this process started one (it would end with
    this process too, a moment after it)."""
    import multiprocessing.forkserver as forkserver

    forkserver._forkserver._stop()  # the standard library's own stop


def _rank_main(fn, rank: int, world: int, backend: str, device: str,
               rendezvous: str, timeout: float, args: Sequence[Any], results) -> None:
    import torch.distributed as dist

    try:
        dist.init_process_group(backend, init_method=f"file://{rendezvous}",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        out = fn(rank, *args)
        release_mailboxes()
        results.put((rank, "ok", out))
    except BaseException:  # noqa: BLE001 — reported to the parent
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(
    fn: Callable[..., Any],
    nprocs: int,
    *,
    backend: str = "gloo",
    device: str = "cpu",
    init_dir: Optional[str] = None,
    args: Sequence[Any] = (),
    timeout: float = DEFAULT_TIMEOUT_S,
) -> List[Any]:
    """Run ``fn(rank, *args)`` in ``nprocs`` fresh processes joined by one
    process group over ``backend``; returns the ranks' results in rank
    order.

    ``fn`` must be importable by name (defined at a module's top level) and
    its result picklable. The ranks are forked from the rank server
    (:func:`start_rank_server`). ``device`` "cuda" puts rank r on card ``r %
    cards`` (every rank on cuda:0 with one card; NCCL with more ranks than
    cards raises here, before anything starts). The rendezvous file lives
    in ``init_dir`` (default: a fresh temporary directory, removed after).
    ``timeout`` bounds every collective and the whole run: a rank still
    alive then is killed and the call raises, as it does when any rank
    raises or dies (the other ranks are stopped at once)."""
    import torch.multiprocessing as mp

    if nprocs < 1:
        raise ValueError(f"spawn_ranks: nprocs={nprocs}")
    if backend == "nccl":
        check_nccl_ranks(nprocs, torch.device(device).type)
    own_dir = init_dir is None
    work = tempfile.mkdtemp(prefix="repro-torch-ranks-") if own_dir else init_dir
    rendezvous = os.path.join(work, f"rendezvous-{uuid.uuid4().hex}")
    start_rank_server()
    ctx = mp.get_context("forkserver")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, nprocs, backend, str(device), rendezvous,
                               timeout, tuple(args), results))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    got, errors = {}, {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) + len(errors) < nprocs and time.monotonic() < deadline:
            try:
                rank, status, payload = results.get(timeout=0.5)
            except queue.Empty:
                for r, p in enumerate(procs):  # a rank that died unreported
                    if (p.exitcode not in (None, 0) and r not in got
                            and r not in errors):
                        errors[r] = f"exited with code {p.exitcode}"
                if errors:
                    break
                continue
            if status == "ok":
                got[rank] = payload
            else:
                errors[rank] = payload
                break  # the others may wait on a collective with it: stop them
    finally:
        stop = errors or len(got) < nprocs
        for p in procs:
            if stop and p.is_alive():
                p.kill()
            p.join(timeout=max(1.0, deadline - time.monotonic()) if not stop else 10.0)
            if p.is_alive():
                p.kill()
                p.join(10.0)
        results.close()
        if own_dir:
            shutil.rmtree(work, ignore_errors=True)
        elif os.path.exists(rendezvous):
            os.remove(rendezvous)
    if errors:
        text = "\n".join(f"rank {r}: {e}" for r, e in sorted(errors.items()))
        raise RuntimeError(f"spawn_ranks: {len(errors)} of {nprocs} ranks "
                           f"failed\n{text}")
    if len(got) < nprocs:
        missing = sorted(set(range(nprocs)) - set(got))
        raise RuntimeError(f"spawn_ranks: ranks {missing} did not finish "
                           f"within {timeout} s; killed")
    for r, p in enumerate(procs):
        if p.exitcode not in (0, None):
            raise RuntimeError(f"spawn_ranks: rank {r} exited with code "
                               f"{p.exitcode} after reporting")
    return [got[r] for r in range(nprocs)]
