"""Sharded ITIS / IHTC over the ``data`` dimension of a device mesh — the
port of ``repro.core.distributed`` on ``torch.distributed``.

One process per rank. Every rank calls ``repro_torch.fit(x, t, m,
"kmeans", mesh=mesh)`` with the same global ``x``; it keeps only its
contiguous block of rows on its device, and every rank gets back the same
:class:`~repro_torch.core.plan.FitResult`. Each ITIS level:

  1. **TC** — the kNN graph by :func:`repro_torch.core.knn.ring_knn` (key
    blocks travel the ring; K1 folds each into the running lists); the
    Luby MIS of :func:`repro_torch.core.tc.luby_mis_rounds` with a
    cross-rank closed 2-hop max (each rank scatters its (n_local, k) edge
    slice, an integer ``pmax`` combines them: exact, order-free); the grow
    step the same way; leftover units go to their nearest seed through a
    replicated seed-coordinate table (a ``psum`` of disjoint one-hot rows)
    for out-edges and a second ring pass of the point blocks for in-edges,
    so each edge's distance is taken where the edge lives, combined by an
    exact ``pmin``/``pmax``. Only O(n) label/priority vectors and the
    O(n/t · d) seed table are replicated; points and graph stay sharded.
  2. **Reduce** — each rank forms its ``n_blocks / P`` block partials with
    K3, the stack is all-gathered and folded left to right in block order:
    bitwise ``ops.blocked_segment_sum(n_blocks=...)`` over the
    concatenated rows. Each rank then keeps its contiguous slice of the
    replicated result as the next level's rows.
  3. **Backend** — :func:`kmeans_sharded`: centres replicated, rows
    sharded, k-means++ from all-gathered logits, distances by K4, Lloyd
    statistics by the same K3 fold.

Determinism (the reference's DESIGN.md §4.3): every cross-rank step is an
exact operation or the canonical block fold, so where the level sizes of
:func:`repro_torch.core.itis.level_sizes` already divide by the shard
multiple the sharded fit gives the memory executor's bits: labels,
prototypes, masses. Scatter-max and scatter-min (``scatter_reduce_``
"amax"/"amin") are exact on the card; nothing here adds floats in an order
the data decides.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import prng
from repro_torch.cluster.kmeans import KMeansResult
from repro_torch.cluster.registry import BackendFn
from repro_torch.core._collectives import Axis
from repro_torch.core.itis import (ITISLevelOut, ITISResult, level_sizes,
                                   validate_reduction_params)
from repro_torch.core.knn import ring_knn
from repro_torch.core.plan import (FitPlan, FitResult, Reduction, fit,
                                   register_executor)
from repro_torch.core.tc import TCResult, _NEG, luby_mis_rounds, seed_priorities
from repro_torch.kernels import ops
from repro_torch.runtime import active, resolve_device, torchrun_env


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


def check_nccl_ranks(world: int, device_type: str) -> None:
    """Raise unless NCCL can run ``world`` ranks: it takes one rank a card
    and refuses two on one ("Duplicate GPU detected"). Ranks that share a
    card run over gloo (``backend="gloo"``); nothing switches by itself."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device_type != "cuda":
        raise ValueError(f"backend 'nccl' moves CUDA tensors; the mesh's "
                         f"device type is {device_type!r} (use gloo)")
    if world > cards:
        raise ValueError(
            f"backend 'nccl' takes one rank a card: {world} ranks on {cards} "
            f"card(s) would put two ranks on one device, which NCCL refuses "
            f"(Duplicate GPU detected); run them over backend='gloo' (CUDA "
            f"tensors staged through host memory) or start one rank a card")


def make_data_mesh(n_data: Optional[int] = None, *, backend: Optional[str] = None,
                   device_type: Optional[str] = None):
    """The 1-D ``("data",)`` ``DeviceMesh`` over every rank of the default
    process group.

    Needs an initialized process group, or a ``torchrun`` launch (then it
    initializes one from the launch variables, over ``backend``: default
    "nccl" for CUDA, "gloo" for the CPU). ``backend`` names the group's
    backend when it is already up, and a mismatch raises. ``device_type``
    defaults to the runtime config's device. ``n_data`` must be the world
    size when given (the reference's first ``n_data`` devices; a mesh over
    some ranks only would leave the others outside every collective).
    NCCL with more ranks than cards raises (:func:`check_nccl_ranks`)."""
    from torch.distributed.device_mesh import init_device_mesh

    if device_type is None:
        device_type = torch.device(active().device).type
    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available in this build")
    if not dist.is_initialized():
        env = torchrun_env()
        if "RANK" not in env or "WORLD_SIZE" not in env:
            raise RuntimeError(
                "make_data_mesh needs an initialized process group: call "
                "torch.distributed.init_process_group in every rank, launch "
                "under torchrun, or start the ranks with "
                "repro_torch.launch.mesh.spawn_ranks")
        if backend is None:
            backend = "nccl" if device_type == "cuda" else "gloo"
        if backend == "nccl":
            check_nccl_ranks(int(env["WORLD_SIZE"]), device_type)
        dist.init_process_group(backend, init_method="env://")
    have = str(dist.get_backend())
    if backend is not None and backend != have:
        raise ValueError(f"make_data_mesh: backend {backend!r} asked for, but "
                         f"the process group runs {have!r}")
    world = dist.get_world_size()
    if have == "nccl":
        check_nccl_ranks(world, device_type)
    if n_data is not None and n_data != world:
        raise ValueError(f"make_data_mesh: n_data={n_data}, but the process "
                         f"group has {world} ranks; a data mesh spans them all")
    return init_device_mesh(device_type, (world,), mesh_dim_names=("data",))


def _axis(mesh, axis_name: Optional[str]) -> Axis:
    return Axis(mesh, active().axis_name if axis_name is None else axis_name)


def _local_rows(a: torch.Tensor, axis: Axis) -> torch.Tensor:
    """This rank's contiguous block of a replicated (n, ...) vector."""
    per = a.shape[0] // axis.size
    return a[axis.index * per:(axis.index + 1) * per]


# ---------------------------------------------------------------------------
# sharded TC
# ---------------------------------------------------------------------------


def tc_sharded(
    x_local: torch.Tensor,
    valid_local: torch.Tensor,
    t: int,
    key: torch.Tensor,
    *,
    axis: Axis,
    impl: Optional[str] = None,
    knn_route: Optional[str] = None,
) -> TCResult:
    """TC on row-sharded points: the function
    :func:`repro_torch.core.tc.threshold_clustering` computes on the
    concatenated rows (same graph, MIS rounds and tie rules), with
    ``labels``, ``seed_of`` and ``is_seed`` replicated (n,) vectors."""
    cfg = active()
    impl = cfg.impl if impl is None else impl
    n_local, d = x_local.shape
    dev = x_local.device
    p = axis.size
    n = n_local * p
    row0 = axis.index * n_local
    rows = row0 + torch.arange(n_local, dtype=torch.int64, device=dev)
    valid_local = valid_local.bool()
    valid = axis.gather_rows(valid_local)  # (n,) replicated

    if t <= 1:  # degenerate: singletons
        labels = torch.where(valid, torch.cumsum(valid.long(), 0) - 1, -1)
        seed_of = torch.where(valid, torch.arange(n, device=dev), -1)
        return TCResult(labels.to(torch.int32), seed_of.to(torch.int32), valid,
                        valid.sum().to(torch.int32), 0)

    k = t - 1
    _, idx = ring_knn(x_local, k, axis=axis, valid=valid_local, impl=impl,
                      route=knn_route)
    idx = torch.where(valid_local[:, None], idx.to(torch.int64), -1)  # invalid rows: no out-edges
    idx_ok = idx >= 0
    safe = torch.where(idx_ok, idx, 0)
    flat = safe.reshape(-1)

    def scatter_max(part: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
        return part.scatter_reduce_(0, flat, vals.reshape(-1), "amax",
                                    include_self=True)

    def push_max(pvec: torch.Tensor) -> torch.Tensor:
        # max over undirected neighbours from this rank's directed edge
        # slice (out-edges gathered, in-edges scattered), combined across
        # ranks by an integer pmax (priorities < n fit int32 on the wire)
        out_max = torch.where(idx_ok, pvec[safe], _NEG).amax(dim=1)
        part = torch.full((n,), _NEG, dtype=pvec.dtype, device=dev)
        part[rows] = out_max
        scatter_max(part, torch.where(idx_ok, pvec[rows][:, None], _NEG))
        return axis.pmax(part.to(torch.int32)).to(pvec.dtype)

    def closed2(pvec: torch.Tensor) -> torch.Tensor:
        q1 = torch.maximum(pvec, push_max(pvec))
        return torch.maximum(q1, push_max(q1))

    priorities = seed_priorities(key, n, device=dev)  # replicated; as on one device
    is_seed, rounds = luby_mis_rounds(priorities, valid, closed2)

    # ---- grow: each vertex adjacent to a seed joins that seed
    n_arange = torch.arange(n, dtype=torch.int64, device=dev)
    out_lab = torch.where(idx_ok & is_seed[safe], safe, _NEG).amax(dim=1)
    part = torch.full((n,), _NEG, dtype=torch.int64, device=dev)
    part[rows] = out_lab
    scatter_max(part, torch.where(idx_ok & is_seed[rows][:, None], rows[:, None], _NEG))
    seed_of = axis.pmax(part)
    seed_of = torch.where(is_seed, n_arange, seed_of)

    # ---- leftovers (graph distance 2): the nearest seed
    labeled = seed_of >= 0
    seed_rank = torch.cumsum(is_seed.long(), 0) - 1
    n_seed_max = max(n // t, 1)  # TC: at most n/t disjoint clusters of size >= t
    # replicated seed-coordinate table: each seed row is written by its owner
    # alone, so the psum adds zeros to it (row n_seed_max stays zero)
    stbl = torch.zeros((n_seed_max + 1, d), dtype=torch.float32, device=dev)
    mine = is_seed[rows]
    stbl[seed_rank[rows][mine]] = x_local[mine].float()
    stbl = axis.psum(stbl)

    def seed_coord(sv: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
        r = torch.where(ok, seed_rank[torch.where(ok, sv, 0)], n_seed_max)
        return stbl[r]

    xf = x_local.float()
    # out-direction: my rows against their out-neighbours' seeds
    cand_out = torch.where(idx_ok, seed_of[safe], _NEG)             # (nl, k)
    cand_ok = cand_out >= 0
    d_out = torch.where(
        cand_ok,
        torch.sum(torch.square(xf[:, None, :] - seed_coord(cand_out, cand_ok)),
                  dim=-1),
        torch.inf)
    best_out_d = d_out.amin(dim=1)
    best_out_s = torch.where(
        torch.isfinite(best_out_d),
        torch.gather(cand_out, 1, torch.argmin(d_out, dim=1, keepdim=True))[:, 0],
        _NEG)

    # in-direction: edge (v -> i) offers seed_of[v] at ||x_i - x_seed||²;
    # x_i lives on i's rank, so the point blocks travel the ring once more
    # and each edge is measured where it lives
    s_v = seed_of[rows][:, None].expand_as(idx)                      # (nl, k)
    edge_ok = idx_ok & (s_v >= 0)
    c_coord = seed_coord(s_v, edge_ok)                               # (nl, k, d)
    d_edge = torch.full(idx.shape, torch.inf, dtype=torch.float32, device=dev)
    xblk = x_local
    for s in range(p):
        blk = (axis.index + s) % p  # owner of the visiting block
        in_blk = edge_ok & (safe // n_local == blk)
        pos = torch.where(in_blk, safe - blk * n_local, 0)
        de = torch.sum(torch.square(xblk[pos].float() - c_coord), dim=-1)
        d_edge = torch.where(in_blk, de, d_edge)
        if s + 1 < p:
            xblk = axis.ring_shift(xblk)

    # one pmin for both directions' distances, then one pmax for the seeds
    part_d = torch.full((2, n), torch.inf, dtype=torch.float32, device=dev)
    part_d[0].scatter_reduce_(0, flat, torch.where(edge_ok, d_edge, torch.inf).reshape(-1),
                              "amin", include_self=True)
    part_d[1][rows] = best_out_d
    d_in, pd = axis.pmin(part_d)
    winners = edge_ok & (d_edge <= d_in[safe])
    part_s = torch.full((2, n), _NEG, dtype=torch.int64, device=dev)
    part_s[0].scatter_reduce_(0, flat, torch.where(winners, s_v, _NEG).reshape(-1),
                              "amax", include_self=True)
    part_s[1][rows] = best_out_s
    s_in, ps = axis.pmax(part_s)

    use_out = pd <= d_in
    fallback = torch.where(use_out, ps, s_in)
    seed_of = torch.where(labeled, seed_of, fallback)
    seed_of = torch.where(valid, seed_of, _NEG)

    has = seed_of >= 0
    labels = torch.where(has, seed_rank[torch.where(has, seed_of, 0)], _NEG)
    return TCResult(labels.to(torch.int32), seed_of.to(torch.int32), is_seed,
                    is_seed.sum().to(torch.int32), rounds)


# ---------------------------------------------------------------------------
# sharded reduce: the ordered fold of ops.blocked_segment_sum
# ---------------------------------------------------------------------------


def _folded_segment_sum(x_local, ids_local, n_out: int, weights_local, *,
                        axis: Axis, n_blocks: int, impl: Optional[str]):
    """Cross-rank segment sum in the canonical ``n_blocks`` fold order:
    this rank's ``n_blocks / P`` block partials (K3, one block a call), the
    all-gathered (n_blocks, ...) stack added left to right — bitwise
    ``ops.blocked_segment_sum(n_blocks=...)`` over the concatenated rows
    when ``P | n_blocks`` and ``n_blocks | n`` (the level padding's
    guarantee)."""
    p = axis.size
    if n_blocks % p:
        raise ValueError(f"n_blocks={n_blocks} must be a multiple of the "
                         f"{axis.axis_name!r} size {p}")
    sub = n_blocks // p
    nl = x_local.shape[0]
    pad = (-nl) % sub
    ids_local = ids_local.to(torch.int64).clamp(-1, n_out)
    if pad:  # right-pad with dropped ids, as ops.blocked_segment_sum does
        x_local = torch.nn.functional.pad(x_local, (0, 0, 0, pad))
        ids_local = torch.nn.functional.pad(ids_local, (0, pad), value=n_out)
        if weights_local is not None:
            weights_local = torch.nn.functional.pad(weights_local, (0, pad))
    nb = (nl + pad) // sub
    sums, masses = [], []
    for b in range(sub):
        sl = slice(b * nb, (b + 1) * nb)
        s_b, m_b = ops.segment_sum(
            x_local[sl], ids_local[sl], n_out,
            weights=None if weights_local is None else weights_local[sl],
            impl=impl)
        sums.append(s_b)
        masses.append(m_b)
    sums = axis.gather_rows(torch.stack(sums))       # (n_blocks, n_out, d)
    masses = axis.gather_rows(torch.stack(masses))   # (n_blocks, n_out)
    acc_s, acc_m = sums[0], masses[0]
    for b in range(1, n_blocks):                     # left fold in block order
        acc_s = acc_s + sums[b]
        acc_m = acc_m + masses[b]
    return acc_s, acc_m


def _reduce_sharded(x_local, labels_local, n_out: int, *, weights_local,
                    weighted: bool, axis: Axis, n_blocks: int,
                    impl: Optional[str]):
    """The sharded twin of ``reduce_to_prototypes``: replicated (n_out, d)
    prototypes, (n_out,) mass and valid."""
    safe = torch.where(labels_local >= 0, labels_local.to(torch.int64), n_out)
    w = weights_local.float()
    kw = dict(axis=axis, n_blocks=n_blocks, impl=impl)
    if weighted:
        sums, denom = _folded_segment_sum(x_local, safe, n_out, w, **kw)
        mass = denom
    else:
        ones = (labels_local >= 0).float()
        sums, denom = _folded_segment_sum(x_local, safe, n_out, ones, **kw)
        _, mass = _folded_segment_sum(
            torch.zeros((x_local.shape[0], 1), dtype=x_local.dtype,
                        device=x_local.device), safe, n_out, w, **kw)
    protos = sums / torch.clamp_min(denom, 1e-12)[:, None]
    valid = denom > 0
    protos = torch.where(valid[:, None], protos, 0.0).to(x_local.dtype)
    return protos, mass, valid


def itis_level_sharded(x_local, mass_local, valid_local, key, *, t: int,
                       n_out: int, weighted: bool, axis: Axis, n_blocks: int,
                       impl: Optional[str] = None,
                       knn_route: Optional[str] = None) -> ITISLevelOut:
    """One sharded ITIS level: TC, the ordered reduce. Everything in the
    result is replicated: the (n_out, ...) prototype buffers (each rank's
    next-level rows are its contiguous slice of them) and the (n,)
    assignment."""
    tc = tc_sharded(x_local, valid_local, t, key, axis=axis, impl=impl,
                    knn_route=knn_route)
    labels_local = _local_rows(tc.labels, axis)
    protos, mass, valid = _reduce_sharded(
        x_local, labels_local, n_out, weights_local=mass_local,
        weighted=weighted, axis=axis, n_blocks=n_blocks, impl=impl)
    return ITISLevelOut(protos, mass, valid, tc.labels, tc.n_clusters,
                        tc.mis_rounds)


# ---------------------------------------------------------------------------
# placement of a global input
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardedRows:
    """A global (n, ...) array held as each rank's contiguous block of rows
    (the counterpart of a jax array placed ``P("data", None)``): ``local``
    is this rank's block, ``shape`` the global shape. What
    :func:`repro_torch.data.stream_to_mesh` returns; the sharded executor
    takes the block as it is."""

    local: torch.Tensor
    shape: Tuple[int, ...]

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype

    def to_local(self) -> torch.Tensor:
        return self.local


def place_rows(a: Any, n_pad: int, axis: Axis, device: torch.device, *,
               fill=0) -> torch.Tensor:
    """This rank's block of the rows of a global (n, ...) input padded to
    ``n_pad`` rows with ``fill``: only those rows reach ``device``. ``a`` is
    host data, a tensor anywhere, or :class:`ShardedRows` (as
    :func:`repro_torch.data.stream_to_mesh` makes), whose block is taken as
    it is."""
    per = n_pad // axis.size
    if isinstance(a, ShardedRows):
        if a.shape[0] != n_pad:
            raise ValueError(f"a sharded input of {a.shape[0]} rows; the "
                             f"level buffer needs {n_pad} (pad to the plan's "
                             f"shard multiple)")
        return a.to_local().to(device)
    lo = axis.index * per
    hi = min(lo + per, a.shape[0])
    blk = a[lo:hi] if hi > lo else a[0:0]
    if not isinstance(blk, torch.Tensor):
        blk = torch.as_tensor(np.asarray(blk))
    blk = blk.to(device)
    if blk.shape[0] < per:
        pad = torch.full((per - blk.shape[0], *blk.shape[1:]), fill,
                         dtype=blk.dtype, device=device)
        blk = torch.cat([blk, pad])
    return blk


def itis_sharded(
    x: Any,
    t: int,
    m: int,
    *,
    mesh=None,
    axis_name: Optional[str] = None,
    weights: Optional[Any] = None,
    valid: Optional[Any] = None,
    key: Optional[torch.Tensor] = None,
    weighted: bool = False,
    impl: Optional[str] = None,
    min_points: int = 4,
    n_blocks: Optional[int] = None,
    knn_route: Optional[str] = None,
    device=None,
) -> ITISResult:
    """The multi-rank twin of :func:`repro_torch.core.itis.itis`: level
    buffers padded (validity-masked) to a multiple of ``n_blocks`` (default:
    the smallest multiple of P covering the config's width), this rank's
    rows of each on ``device``; the key sequence and the early-stop rule of
    the single-device driver. ``valid`` marks pre-padded rows (those of
    :func:`repro_torch.data.stream_to_mesh`). Everything returned is
    replicated."""
    return _itis_sharded(x, t, m, mesh=mesh, axis_name=axis_name,
                         weights=weights, valid=valid, key=key,
                         weighted=weighted, impl=impl, min_points=min_points,
                         n_blocks=n_blocks, knn_route=knn_route,
                         device=device)[0]


def _itis_sharded(x, t, m, *, mesh, axis_name, weights, valid, key, weighted,
                  impl, min_points, n_blocks, knn_route, device):
    """:func:`itis_sharded` and the wall seconds of each level."""
    cfg = active()
    impl = cfg.impl if impl is None else impl
    if mesh is None:
        mesh = cfg.mesh if cfg.mesh is not None else make_data_mesh()
    axis = _axis(mesh, axis_name)
    p = axis.size
    n = int(x.shape[0])
    validate_reduction_params(t, m, n=n, driver="itis_sharded")
    if n_blocks is None:
        n_blocks = -(-max(cfg.n_blocks, p) // p) * p
    if n_blocks % p:
        raise ValueError(f"n_blocks={n_blocks} must be a multiple of the "
                         f"{axis.axis_name!r} size {p}")
    if key is None:
        key = prng.PRNGKey(0)
    dev = resolve_device(device)
    sizes = level_sizes(n, t, m, multiple=n_blocks)
    x_l = place_rows(x, sizes[0], axis, dev)
    v_l = (place_rows(torch.ones((n,), dtype=torch.bool), sizes[0], axis, dev,
                      fill=False) if valid is None
           else place_rows(valid, sizes[0], axis, dev, fill=False).bool())
    m_l = (torch.ones(v_l.shape, dtype=torch.float32, device=dev) if weights is None
           else place_rows(weights, sizes[0], axis, dev).float())
    m_l = torch.where(v_l, m_l, 0.0)
    cur_x, cur_m, cur_v = x_l, m_l, v_l
    out_x, out_m, out_v = x_l, m_l, v_l   # replicated after a level
    v_full = axis.gather_rows(v_l)
    assignments, rounds, n_valid_seen, level_s = [], [], [], []
    n_protos = v_full.sum().to(torch.int32)
    n_valid = int(v_full.sum())  # the early-exit floor is a host decision
    for level in range(m):
        if n_valid < max(min_points, 2 * t):
            break
        t0 = time.perf_counter()
        key, sub = prng.split(key)
        out = itis_level_sharded(cur_x, cur_m, cur_v, sub, t=t,
                                 n_out=sizes[level + 1], weighted=weighted,
                                 axis=axis, n_blocks=n_blocks, impl=impl,
                                 knn_route=knn_route)
        assignments.append(out.assignment)
        rounds.append(out.mis_rounds)
        n_valid_seen.append(n_valid)
        out_x, out_m, out_v = out.protos, out.mass, out.valid
        cur_x, cur_m, cur_v = (_local_rows(out_x, axis), _local_rows(out_m, axis),
                               _local_rows(out_v, axis))
        n_protos = out.n_clusters
        n_valid = int(out_v.sum())  # syncs: the level's wall ends here
        level_s.append(time.perf_counter() - t0)
    if not assignments:  # nothing ran: the level-0 buffer, replicated
        out_x, out_m, out_v = (axis.gather_rows(x_l), axis.gather_rows(m_l),
                               v_full)
    return ITISResult(out_x, out_m, out_v, assignments, n_protos, rounds,
                      n_valid_seen), level_s


# ---------------------------------------------------------------------------
# mesh k-means
# ---------------------------------------------------------------------------


def kmeans_sharded(
    x: torch.Tensor,
    k: int,
    *,
    valid: Optional[torch.Tensor] = None,
    weights: Optional[torch.Tensor] = None,
    key: Optional[torch.Tensor] = None,
    mesh=None,
    axis_name: Optional[str] = None,
    iters: int = 100,
    tol: float = 1e-6,
    impl: Optional[str] = None,
    n_blocks: Optional[int] = None,
) -> KMeansResult:
    """The mesh twin of :func:`repro_torch.cluster.kmeans.kmeans`: ``x`` is
    the replicated (n, d) point set (each rank computes on its contiguous
    block of rows, n divisible by P); the (k, d) centres are replicated,
    k-means++ draws from the all-gathered logits, the distances are K4
    calls on the local rows, and the Lloyd statistics go through the
    ordered K3 fold. Returns the single-device result's fields, every one
    replicated; bitwise that result when ``n_blocks`` divides n."""
    cfg = active()
    impl = cfg.impl if impl is None else impl
    if mesh is None:
        mesh = cfg.mesh if cfg.mesh is not None else make_data_mesh()
    axis = _axis(mesh, axis_name)
    p = axis.size
    if n_blocks is None:
        n_blocks = -(-max(cfg.n_blocks, p) // p) * p
    n, d = x.shape
    if n % p:
        raise ValueError(f"kmeans_sharded: {n} rows do not split over {p} ranks")
    dev = x.device
    valid = (torch.ones((n,), dtype=torch.bool, device=dev) if valid is None
             else valid.bool())
    weights = (torch.ones((n,), dtype=torch.float32, device=dev) if weights is None
               else weights.float())
    if key is None:
        key = prng.PRNGKey(0)
    x_l, v_l = _local_rows(x, axis), _local_rows(valid, axis)
    w_l = torch.where(v_l, _local_rows(weights, axis), 0.0)
    nl = x_l.shape[0]

    def pick(key, logits_l):
        return int(prng.categorical(key, axis.gather_rows(logits_l)))

    def row(i: int) -> torch.Tensor:
        # the owner's row, an exact copy
        owner = i // nl
        buf = (x_l[i - owner * nl] if owner == axis.index
               else torch.empty((d,), dtype=x.dtype, device=dev))
        return axis.broadcast(buf, owner)

    # ---- k-means++ (as _plus_plus_init)
    key0, key_loop = prng.split(key)
    centers = torch.zeros((k, d), dtype=x.dtype, device=dev)
    centers[0] = row(pick(key0, torch.log(torch.clamp_min(w_l, 1e-30))))
    slots = torch.arange(k, device=dev)[None, :]
    for i in range(1, k):
        key_loop, sub = prng.split(key_loop)
        dist_l = ops.pairwise_sq_l2(x_l, centers, impl=impl)
        dmin = torch.where(slots < i, dist_l, torch.inf).amin(dim=1)
        centers[i] = row(pick(sub, torch.log(torch.clamp_min(w_l * dmin, 1e-30))))

    # ---- Lloyd (as kmeans's loop, statistics through the ordered fold)
    def assign(c):
        dist_l = ops.pairwise_sq_l2(x_l, c, impl=impl)
        return torch.argmin(dist_l, dim=1), dist_l.amin(dim=1)

    tol_f32 = torch.tensor(tol, dtype=torch.float32, device=dev)
    delta = torch.tensor(torch.inf, dtype=torch.float32, device=dev)
    it = 0
    while it < iters and bool(delta > tol_f32):
        lab, _ = assign(centers)
        lab_safe = torch.where(v_l, lab, k)
        sums, mass = _folded_segment_sum(x_l, lab_safe, k, w_l, axis=axis,
                                         n_blocks=n_blocks, impl=impl)
        new = torch.where((mass > 0)[:, None],
                          sums / torch.clamp_min(mass, 1e-30)[:, None],
                          centers).to(x.dtype)
        delta = torch.sum(torch.square(new - centers), dim=1).amax()
        centers = new
        it += 1
    lab_l, dmin_l = assign(centers)
    labels = axis.gather_rows(torch.where(v_l, lab_l, -1).to(torch.int32))
    dmin = axis.gather_rows(dmin_l)
    w = torch.where(valid, weights, 0.0)
    inertia = torch.sum(torch.where(valid, w * dmin, 0.0))
    return KMeansResult(centers, labels, inertia, it)


# ---------------------------------------------------------------------------
# the executor and the deprecated driver
# ---------------------------------------------------------------------------


@register_executor("sharded")
def _execute_sharded(plan: FitPlan, x: Any) -> Reduction:
    """Mesh strategy: every level buffer padded to the plan's shard
    multiple and row-sharded over ``axis_name``; the points never gather
    on one device. The planner's epilogue keeps ``kmeans`` on the mesh
    (:func:`kmeans_sharded`) and runs any other backend on the replicated
    final prototypes."""
    key_itis, _ = plan.split_keys()
    r, level_s = _itis_sharded(
        x, plan.t, plan.m, mesh=plan.mesh, axis_name=plan.axis_name,
        weights=plan.weights, valid=plan.valid, key=key_itis,
        weighted=plan.weighted, impl=plan.impl, min_points=plan.min_points,
        n_blocks=plan.shard_multiple(), knn_route=plan.knn_route,
        device=plan.device)
    n0 = int(x.shape[0])
    sizes = level_sizes(n0, plan.t, plan.m, multiple=plan.shard_multiple())
    info = {
        "level_sizes": sizes[: len(r.assignments) + 1],
        "n_valid": list(r.n_valid),
        "mis_rounds": list(r.mis_rounds),
        "level_seconds": level_s,
        "shards": plan.shard_count(),
    }
    return Reduction(protos=r.protos, mass=r.mass, valid=r.valid,
                     n_prototypes=r.n_prototypes, assignments=r.assignments,
                     n0=n0, info=info)


def ihtc_sharded(
    x: Any,
    t: int,
    m: int,
    backend: Union[str, BackendFn] = "kmeans",
    *,
    mesh=None,
    axis_name: Optional[str] = None,
    weights=None,
    valid=None,
    weighted: bool = False,
    use_mass_in_backend: bool = True,
    key: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
    n_blocks: Optional[int] = None,
    device=None,
    **backend_kwargs,
) -> FitResult:
    """The multi-rank twin of IHTC (a deprecated alias of
    ``repro_torch.fit(..., executor="sharded")``): ``kmeans`` runs on the
    mesh, any other backend on the replicated final prototypes (already
    reduced by ITIS). ``mesh`` / ``axis_name`` / ``impl`` default to the
    runtime config."""
    return fit(x, t, m, backend, executor="sharded", mesh=mesh,
               axis_name=axis_name, weights=weights, valid=valid,
               weighted=weighted, use_mass_in_backend=use_mass_in_backend,
               key=key, impl=impl, n_blocks=n_blocks, device=device,
               driver="ihtc_sharded", **backend_kwargs)
