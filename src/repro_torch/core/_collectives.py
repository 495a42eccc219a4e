"""Collectives over one dimension of a device mesh — what the sharded fit
needs from ``torch.distributed``.

The reference runs each ITIS level as one ``shard_map`` program over a mesh
of devices that a single process drives. The port runs one process per
rank: every rank executes the same host program on its own rows, and the
cross-rank steps are these calls, each the counterpart of a JAX op:

  * :meth:`Axis.gather_rows`  — ``lax.all_gather(tiled=True)`` (an exact
    copy, rank order);
  * :meth:`Axis.pmax` / :meth:`Axis.pmin` — ``lax.pmax`` / ``lax.pmin``
    (exact, order-free, on ints and floats);
  * :meth:`Axis.psum` — ``lax.psum``; the fit only sums disjoint one-hot
    rows, where every order gives the same bits;
  * :meth:`Axis.ring_shift` — ``lax.ppermute`` around the ring (a block
    travels to the next lower rank), by ``batch_isend_irecv``;
  * :meth:`Axis.broadcast` — one rank's tensor to all (the reference's
    psum of a single nonzero row, without the sign of a zero changing);
  * :meth:`Axis.sum_scatter` — the trainer's gradient reduction: each rank
    gets the sum of one chunk of every rank's tensor, added in rank order
    (``all_to_all`` then ``g0 + g1 + … + g(P-1)`` on the owner), so the
    bits never depend on a ring's order as a float ``all_reduce``'s do.

An axis may also span several mesh dimensions (the trainer's ``("pod",
"data")``): its ranks are then taken in row-major order, pod-major, as
the reference's ``P(("pod", "data"))`` lays out rows. On a mesh with
other dimensions too (``("pod", "data", "model")``) each index of those
gets a group of its own (:func:`_subgroup`, made once a mesh).

Host staging. Gloo moves host memory: a CUDA tensor handed to a gloo
group goes through a pinned host copy and back. The choice is made from
the process group's backend name (:data:`HOST_STAGED_BACKENDS`), never by
trying an op and catching its error; every staged call and its bytes are
counted (:func:`staging_counts`), so a run can say what crossed the host.
NCCL takes the CUDA tensors as they are.

Ranks on one card. Where every rank of a gloo group holds its tensors on
the same card (several ranks sharing one GPU, as the chip smoke runs
them), the copies (``gather_rows``, ``broadcast``, ``ring_shift`` and
``sum_scatter``'s exchange) skip the host: each rank keeps a device
mailbox of :data:`MAILBOX_BYTES`, opened in every other rank by CUDA IPC
once (:class:`_Mailbox`), writes its piece into one half of it, and the
others read it device to device after a barrier of the group; the rounds
take the two halves in turn, so one barrier a round keeps a half from
being written again while a rank still reads it. The bits are those of the staged path: the same bytes land in
the same places, and ``sum_scatter`` adds in rank order either way. The
reductions (``pmax``, ``pmin``, ``psum``) stay with gloo on the host.
Mailbox traffic is counted apart (:func:`ipc_counts`). The tests run the
same path on the CPU through files mapped shared
(:func:`use_host_mailboxes`).

An axis of one rank moves nothing: each collective returns a copy of this
rank's tensor (its exact result), without a wait on the card or a
barrier, and is counted as any other call.

The logical count. :func:`op_counts` counts every call of an
:class:`Axis` collective once, with the bytes this rank hands it, whatever
the route (mailbox, staged, NCCL, gloo on host tensors); :func:`op_records`
keeps the group size beside each, which the ring cost model of
``utils/hlo.py`` reads. A :class:`RecordingAxis` (the dry run's, on a
:class:`~repro_torch.launch.mesh.TracedMesh`) counts the same calls into
the same table without a process group.
"""
from __future__ import annotations

import os
import uuid
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

#: process-group backends whose collectives take host tensors only: a CUDA
#: tensor is staged through pinned host memory for them
HOST_STAGED_BACKENDS = ("gloo",)

#: bytes of one rank's device mailbox (ranks of a gloo group on one card):
#: a collective larger than half of it goes through it in pieces
MAILBOX_BYTES = 1 << 28

# op name -> [staged calls, staged bytes] (the tensors sent)
_STAGED: Dict[str, list] = {}
# (op name, group size) -> [calls, bytes this rank handed in], every route
_OPS: Dict[tuple, list] = {}
# op name -> [calls, bytes this rank wrote to its mailbox]
_IPC: Dict[str, list] = {}
# (process group, card index or "cpu") -> its _Mailbox, or None where the
# ranks are on several cards
_MAILBOXES: Dict[tuple, Optional["_Mailbox"]] = {}
# (directory, bytes) of the host mailboxes (use_host_mailboxes), or None
_HOST_MAILBOXES: Optional[tuple] = None


def staging_counts() -> Dict[str, Dict[str, int]]:
    """The collectives staged through host memory since the last reset:
    ``{op: {"calls": n, "bytes": b}}`` (b: the bytes this rank sent)."""
    return {op: {"calls": c, "bytes": b} for op, (c, b) in sorted(_STAGED.items())}


def ipc_counts() -> Dict[str, Dict[str, int]]:
    """The collectives that went through the ranks' device mailboxes since
    the last reset: ``{op: {"calls": n, "bytes": b}}`` (b: the bytes this
    rank wrote)."""
    return {op: {"calls": c, "bytes": b} for op, (c, b) in sorted(_IPC.items())}


def reset_staging_counts() -> None:
    """Zero both :func:`staging_counts` and :func:`ipc_counts`."""
    _STAGED.clear()
    _IPC.clear()


def op_counts() -> Dict[str, Dict[str, int]]:
    """Every collective call since :func:`reset_op_counts`, whatever its
    route: ``{op: {"calls": n, "bytes": b}}`` (b: the bytes of the tensors
    this rank handed in; broadcast counts its buffer on every rank)."""
    out: Dict[str, Dict[str, int]] = {}
    for (op, _), (c, b) in sorted(_OPS.items()):
        rec = out.setdefault(op, {"calls": 0, "bytes": 0})
        rec["calls"] += c
        rec["bytes"] += b
    return out


def op_records() -> List[Dict[str, Any]]:
    """:func:`op_counts` by op and group size: ``[{"op", "group", "calls",
    "bytes"}]``, the records ``utils.hlo.collective_bytes`` takes."""
    return [{"op": op, "group": k, "calls": c, "bytes": b}
            for (op, k), (c, b) in sorted(_OPS.items())]


def reset_op_counts() -> None:
    _OPS.clear()


def _record(op: str, group: int, t: torch.Tensor) -> None:
    _count(_OPS, (op, int(group)), t.numel() * t.element_size())


def _count(table: Dict[Any, list], op: Any, nbytes: int) -> None:
    rec = table.setdefault(op, [0, 0])
    rec[0] += 1
    rec[1] += nbytes


class _Mailbox:
    """One buffer for each rank of a group, every rank's mapped in this
    process, used in two halves of ``nbytes`` taken in turn, one a round
    (:meth:`_Axis._round` moves to the other): ``boxes[j]`` is rank j's
    half of this round, ``buf`` this rank's own. On a card the buffers are
    device memory opened by CUDA IPC; on the host
    (:func:`use_host_mailboxes`) files mapped shared."""

    def __init__(self, buf: torch.Tensor, boxes: List[torch.Tensor]):
        self._buf = buf
        self._boxes = boxes
        self.nbytes = buf.numel() // 2
        self.turn = 0

    def _half(self, t: torch.Tensor) -> torch.Tensor:
        return t[self.turn * self.nbytes:(self.turn + 1) * self.nbytes]

    @property
    def buf(self) -> torch.Tensor:
        return self._half(self._buf)

    @property
    def boxes(self) -> List[torch.Tensor]:
        return [self._half(t) for t in self._boxes]

    @staticmethod
    def open(group, index: int, size: int, device: torch.device) -> Optional["_Mailbox"]:
        """Collective over ``group``: the ranks' mailboxes, or None when
        they are not all on one card."""
        if device.type != "cuda":
            return _Mailbox._open_files(group, index, size)
        from torch.multiprocessing.reductions import reduce_tensor

        buf = torch.empty(MAILBOX_BYTES, dtype=torch.uint8, device=device)
        rebuild, handle = reduce_tensor(buf)
        card = str(torch.cuda.get_device_properties(device).uuid)
        got: List[Any] = [None] * size
        dist.all_gather_object(got, (card, handle), group=group)
        if any(c != card for c, _ in got):
            return None
        boxes = [buf if j == index else rebuild(*h) for j, (_, h) in enumerate(got)]
        # repro_torch: allow[HS201]: once a group, where the mailboxes open: the IPC handles must be valid before the peers map them
        torch.cuda.synchronize(device)
        dist.barrier(group=group)
        return _Mailbox(buf, boxes)

    @staticmethod
    def _open_files(group, index: int, size: int) -> "_Mailbox":
        directory, nbytes = _HOST_MAILBOXES
        tag: List[Any] = [uuid.uuid4().hex]
        dist.broadcast_object_list(tag, src=dist.get_global_rank(group, 0), group=group)
        paths = [os.path.join(directory, f"mailbox-{tag[0]}-{j}") for j in range(size)]
        with open(paths[index], "wb") as f:
            f.truncate(nbytes)
        dist.barrier(group=group)
        boxes = [torch.from_file(p, shared=True, size=nbytes, dtype=torch.uint8)
                 for p in paths]
        dist.barrier(group=group)
        os.remove(paths[index])  # the mappings stay
        return _Mailbox(boxes[index], boxes)


def use_host_mailboxes(directory: Optional[str], nbytes: int = MAILBOX_BYTES) -> None:
    """Send the copies of host tensors of gloo groups through mailboxes too:
    files of ``nbytes`` in ``directory`` (on one host, every rank maps
    every rank's), so the card's path and its pieces run on the CPU; None
    turns it off. Every rank calls it alike, before its collectives."""
    global _HOST_MAILBOXES
    _HOST_MAILBOXES = (directory, nbytes) if directory is not None else None
    for key in [k for k in _MAILBOXES if k[1] == "cpu"]:
        del _MAILBOXES[key]


def release_mailboxes() -> None:
    """Close every mailbox this process opened, group by group: each rank
    waits for its last reads, drops its views of the others' buffers, the
    group waits for all, then each drops its own (so no buffer goes while
    another rank maps it). Every rank of each group calls it
    (``spawn_ranks`` does, after the rank's function returns)."""
    for (group, _), box in list(_MAILBOXES.items()):
        if box is not None:
            _wait(box._buf.device)
            box._boxes.clear()
            dist.barrier(group=group)
    _MAILBOXES.clear()


def _wait(device: torch.device) -> None:
    """Wait for the card's queued work on this rank's stream (nothing on
    the host) on a blocking event, so a rank sleeps instead of spinning on
    a core that the other ranks' collectives need."""
    if device.type == "cuda":
        done = torch.cuda.Event(blocking=True)
        done.record(torch.cuda.current_stream(device))
        done.synchronize()


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes, flat (a view)."""
    return t.reshape(-1).view(torch.uint8)


def _all_gather(out: torch.Tensor, t: torch.Tensor, group) -> None:
    # all_gather_single is the newer name of the same call
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, t, group=group)


# (the mesh's ranks, its dimension names, the axis's dimensions) -> the
# process group of this rank's ranks along them
_SUBGROUPS: Dict[tuple, Any] = {}


def _subgroup(mesh, want: Sequence[str]):
    """The group of the ranks that share this rank's index on every mesh
    dimension outside ``want``, in row-major order over ``want``. Every
    group of the mesh is made (``new_group`` is collective over all
    ranks), once a mesh."""
    names = tuple(mesh.mesh_dim_names)
    grid = mesh.mesh
    # repro_torch: allow[HS201]: the DeviceMesh's rank grid is a host tensor (no card read)
    key = (tuple(int(r) for r in grid.flatten().tolist()), names, tuple(want))
    if key not in _SUBGROUPS:
        rest = [names.index(a) for a in names if a not in want]
        order = rest + [names.index(a) for a in want]
        rows = grid.permute(order).reshape(-1, int(np.prod(
            [grid.shape[names.index(a)] for a in want])))
        me = dist.get_rank()
        # repro_torch: allow[HS201]: the DeviceMesh's rank grid is a host tensor (no card read)
        for row in rows.tolist():
            group = dist.new_group([int(r) for r in row])
            if me in row:
                _SUBGROUPS[key] = group
    return _SUBGROUPS[key]


class Axis:
    """One named dimension of a ``DeviceMesh`` as this rank sees it: the
    process group, its ``size`` (the reference's ``axis_size``) and this
    rank's ``index`` along it (``lax.axis_index``). ``axis_name`` may be a
    tuple of dimension names, one axis over their ranks in row-major order
    (the default group where those are every dimension of the mesh, else
    a group of this rank's index on the others)."""

    def __init__(self, mesh, axis_name: Union[str, Sequence[str]]):
        names = tuple(mesh.mesh_dim_names or ())
        want = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
        missing = [a for a in want if a not in names]
        if missing or not want:
            raise ValueError(f"mesh has no dimension {axis_name!r}; its "
                             f"dimensions are {names}")
        self.mesh = mesh
        self.axis_name = want[0] if len(want) == 1 else want
        if len(want) == 1:
            self.group = mesh.get_group(want[0])
            self.size = int(mesh.size(names.index(want[0])))
            self.index = int(mesh.get_local_rank(want[0]))
        else:
            # repro_torch: allow[HS201]: the DeviceMesh's rank grid is a host tensor (no card read)
            ranks = [int(r) for r in mesh.mesh.flatten().tolist()]
            if tuple(want) == names and ranks == list(range(dist.get_world_size())):
                self.group = dist.group.WORLD
            else:
                self.group = _subgroup(mesh, want)
            sizes = tuple(int(mesh.size(names.index(a))) for a in want)
            self.size = int(np.prod(sizes))
            self.index = int(np.ravel_multi_index(
                tuple(int(mesh.get_local_rank(a)) for a in want), sizes))
        self.backend = str(dist.get_backend(self.group))
        self._peers = [dist.get_global_rank(self.group, r) for r in range(self.size)]

    # ---- staging ----------------------------------------------------------

    def _host(self, t: torch.Tensor, op: str):
        """(the tensor the backend gets, staged?): a pinned host copy of a
        CUDA tensor for a host-only backend, else ``t`` itself."""
        if t.is_cuda and self.backend in HOST_STAGED_BACKENDS:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t)
            _count(_STAGED, op, t.numel() * t.element_size())
            return h, True
        return t, False

    @staticmethod
    def _out(shape, dtype, like: torch.Tensor, staged: bool) -> torch.Tensor:
        """An output buffer beside the backend's input: pinned host memory
        when staged (its copy back to the card is then a DMA, and the
        caching host allocator reuses it), else on ``like``'s device."""
        if staged:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=like.device)

    # ---- mailboxes (ranks sharing one card) --------------------------------

    def _mailbox(self, t: torch.Tensor) -> Optional[_Mailbox]:
        """The group's mailboxes when ``t`` is a CUDA tensor of a gloo group
        whose ranks all hold that card, or a host tensor under
        :func:`use_host_mailboxes` (opened by the first such call), else
        None."""
        if self.backend not in HOST_STAGED_BACKENDS:
            return None
        if t.is_cuda:
            key = (self.group, t.device.index)
        elif _HOST_MAILBOXES is not None and t.device.type == "cpu":
            key = (self.group, "cpu")
        else:
            return None
        if key not in _MAILBOXES:
            _MAILBOXES[key] = _Mailbox.open(self.group, self.index, self.size, t.device)
        return _MAILBOXES[key]

    def _round(self, box: _Mailbox, write: Optional[Callable[[], Any]],
               read: Callable[[], Any]) -> None:
        """One exchange through the mailboxes' halves of this round: this
        rank writes, waits for its card's copies, every rank waits for
        all, reads; the next round takes the other halves. A half is
        written again two rounds on, after the next round's barrier, which
        a rank reaches only once its reads of this one are done (its wait
        before the barrier covers them)."""
        if write is not None:
            write()
        _wait(box._buf.device)
        dist.barrier(group=self.group)
        read()
        box.turn ^= 1

    def _copy_via(self, box: _Mailbox, op: str, src: torch.Tensor,
                  read: Callable[[int, int], Any], write: bool = True) -> None:
        """``src``'s bytes through this rank's mailbox in pieces [a, b);
        ``read(a, b)`` takes every rank's piece from ``box.boxes``."""
        flat = _bytes(src)
        n = flat.numel()
        if write:
            _count(_IPC, op, n)
        for a in range(0, n, box.nbytes):
            b = min(n, a + box.nbytes)
            self._round(box,
                        (lambda: box.buf[:b - a].copy_(flat[a:b])) if write else None,
                        lambda: read(a, b))

    # ---- the collectives ---------------------------------------------------

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """(n_local, ...) on every rank → (size·n_local, ...) in rank order,
        an exact copy (bools travel as bytes)."""
        is_bool = t.dtype == torch.bool
        src = (t.to(torch.uint8) if is_bool else t).contiguous()
        _record("gather_rows", self.size, src)
        if self.size == 1:  # this rank's rows alone: no exchange, no wait on the card
            return t.clone()
        box = self._mailbox(src)
        if box is not None:
            out = torch.empty((self.size * src.shape[0], *src.shape[1:]),
                              dtype=src.dtype, device=src.device)
            rows = _bytes(out).view(self.size, -1)

            def read(a: int, b: int) -> None:
                for j, peer in enumerate(box.boxes):
                    rows[j, a:b].copy_(peer[:b - a])

            self._copy_via(box, "gather_rows", src, read)
        else:
            h, staged = self._host(src, "gather_rows")
            out = self._out((self.size * src.shape[0], *src.shape[1:]), src.dtype, h,
                            staged)
            _all_gather(out, h, self.group)
            if staged:
                out = out.to(t.device)
        return out.bool() if is_bool else out

    def _all_reduce(self, t: torch.Tensor, op, name: str) -> torch.Tensor:
        """All-reduce of a fresh copy of ``t`` (``t`` is left as it was)."""
        if self.size == 1:
            return t.clone()
        h, staged = self._host(t.contiguous(), name)
        out = h if staged else h.clone()
        dist.all_reduce(out, op=op, group=self.group)
        return out.to(t.device) if staged else out

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        _record("pmax", self.size, t)
        return self._all_reduce(t, dist.ReduceOp.MAX, "pmax")

    def pmin(self, t: torch.Tensor) -> torch.Tensor:
        _record("pmin", self.size, t)
        return self._all_reduce(t, dist.ReduceOp.MIN, "pmin")

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        _record("psum", self.size, t)
        return self._all_reduce(t, dist.ReduceOp.SUM, "psum")

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank (an exact copy; ``t`` is the
        buffer's shape and dtype on the others)."""
        t = t.contiguous()
        _record("broadcast", self.size, t)
        if self.size == 1:
            return t.clone()
        box = self._mailbox(t)
        if box is not None:
            out = t.clone()
            dst = _bytes(out)
            self._copy_via(box, "broadcast", t,
                           lambda a, b: dst[a:b].copy_(box.boxes[src][:b - a]),
                           write=self.index == src)
            return out
        h, staged = self._host(t, "broadcast")
        out = h if staged else h.clone()
        dist.broadcast(out, src=self._peers[src], group=self.group)
        return out.to(t.device) if staged else out

    def ring_shift(self, t: torch.Tensor) -> torch.Tensor:
        """``lax.ppermute`` with perm ``[(i, (i - 1) % size)]``: this rank's
        ``t`` goes to the next lower rank, and the next higher rank's
        arrives."""
        _record("ring_shift", self.size, t)
        if self.size == 1:
            return t
        t = t.contiguous()
        me = self.index
        box = self._mailbox(t)
        if box is not None:
            recv = torch.empty_like(t)
            dst = _bytes(recv)
            nxt = (me + 1) % self.size
            self._copy_via(box, "ring_shift", t,
                           lambda a, b: dst[a:b].copy_(box.boxes[nxt][:b - a]))
            return recv
        h, staged = self._host(t, "ring_shift")
        recv = self._out(h.shape, h.dtype, h, staged)
        ops = [dist.P2POp(dist.isend, h, self._peers[(me - 1) % self.size], self.group),
               dist.P2POp(dist.irecv, recv, self._peers[(me + 1) % self.size],
                          self.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return recv.to(t.device) if staged else recv

    def sum_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """Chunk ``index`` of the sum of every rank's ``t`` (a flat tensor of
        ``size · c`` elements), added in rank order: ``t_0 + t_1 + … +
        t_(size-1)``, each rank's chunk received by ``all_to_all`` (or read
        from the ranks' mailboxes). Every rank gets its own chunk of c
        elements; the bits depend on nothing but the ranks' values."""
        if t.dim() != 1 or t.numel() % self.size:
            raise ValueError(f"sum_scatter takes a flat tensor of a multiple of "
                             f"{self.size} elements, not {tuple(t.shape)}")
        t = t.contiguous()
        _record("sum_scatter", self.size, t)
        if self.size == 1:  # the sum of one rank's tensor: itself
            return t.clone()
        box = self._mailbox(t)
        if box is not None:
            return self._sum_scatter_via(box, t)
        h, staged = self._host(t, "sum_scatter")
        out = self._out((self.size, t.numel() // self.size), h.dtype, h, staged)
        dist.all_to_all_single(out, h, group=self.group)
        if staged:
            out = out.to(t.device)
        acc = out[0]
        for j in range(1, self.size):
            acc += out[j]
        return acc

    def _sum_scatter_via(self, box: _Mailbox, t: torch.Tensor) -> torch.Tensor:
        """sum_scatter through the mailboxes, in pieces of every rank's
        chunk: each rank writes its (size, k) piece, and the owner of a
        chunk adds the ranks' rows of it in rank order."""
        n, es = self.size, t.element_size()
        c = t.numel() // n
        rows = t.view(n, c)
        acc = torch.empty(c, dtype=t.dtype, device=t.device)
        per = max(1, box.nbytes // (es * n))
        _count(_IPC, "sum_scatter", t.numel() * es)
        for a in range(0, c, per):
            b = min(c, a + per)

            def piece(buf: torch.Tensor, k: int = b - a) -> torch.Tensor:
                return buf[:n * k * es].view(t.dtype).view(n, k)

            def read(a: int = a, b: int = b) -> None:
                out = acc[a:b]
                out.copy_(piece(box.boxes[0])[self.index])
                for peer in box.boxes[1:]:
                    out += piece(peer)[self.index]

            self._round(box, lambda a=a, b=b: piece(box.buf).copy_(rows[:, a:b]),
                        read)
        return acc

    def barrier(self) -> None:
        dist.barrier(group=self.group)


class RecordingAxis:
    """One axis of a :class:`~repro_torch.launch.mesh.TracedMesh` with no
    process group behind it: what :class:`Axis` offers, at this rank's
    ``index`` of ``size``, each call counted as :class:`Axis` counts it
    (:func:`op_counts`) and answered by an uninitialised tensor of the
    shape and dtype the real collective returns. The dry run traces one
    rank's step over it on the "meta" device (no data moves, so the values
    mean nothing on any other device)."""

    backend = "recording"

    def __init__(self, mesh, axis_name: Union[str, Sequence[str]]):
        names = tuple(mesh.mesh_dim_names)
        want = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
        missing = [a for a in want if a not in names]
        if missing or not want:
            raise ValueError(f"mesh has no dimension {axis_name!r}; its "
                             f"dimensions are {names}")
        self.mesh = mesh
        self.axis_name = want[0] if len(want) == 1 else want
        sizes = tuple(int(mesh.size(names.index(a))) for a in want)
        self.size = int(np.prod(sizes))
        self.index = int(np.ravel_multi_index(
            tuple(int(mesh.get_local_rank(a)) for a in want), sizes))

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        _record("gather_rows", self.size,
                t.to(torch.uint8) if t.dtype == torch.bool else t)
        return torch.empty((self.size * t.shape[0], *t.shape[1:]), dtype=t.dtype,
                           device=t.device)

    def _same(self, op: str, t: torch.Tensor) -> torch.Tensor:
        _record(op, self.size, t)
        return torch.empty_like(t, memory_format=torch.contiguous_format)

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        return self._same("pmax", t)

    def pmin(self, t: torch.Tensor) -> torch.Tensor:
        return self._same("pmin", t)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        return self._same("psum", t)

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        return self._same("broadcast", t)

    def ring_shift(self, t: torch.Tensor) -> torch.Tensor:
        out = self._same("ring_shift", t)  # counted at one rank too, as Axis counts
        return t if self.size == 1 else out

    def sum_scatter(self, t: torch.Tensor) -> torch.Tensor:
        if t.dim() != 1 or t.numel() % self.size:
            raise ValueError(f"sum_scatter takes a flat tensor of a multiple of "
                             f"{self.size} elements, not {tuple(t.shape)}")
        _record("sum_scatter", self.size, t)
        return torch.empty((t.numel() // self.size,), dtype=t.dtype, device=t.device)

    def barrier(self) -> None:
        pass
