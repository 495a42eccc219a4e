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
    psum of a single nonzero row, without the sign of a zero changing).

Host staging. Gloo moves host memory: a CUDA tensor handed to a gloo
group goes through a pinned host copy and back. The choice is made from
the process group's backend name (:data:`HOST_STAGED_BACKENDS`), never by
trying an op and catching its error; every staged call and its bytes are
counted (:func:`staging_counts`), so a run can say what crossed the host.
NCCL takes the CUDA tensors as they are.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

#: process-group backends whose collectives take host tensors only: a CUDA
#: tensor is staged through pinned host memory for them
HOST_STAGED_BACKENDS = ("gloo",)

# op name -> [staged calls, staged bytes] (the tensors sent)
_STAGED: Dict[str, list] = {}


def staging_counts() -> Dict[str, Dict[str, int]]:
    """The collectives staged through host memory since the last reset:
    ``{op: {"calls": n, "bytes": b}}`` (b: the bytes this rank sent)."""
    return {op: {"calls": c, "bytes": b} for op, (c, b) in sorted(_STAGED.items())}


def reset_staging_counts() -> None:
    _STAGED.clear()


def _all_gather(out: torch.Tensor, t: torch.Tensor, group) -> None:
    # all_gather_single is the newer name of the same call
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, t, group=group)


class Axis:
    """One named dimension of a ``DeviceMesh`` as this rank sees it: the
    process group, its ``size`` (the reference's ``axis_size``) and this
    rank's ``index`` along it (``lax.axis_index``)."""

    def __init__(self, mesh, axis_name: str):
        names = tuple(mesh.mesh_dim_names or ())
        if axis_name not in names:
            raise ValueError(f"mesh has no dimension {axis_name!r}; its "
                             f"dimensions are {names}")
        self.mesh = mesh
        self.axis_name = axis_name
        self.group = mesh.get_group(axis_name)
        self.size = int(mesh.size(names.index(axis_name)))
        self.index = int(mesh.get_local_rank(axis_name))
        self.backend = str(dist.get_backend(self.group))
        self._peers = [dist.get_global_rank(self.group, r) for r in range(self.size)]

    # ---- staging ----------------------------------------------------------

    def _host(self, t: torch.Tensor, op: str):
        """(the tensor the backend gets, staged?): a pinned host copy of a
        CUDA tensor for a host-only backend, else ``t`` itself."""
        if t.is_cuda and self.backend in HOST_STAGED_BACKENDS:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t)
            rec = _STAGED.setdefault(op, [0, 0])
            rec[0] += 1
            rec[1] += t.numel() * t.element_size()
            return h, True
        return t, False

    # ---- the collectives ---------------------------------------------------

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """(n_local, ...) on every rank → (size·n_local, ...) in rank order,
        an exact copy (bools travel as bytes)."""
        is_bool = t.dtype == torch.bool
        src = (t.to(torch.uint8) if is_bool else t).contiguous()
        h, staged = self._host(src, "gather_rows")
        out = torch.empty((self.size * src.shape[0], *src.shape[1:]),
                          dtype=src.dtype, device=h.device)
        _all_gather(out, h, self.group)
        if staged:
            out = out.to(t.device)
        return out.bool() if is_bool else out

    def _all_reduce(self, t: torch.Tensor, op, name: str) -> torch.Tensor:
        """All-reduce of a fresh copy of ``t`` (``t`` is left as it was)."""
        h, staged = self._host(t.contiguous(), name)
        out = h if staged else h.clone()
        dist.all_reduce(out, op=op, group=self.group)
        return out.to(t.device) if staged else out

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(t, dist.ReduceOp.MAX, "pmax")

    def pmin(self, t: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(t, dist.ReduceOp.MIN, "pmin")

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(t, dist.ReduceOp.SUM, "psum")

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank (an exact copy; ``t`` is the
        buffer's shape and dtype on the others)."""
        h, staged = self._host(t.contiguous(), "broadcast")
        out = h if staged else h.clone()
        dist.broadcast(out, src=self._peers[src], group=self.group)
        return out.to(t.device) if staged else out

    def ring_shift(self, t: torch.Tensor) -> torch.Tensor:
        """``lax.ppermute`` with perm ``[(i, (i - 1) % size)]``: this rank's
        ``t`` goes to the next lower rank, and the next higher rank's
        arrives."""
        if self.size == 1:
            return t
        h, staged = self._host(t.contiguous(), "ring_shift")
        recv = torch.empty_like(h)
        me = self.index
        ops = [dist.P2POp(dist.isend, h, self._peers[(me - 1) % self.size], self.group),
               dist.P2POp(dist.irecv, recv, self._peers[(me + 1) % self.size],
                          self.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return recv.to(t.device) if staged else recv
