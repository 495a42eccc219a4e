"""Fitted ClusterIndex — the reduced representation as a servable product;
the port of ``repro.core.index``.

The final prototypes and their backend labels are a complete, small
classifier for new points: ``assign`` labels a query batch by its nearest
valid prototype. On the card the default path is K1 with k = 1 (the
streaming top-k); the composed paths (dense or blocked distances plus the
shared merge) remain for the other policies. ``build(..., pack=True)``
also freezes a bf16 copy and a per-feature int8 quantization of the
prototypes: the ``fused_bf16`` / ``fused_int8`` impls shortlist
``RESCORE_K`` candidates through K1's bf16 / int8 instance on that buffer
and rescore the shortlist in exact f32.
"""
from __future__ import annotations

from typing import Any, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.cluster.registry import BackendFn
from repro_torch.core.plan import FitResult, as_device_tensor
from repro_torch.core.plan import fit as _fit
from repro_torch.kernels import ops
from repro_torch.kernels.fused_assign import (RESCORE_K, fused_topk,
                                              quantize_keys, rescore_top1)
from repro_torch.kernels.ref import merge_topk
from repro_torch.runtime import active, resolve_device

#: field -> dtype of every array of an index; the last four (the packed
#: low-precision buffers) are optional
DTYPES = {
    "protos": torch.float32,
    "proto_mass": torch.float32,
    "proto_valid": torch.bool,
    "proto_labels": torch.int32,
    "n_prototypes": torch.int32,
    "protos_bf16": torch.bfloat16,
    "protos_q8": torch.int8,
    "q8_scale": torch.float32,
    "q8_zero": torch.float32,
}


def tensor_from_numpy(a: Any, dtype: torch.dtype, device) -> torch.Tensor:
    """A host array as a tensor of ``dtype`` on ``device`` (a copy: the
    array may be a read-only view). bf16 arrives as numpy's ``bfloat16``
    extension type or as its uint16 bit pattern; both keep their bits."""
    a = np.asarray(a)
    if dtype == torch.bfloat16:
        if a.dtype.itemsize != 2:
            raise TypeError(f"a bf16 buffer needs 2-byte elements, got {a.dtype}")
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.tensor(a, device=device).to(dtype)


class ClusterIndex(NamedTuple):
    """Frozen artifact of an IHTC fit: everything ``assign`` needs.

    The trailing optional fields are the freeze-time low-precision
    prototype buffers the quantized assign impls serve from: a bf16 copy
    and a per-feature int8 quantization (``None`` on an unpacked index,
    which then packs on the fly per call)."""

    protos: torch.Tensor        # (n_max, d) final-level prototypes (padded)
    proto_mass: torch.Tensor    # (n_max,) original-unit mass per prototype
    proto_valid: torch.Tensor   # (n_max,) bool — real prototype vs padding
    proto_labels: torch.Tensor  # (n_max,) int32 backend labels (-1 = pad/noise)
    n_prototypes: torch.Tensor  # () int32 — valid count
    protos_bf16: Optional[torch.Tensor] = None  # (n_max, d) bf16 copy
    protos_q8: Optional[torch.Tensor] = None    # (n_max, d) int8 quantized
    q8_scale: Optional[torch.Tensor] = None     # (d,) f32 per-feature scale
    q8_zero: Optional[torch.Tensor] = None      # (d,) f32 per-feature zero

    @classmethod
    def build(
        cls,
        source: Any,
        t: Optional[int] = None,
        m: Optional[int] = None,
        backend: Union[str, BackendFn] = "kmeans",
        *,
        pack: bool = True,
        **fit_kwargs,
    ) -> "ClusterIndex":
        """Build a servable index from a :class:`FitResult` (freeze it), an
        existing index (re-pack it), or raw data (``t``/``m`` required:
        run :func:`repro_torch.fit` with ``fit_kwargs``, then freeze).
        ``pack=True`` also freezes the bf16/int8 prototype buffers."""
        if isinstance(source, FitResult):
            if t is not None or m is not None:
                raise TypeError(
                    "ClusterIndex.build: t/m only apply when building from "
                    "raw data; the FitResult already fixed them")
            idx = cls(protos=source.protos, proto_mass=source.proto_mass,
                      proto_valid=source.proto_valid,
                      proto_labels=source.proto_labels,
                      n_prototypes=source.n_prototypes)
            return idx._packed() if pack else idx
        if isinstance(source, ClusterIndex):
            if t is not None or m is not None:
                raise TypeError(
                    "ClusterIndex.build: t/m only apply when building from "
                    "raw data; the index is already fitted")
            return source._packed() if pack else source
        if t is None or m is None:
            raise TypeError(
                "ClusterIndex.build from raw data needs t and m (got "
                f"t={t!r}, m={m!r}); pass a FitResult to freeze an "
                "already-run fit")
        return cls.build(_fit(source, t, m, backend, **fit_kwargs), pack=pack)

    def _packed(self) -> "ClusterIndex":
        """The bf16 copy and the int8 quantization (scale and zero over the
        valid rows only) of the prototype buffer, frozen once so that an
        assign only touches its queries."""
        q8, scale, zero = quantize_keys(self.protos, self.proto_valid)
        return self._replace(protos_bf16=self.protos.to(torch.bfloat16),
                             protos_q8=q8, q8_scale=scale, q8_zero=zero)

    @classmethod
    def from_numpy(cls, arrays: Mapping[str, Any], *, device=None
                   ) -> "ClusterIndex":
        """An index from host arrays named like the fields (for example the
        fields of a reference index, through ``np.asarray``; the packed
        buffers when present), placed on ``device`` (default: the runtime
        config's)."""
        dev = resolve_device(device)
        fields = {name: tensor_from_numpy(arrays[name], dtype, dev)
                  for name, dtype in DTYPES.items()
                  if arrays.get(name) is not None}
        fields["n_prototypes"] = fields["n_prototypes"].reshape(())
        return cls(**fields)

    @property
    def dim(self) -> int:
        return self.protos.shape[1]

    @property
    def device(self) -> torch.device:
        return self.protos.device

    @property
    def n_valid(self) -> int:
        """Count of real prototypes (a host inspection helper; syncs)."""
        return int(self.proto_valid.sum())

    def check_servable(self, expect_dim: Optional[int] = None) -> "ClusterIndex":
        """Raise ``ValueError`` on any structural inconsistency (array
        lengths, a non-2D buffer, an out-of-range valid count, a changed
        feature dimension). Returns ``self``."""
        if self.protos.ndim != 2:
            raise ValueError(
                f"servable index needs (n_max, d) prototypes, got shape "
                f"{tuple(self.protos.shape)}")
        n_max = self.protos.shape[0]
        for name in ("proto_mass", "proto_valid", "proto_labels"):
            a = getattr(self, name)
            if a.ndim != 1 or a.shape[0] != n_max:
                raise ValueError(
                    f"servable index is inconsistent: {name} has shape "
                    f"{tuple(a.shape)}, want ({n_max},) to match protos")
        n = int(self.n_prototypes)
        if not 0 <= n <= n_max:
            raise ValueError(
                f"servable index is inconsistent: n_prototypes={n} outside "
                f"[0, {n_max}]")
        if expect_dim is not None and self.dim != expect_dim:
            raise ValueError(
                f"index dim {self.dim} != expected dim {expect_dim} (a "
                f"tenant's feature dimension cannot change across versions)")
        # the packed buffers must mirror the f32 buffer: a stale copy from
        # another prototype set would serve wrong shortlists silently
        for name in ("protos_bf16", "protos_q8"):
            a = getattr(self, name)
            if a is not None and tuple(a.shape) != tuple(self.protos.shape):
                raise ValueError(
                    f"servable index is inconsistent: {name} has shape "
                    f"{tuple(a.shape)}, want {tuple(self.protos.shape)} to "
                    f"mirror protos")
        if self.protos_q8 is not None:
            for name in ("q8_scale", "q8_zero"):
                a = getattr(self, name)
                if a is None or tuple(a.shape) != (self.dim,):
                    got = None if a is None else tuple(a.shape)
                    raise ValueError(
                        f"servable index is inconsistent: protos_q8 needs "
                        f"{name} of shape ({self.dim},), got {got}")
        return self

    def replicate(self, mesh, axis_name: Optional[str] = None) -> "ClusterIndex":
        """This index made rank 0's on every rank of ``mesh``'s
        ``axis_name`` dimension, bit for bit (a broadcast of each array;
        every rank passes an index of the same shapes, e.g. its own copy
        of a sharded fit's result). Done once, at a service's warmup, it
        keeps the assigns free of index transfers."""
        from repro_torch.core.distributed import _axis

        axis = _axis(mesh, axis_name)
        return ClusterIndex(*(None if a is None else axis.broadcast(a, 0)
                              for a in self))

    def assign(
        self,
        queries: Any,
        *,
        impl: Optional[str] = None,
        block: int = 0,
        block_k: Optional[int] = None,
        rescore_k: int = RESCORE_K,
        route: Optional[str] = None,
        mesh=None,
        axis_name: Optional[str] = None,
    ) -> torch.Tensor:
        """Label ``queries`` (nq, d) by their nearest valid prototype:
        (nq,) int32 backend labels on the index's device (-1 only if the
        index has no valid prototype or the owner is noise). ``block`` > 0
        streams the prototypes in blocks on the composed paths; the fused
        path always streams. The quantized impls (``fused_bf16`` /
        ``fused_int8``) shortlist ``rescore_k`` candidates over the packed
        buffer and rescore them in exact f32. The dispatch goes through
        the ``"assign"`` tuning cell (``ops.resolve_nearest``): with tuning
        on, its winner picks the impl under "auto", and its ``block_k``
        and K1 ``route`` apply where none is passed. Queries on the host
        are moved to the index's device.

        With a mesh (passed or configured) every rank passes the same
        queries and holds the same index: the queries are right-padded to
        a multiple of the rank count, each rank labels its contiguous
        slice, and the slices are all-gathered (then the padding cut), so
        every rank returns all nq labels — those of one device."""
        cfg = active()
        mesh = cfg.mesh if mesh is None else mesh
        if mesh is not None:
            from repro_torch.core.distributed import _axis

            axis = _axis(mesh, axis_name)
            q = as_device_tensor(queries, self.device)
            nq = q.shape[0]
            q = torch.nn.functional.pad(q, (0, 0, 0, (-nq) % axis.size))
            per = q.shape[0] // axis.size
            mine = q[axis.index * per:(axis.index + 1) * per]
            lab = self._assign_here(mine, impl=impl, block=block,
                                    block_k=block_k, rescore_k=rescore_k,
                                    route=route)
            return axis.gather_rows(lab)[:nq]
        return self._assign_here(queries, impl=impl, block=block,
                                 block_k=block_k, rescore_k=rescore_k,
                                 route=route)

    def _assign_here(self, queries: Any, *, impl: Optional[str], block: int,
                     block_k: Optional[int], rescore_k: int,
                     route: Optional[str]) -> torch.Tensor:
        """:meth:`assign` on this device alone."""
        cfg = active()
        q = as_device_tensor(queries, self.device)
        n_max = self.protos.shape[0]
        r, tp = ops.resolve_nearest(impl, dtype=q.dtype, nq=q.shape[0], p=n_max,
                                    d=self.dim, k=1, device=q.device)
        block_k = block_k if block_k is not None else tp.get("block_k")
        route = route if route is not None else tp.get("route")
        if r in ("fused_bf16", "fused_int8"):
            kw = {}
            if r == "fused_int8":
                if self.protos_q8 is not None:
                    keys, scale, zero = self.protos_q8, self.q8_scale, self.q8_zero
                else:
                    keys, scale, zero = quantize_keys(self.protos,
                                                      self.proto_valid)
                kw = dict(keys_scale=scale, keys_zero=zero)
                qq = q
            else:
                keys = (self.protos_bf16 if self.protos_bf16 is not None
                        else self.protos.to(torch.bfloat16))
                qq = q.to(torch.bfloat16)
            shortlist = max(1, min(rescore_k, n_max))
            _, cand = fused_topk(qq, keys, shortlist, self.proto_valid,
                                 block_k=block_k, route=route, **kw)
            _, pid = rescore_top1(q, self.protos, self.proto_valid, cand)
        else:
            protos = self.protos
            if cfg.precision == "bfloat16":
                # serve-side cast; distances still fold in f32. The
                # prototypes come from the frozen bf16 buffer when present
                # (the same bits as casting here)
                q = q.to(torch.bfloat16)
                protos = (self.protos_bf16 if self.protos_bf16 is not None
                          else protos.to(torch.bfloat16))
            _, pid = nearest_valid_prototype(q, protos, self.proto_valid,
                                             impl=r, block=block,
                                             block_k=block_k, route=route)
        pid = pid.to(torch.int64)
        ok = pid >= 0
        return torch.where(ok, self.proto_labels[torch.where(ok, pid, 0)],
                           -1).to(torch.int32)


def nearest_valid_prototype(
    queries: torch.Tensor,
    protos: torch.Tensor,
    valid: torch.Tensor,
    *,
    impl: Optional[str] = None,
    block: int = 0,
    block_k: Optional[int] = None,
    route: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dist, proto_id) of each query's nearest valid prototype (-1 if
    none). The fused policy streams (K1 on the card, on ``route``); the
    composed ones fold prototype blocks into a running best list
    (``block`` > 0) or take one dense (nq, n_max) tile. The dispatch goes
    through the ``"assign"`` tuning cell, as :meth:`ClusterIndex.assign`'s."""
    nq, n_max = queries.shape[0], protos.shape[0]
    r, tp = ops.resolve_nearest(impl, dtype=queries.dtype, nq=nq, p=n_max,
                                d=queries.shape[1], k=1, device=queries.device)
    if r in ops.FUSED_IMPLS:
        bd, bi = ops.nearest_topk(
            queries, protos, 1, key_valid=valid, impl="fused",
            block_k=block_k if block_k is not None else tp.get("block_k"),
            route=route if route is not None else tp.get("route"))
        return bd[:, 0], bi[:, 0]
    if block and block < n_max:
        bd = torch.full((nq, 1), torch.inf, dtype=torch.float32,
                        device=queries.device)
        bi = torch.full((nq, 1), -1, dtype=torch.int32, device=queries.device)
        for lo in range(0, n_max, block):
            hi = min(lo + block, n_max)
            d = ops.pairwise_sq_l2(queries, protos[lo:hi], y_valid=valid[lo:hi],
                                   impl=r)
            gidx = torch.arange(lo, hi, dtype=torch.int64, device=queries.device)
            bd, bi = merge_topk(bd, bi, d, gidx.expand(nq, hi - lo), 1)
        return bd[:, 0], bi[:, 0]
    d = ops.pairwise_sq_l2(queries, protos, y_valid=valid, impl=r)
    if n_max == 0:
        return (torch.full((nq,), torch.inf, device=queries.device),
                torch.full((nq,), -1, dtype=torch.int32, device=queries.device))
    dmin = d.amin(dim=1)
    idx = torch.argmin(d, dim=1).to(torch.int32)
    return dmin, torch.where(torch.isfinite(dmin), idx, -1)
