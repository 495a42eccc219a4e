"""Fitted ClusterIndex — the reduced representation as a servable product;
the port of ``repro.core.index`` (f32 assign paths).

The final prototypes and their backend labels are a complete, small
classifier for new points: ``assign`` labels a query batch by its nearest
valid prototype. On the card the default path is K1 with k = 1 (the
streaming top-k); the composed paths (dense or blocked distances plus the
shared merge) remain for the other policies. The bf16/int8 quantized
shortlist of the reference is not ported yet.
"""
from __future__ import annotations

from typing import Any, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.cluster.registry import BackendFn
from repro_torch.core.plan import FitResult, as_device_tensor
from repro_torch.core.plan import fit as _fit
from repro_torch.kernels import ops
from repro_torch.kernels.ref import merge_topk
from repro_torch.runtime import active, resolve_device


class ClusterIndex(NamedTuple):
    """Frozen artifact of an IHTC fit: everything ``assign`` needs."""

    protos: torch.Tensor        # (n_max, d) final-level prototypes (padded)
    proto_mass: torch.Tensor    # (n_max,) original-unit mass per prototype
    proto_valid: torch.Tensor   # (n_max,) bool — real prototype vs padding
    proto_labels: torch.Tensor  # (n_max,) int32 backend labels (-1 = pad/noise)
    n_prototypes: torch.Tensor  # () int32 — valid count

    @classmethod
    def build(
        cls,
        source: Any,
        t: Optional[int] = None,
        m: Optional[int] = None,
        backend: Union[str, BackendFn] = "kmeans",
        **fit_kwargs,
    ) -> "ClusterIndex":
        """Build a servable index from a :class:`FitResult` (freeze it), an
        existing index (returned as is), or raw data (``t``/``m`` required:
        run :func:`repro_torch.fit` with ``fit_kwargs``, then freeze)."""
        if isinstance(source, FitResult):
            if t is not None or m is not None:
                raise TypeError(
                    "ClusterIndex.build: t/m only apply when building from "
                    "raw data; the FitResult already fixed them")
            return cls(protos=source.protos, proto_mass=source.proto_mass,
                       proto_valid=source.proto_valid,
                       proto_labels=source.proto_labels,
                       n_prototypes=source.n_prototypes)
        if isinstance(source, ClusterIndex):
            if t is not None or m is not None:
                raise TypeError(
                    "ClusterIndex.build: t/m only apply when building from "
                    "raw data; the index is already fitted")
            return source
        if t is None or m is None:
            raise TypeError(
                "ClusterIndex.build from raw data needs t and m (got "
                f"t={t!r}, m={m!r}); pass a FitResult to freeze an "
                "already-run fit")
        return cls.build(_fit(source, t, m, backend, **fit_kwargs))

    @classmethod
    def from_numpy(cls, arrays: Mapping[str, Any], *, device=None
                   ) -> "ClusterIndex":
        """An index from host arrays named like the fields (for example the
        fields of a reference index, through ``np.asarray``), placed on
        ``device`` (default: the runtime config's)."""
        dev = resolve_device(device)

        def arr(name, dtype):
            # a copy: the host arrays may be read-only views
            return torch.tensor(np.asarray(arrays[name]), device=dev).to(dtype)

        return cls(protos=arr("protos", torch.float32),
                   proto_mass=arr("proto_mass", torch.float32),
                   proto_valid=arr("proto_valid", torch.bool),
                   proto_labels=arr("proto_labels", torch.int32),
                   n_prototypes=arr("n_prototypes", torch.int32).reshape(()))

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
        return self

    def assign(
        self,
        queries: Any,
        *,
        impl: Optional[str] = None,
        block: int = 0,
        block_k: Optional[int] = None,
    ) -> torch.Tensor:
        """Label ``queries`` (nq, d) by their nearest valid prototype:
        (nq,) int32 backend labels on the index's device (-1 only if the
        index has no valid prototype or the owner is noise). ``block`` > 0
        streams the prototypes in blocks on the composed paths; the fused
        path always streams. Queries on the host are moved to the index's
        device."""
        cfg = active()
        q = as_device_tensor(queries, self.device)
        protos = self.protos
        if cfg.precision == "bfloat16":
            # serve-side cast; distances still fold in f32
            q = q.to(torch.bfloat16).float()
            protos = protos.to(torch.bfloat16).float()
        _, pid = nearest_valid_prototype(q, protos, self.proto_valid,
                                         impl=impl, block=block, block_k=block_k)
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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dist, proto_id) of each query's nearest valid prototype (-1 if
    none). The fused policy streams (K1 on the card); the composed ones
    fold prototype blocks into a running best list (``block`` > 0) or
    take one dense (nq, n_max) tile."""
    nq, n_max = queries.shape[0], protos.shape[0]
    r = ops.resolve(impl, queries.device, fused=True)
    if r == "fused":
        bd, bi = ops.nearest_topk(queries, protos, 1, key_valid=valid,
                                  impl="fused", block_k=block_k)
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
