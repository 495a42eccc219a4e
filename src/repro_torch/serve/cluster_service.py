"""Online cluster-assignment service: micro-batched ClusterIndex serving —
the port of ``repro.serve.cluster_service``.

Every request is padded onto a small ladder of bucket shapes and sliced
on return; requests above the top bucket are chunked through it. The
ladder keeps the served shapes few and fixed, so each bucket's work is
one known kernel launch shape; ``warmup()`` runs each bucket once before
traffic under the service's impl (the quantized ones included; on the
card that also builds and loads the kernels) and then zeroes the
counters.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.index import ClusterIndex
from repro_torch.core.plan import as_device_tensor
from repro_torch.runtime import active

DEFAULT_BUCKETS: Tuple[int, ...] = (32, 128, 512, 2048)


class ClusterService:
    """Micro-batching front-end over a fitted index.

    ``buckets`` are the padded batch shapes served (ascending). ``block``
    streams the prototypes inside a composed assign (see
    :func:`repro_torch.core.index.nearest_valid_prototype`).
    """

    def __init__(self, index: ClusterIndex, *,
                 buckets: Sequence[int] = DEFAULT_BUCKETS, block: int = 0,
                 impl: Optional[str] = None):
        if not buckets or any(b < 1 for b in buckets):
            raise ValueError(f"buckets must be positive, got {buckets!r}")
        self.index = index
        self.buckets: Tuple[int, ...] = tuple(sorted(set(int(b) for b in buckets)))
        self.block = block
        self.impl = impl
        self._stats: Dict[str, int] = {
            "requests": 0, "points": 0, "chunks": 0,
            **{f"bucket_{b}": 0 for b in self.buckets},
        }

    @classmethod
    def from_fit(cls, result, **service_kwargs) -> "ClusterService":
        """A service straight from any fitted :class:`FitResult` (every
        executor returns the same artifact), its index packed."""
        return cls(result.to_index(), **service_kwargs)

    def bucket_for(self, n: int) -> int:
        """The bucket an ``n``-row batch pads to (the top bucket if it
        exceeds the ladder — such batches chunk through it)."""
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def assign_bucket(self, queries: torch.Tensor) -> torch.Tensor:
        """Pad one batch of at most the top bucket to its bucket and label it."""
        n = queries.shape[0]
        b = self.bucket_for(n)
        padded = torch.nn.functional.pad(queries, (0, 0, 0, b - n))
        labels = self.index.assign(padded, impl=self.impl, block=self.block)
        self._stats[f"bucket_{b}"] += 1
        self._stats["chunks"] += 1
        return labels[:n]

    def assign(self, queries: Any) -> torch.Tensor:
        """Label an (n, d) request, any n ≥ 0 (chunked above the top
        bucket); host queries move to the index's device."""
        q = as_device_tensor(queries, self.index.device)
        n = q.shape[0]
        self._stats["requests"] += 1
        self._stats["points"] += int(n)
        if n == 0:
            return torch.zeros((0,), dtype=torch.int32, device=self.index.device)
        top = self.buckets[-1]
        if n <= top:
            return self.assign_bucket(q)
        return torch.cat([self.assign_bucket(q[lo:lo + top])
                          for lo in range(0, n, top)])

    def warmup(self) -> None:
        """Run every bucket shape once ahead of traffic, then zero the
        counters (warmup is not traffic). With a mesh in the runtime
        config it first replicates the index over the mesh (every rank
        gets rank 0's bits), and the bucket assigns run on the mesh."""
        mesh = active().mesh
        if mesh is not None:
            self.index = self.index.replicate(mesh)
        d = self.index.dim
        for b in self.buckets:
            self.index.assign(
                torch.zeros((b, d), dtype=self.index.protos.dtype,
                            device=self.index.device),
                impl=self.impl, block=self.block)
        if self.index.device.type == "cuda":
            # repro_torch: allow[HS201]: warm-up ends when its launches have run
            torch.cuda.synchronize(self.index.device)
        self.reset_stats()

    def reset_stats(self) -> None:
        for k in self._stats:
            self._stats[k] = 0

    def stats_snapshot(self, *, reset: bool = False) -> Dict[str, int]:
        """The counters as one snapshot; ``reset=True`` zeroes them in the
        same step."""
        snap = dict(self._stats)
        if reset:
            self.reset_stats()
        return snap

    @property
    def stats(self) -> Dict[str, int]:
        """requests, points, chunks and per-bucket dispatches since
        construction, the last warmup or the last reset."""
        return dict(self._stats)
