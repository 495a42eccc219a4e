"""Weighted k-means (k-means++ seeding, Lloyd iterations), mask-aware —
the port of ``repro.cluster.kmeans``.

The seeding draws with the threefry bridge, so the same key picks the
same centres as the reference. The Lloyd ``while_loop`` is a host loop
with one sync per iteration and the same stopping rule
(``delta > tol and it < iters``); its statistics go through
``ops.blocked_segment_sum``'s fixed 8-block fold.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import prng
from repro_torch.cluster.registry import register_backend
from repro_torch.kernels import ops
from repro_torch.runtime import active


class KMeansResult(NamedTuple):
    centers: torch.Tensor  # (k, d)
    labels: torch.Tensor   # (n,) int32, -1 for invalid rows
    inertia: torch.Tensor  # () weighted within-cluster sum of squares
    iters: int             # Lloyd iterations run


def _plus_plus_init(x, w, valid, k, key, impl):
    """k-means++ seeding with weighted D² sampling."""
    wv = torch.where(valid, w, 0.0)
    key0, key_loop = prng.split(key)
    first = prng.categorical(key0, torch.log(torch.clamp_min(wv, 1e-30)))
    centers = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    centers[0] = x[first]
    slots = torch.arange(k, device=x.device)[None, :]
    for i in range(1, k):
        key_loop, sub = prng.split(key_loop)
        d = ops.pairwise_sq_l2(x, centers, impl=impl)  # (n, k)
        dmin = torch.where(slots < i, d, torch.inf).amin(dim=1)
        logits = torch.log(torch.clamp_min(wv * dmin, 1e-30))
        centers[i] = x[prng.categorical(sub, logits)]
    return centers


def kmeans(
    x: torch.Tensor,
    k: int,
    *,
    valid: Optional[torch.Tensor] = None,
    weights: Optional[torch.Tensor] = None,
    key: Optional[torch.Tensor] = None,
    iters: int = 100,
    tol: float = 1e-6,
    impl: Optional[str] = None,
    n_blocks: Optional[int] = None,
) -> KMeansResult:
    """Weighted k-means on x's device."""
    cfg = active()
    impl = cfg.impl if impl is None else impl
    n_blocks = cfg.n_blocks if n_blocks is None else n_blocks
    n = x.shape[0]
    dev = x.device
    valid = (torch.ones((n,), dtype=torch.bool, device=dev) if valid is None
             else valid.bool())
    weights = (torch.ones((n,), dtype=torch.float32, device=dev) if weights is None
               else weights.float())
    if key is None:
        key = prng.PRNGKey(0)
    w = torch.where(valid, weights, 0.0)

    centers = _plus_plus_init(x, w, valid, k, key, impl)

    def assign(c):
        dist = ops.pairwise_sq_l2(x, c, impl=impl)  # (n, k)
        return torch.argmin(dist, dim=1), dist.amin(dim=1)

    tol_f32 = torch.tensor(tol, dtype=torch.float32, device=dev)
    delta = torch.tensor(torch.inf, dtype=torch.float32, device=dev)
    it = 0
    while it < iters and bool(delta > tol_f32):
        lab, _ = assign(centers)
        lab_safe = torch.where(valid, lab, k)  # dropped by the segment sum
        sums, mass = ops.blocked_segment_sum(x, lab_safe, k, weights=w,
                                             n_blocks=n_blocks, impl=impl)
        new = torch.where((mass > 0)[:, None],
                          sums / torch.clamp_min(mass, 1e-30)[:, None],
                          centers).to(x.dtype)
        delta = torch.sum(torch.square(new - centers), dim=1).amax()
        centers = new
        it += 1
    labels, dmin = assign(centers)
    inertia = torch.sum(torch.where(valid, w * dmin, 0.0))
    labels = torch.where(valid, labels, -1).to(torch.int32)
    return KMeansResult(centers, labels, inertia, it)


@register_backend("kmeans")
def kmeans_masked(
    x: torch.Tensor,
    *,
    k: int = 3,
    valid: Optional[torch.Tensor] = None,
    weights: Optional[torch.Tensor] = None,
    key: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
    iters: int = 100,
    **_: object,
) -> KMeansResult:
    """IHTC backend adapter (the planner reads ``.labels``)."""
    return kmeans(x, k, valid=valid, weights=weights, key=key, iters=iters,
                  impl=impl)
