"""Hierarchical agglomerative clustering (Lance–Williams) — the port of
``repro.cluster.hac``.

The (n, n) dissimilarity matrix of the valid rows comes from K4 on the
card (the reference keeps masked rows in it at +inf; they never merge, so
leaving them out changes no bit of the result); then ``n_valid − k``
merges, each updating one row and column by the
Lance–Williams recurrence, in the reference's float operations and order
(so dyadic inputs give its labels and merge count bit for bit). The
reference runs the merges in ``lax.while_loop``; here the merge count is
read from the device once, and every merge is a fixed sequence of device
ops with the pair (i, j) kept in 0-d device tensors: no merge reads the
device from the host.

Linkages: single / complete / average / ward, weighted by cluster mass (so
prototype masses give the dendrogram HAC would build on the raw units for
ward and average).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.cluster.registry import register_backend
from repro_torch.kernels import ops
from repro_torch.runtime import active

_LINKAGES = ("single", "complete", "average", "ward")


class HACResult(NamedTuple):
    labels: torch.Tensor    # (n,) int32 flat clustering at k clusters, -1 invalid
    n_merges: torch.Tensor  # () int32
    merges: torch.Tensor    # (n_merges, 2) int64: the pair (i < j) of each merge
    heights: torch.Tensor   # (n_merges,) f32: its dissimilarity d(i, j)


def _initial_matrix(x, weights, linkage, impl):
    """The (n, n) dissimilarities of valid rows: sq-L2 (ward: the
    mass-weighted ward cost), Euclidean for the other linkages; +inf on
    the diagonal."""
    big = torch.inf
    d0 = ops.pairwise_sq_l2(x, x, impl=impl)
    if linkage != "ward":
        d0 = torch.sqrt(d0)
    d0.fill_diagonal_(big)
    if linkage == "ward":
        # d(i, j) = (w_i w_j) / (w_i + w_j) ||x_i - x_j||²
        wi = weights[:, None]
        wj = weights[None, :]
        d0 = d0 * wi * wj / torch.clamp_min(wi + wj, 1e-30)
        d0.fill_diagonal_(big)
    return d0


def merge_loop(dmat: torch.Tensor, weights: torch.Tensor, linkage: str,
               merges: int):
    """Run ``merges`` Lance–Williams merges on ``dmat`` (valid rows only;
    updated in place). Returns (assign: each row's representative; alive:
    the rows still representatives; the merged pairs; their heights). The
    pair of each merge stays on the device: no merge reads it."""
    n = dmat.shape[0]
    dev = dmat.device
    big = torch.inf
    assign = torch.arange(n, dtype=torch.int32, device=dev)
    size = weights.clone()
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    pairs = torch.empty((merges, 2), dtype=torch.int64, device=dev)
    heights = torch.empty((merges,), dtype=torch.float32, device=dev)
    for s in range(merges):
        flat = torch.argmin(dmat)  # the first flat index among ties, as jnp.argmin
        a, b = flat // n, flat % n
        i, j = torch.minimum(a, b), torch.maximum(a, b)
        i1, j1 = i.view(1), j.view(1)
        di = dmat.index_select(0, i1)[0]
        dj = dmat.index_select(0, j1)[0]
        dij = di.index_select(0, j1)[0]
        ni = size.index_select(0, i1)[0]
        nj = size.index_select(0, j1)[0]
        nl = size
        if linkage == "single":
            new = torch.minimum(di, dj)
        elif linkage == "complete":
            new = torch.maximum(di, dj)
        elif linkage == "average":
            new = (ni * di + nj * dj) / torch.clamp_min(ni + nj, 1e-30)
        else:  # ward (Lance–Williams with the β term)
            tot = torch.clamp_min(ni + nj + nl, 1e-30)
            new = ((ni + nl) * di + (nj + nl) * dj - nl * dij) / tot
        new = torch.where(alive, new, big)
        new.index_fill_(0, i1, big).index_fill_(0, j1, big)
        dmat.index_copy_(0, i1, new[None, :])
        dmat.index_copy_(1, i1, new[:, None])
        dmat.index_fill_(0, j1, big).index_fill_(1, j1, big)
        assign = torch.where(assign == j, i.to(torch.int32), assign)
        size.index_copy_(0, i1, (ni + nj).view(1))
        size.index_fill_(0, j1, 0.0)
        alive.index_fill_(0, j1, False)
        pairs[s, 0] = i
        pairs[s, 1] = j
        heights[s] = dij
    return assign, alive, pairs, heights


def hac(
    x: torch.Tensor,
    k: int,
    *,
    valid: Optional[torch.Tensor] = None,
    weights: Optional[torch.Tensor] = None,
    linkage: str = "complete",
    impl: Optional[str] = None,
) -> HACResult:
    """Lance–Williams HAC on x's device; ``impl`` defaults to the runtime
    config (the (n, n) matrix: K4 on the card, its plain version under
    "ref")."""
    if linkage not in _LINKAGES:
        raise ValueError(f"linkage {linkage!r} not in {_LINKAGES}")
    impl = active().impl if impl is None else impl
    n = x.shape[0]
    dev = x.device
    valid = (torch.ones((n,), dtype=torch.bool, device=dev) if valid is None
             else valid.bool())
    weights = (torch.ones((n,), dtype=torch.float32, device=dev) if weights is None
               else weights.float())

    # masked rows never merge: HAC runs on the valid rows alone, in their
    # order (a monotone renumbering keeps the first-flat-index tie rule and
    # the representatives' ranks, so the labels are the reference's, which
    # keeps the whole padded buffer)
    keep = torch.nonzero(valid).squeeze(1)  # the one read of the device
    n_valid = keep.numel()
    merges_needed = max(n_valid - max(min(int(k), n_valid), 1), 0)
    wv = weights[keep]
    dmat = _initial_matrix(x[keep], wv, linkage, impl)
    assign, alive, pairs, heights = merge_loop(dmat, wv, linkage, merges_needed)

    # compact the representatives to [0, k)
    rank = torch.cumsum(alive.to(torch.int32), 0, dtype=torch.int32) - 1
    labels = torch.full((n,), -1, dtype=torch.int32, device=dev)
    labels[keep] = rank[assign.long()]
    n_merges = torch.tensor(merges_needed, dtype=torch.int32, device=dev)
    return HACResult(labels, n_merges, keep[pairs], heights)


@register_backend("hac")
def hac_masked(
    x: torch.Tensor,
    *,
    k: int = 3,
    valid: Optional[torch.Tensor] = None,
    weights: Optional[torch.Tensor] = None,
    key: Optional[torch.Tensor] = None,  # unused; uniform backend signature
    linkage: str = "complete",
    impl: Optional[str] = None,
    **_: object,
) -> HACResult:
    """IHTC backend adapter (the planner reads ``.labels``)."""
    del key
    return hac(x, k, valid=valid, weights=weights, linkage=linkage, impl=impl)
