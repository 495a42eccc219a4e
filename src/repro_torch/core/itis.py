"""ITIS — Iterated Threshold Instance Selection (the paper's §3.1), the
port of ``repro.core.itis``.

Repeat {TC at threshold t → collapse clusters to prototypes} m times. Level
l lives in a padded buffer of size n₀ // t^l with a validity mask, as in
the reference, so both draw the same random bits for the same key. The
host driver stops early when too few valid points remain.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch

from repro_torch import prng
from repro_torch.core.prototypes import reduce_to_prototypes
from repro_torch.core.tc import threshold_clustering
from repro_torch.runtime import active


def round_up(n: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` that is ≥ ``n``."""
    if multiple <= 1:
        return n
    return ((n + multiple - 1) // multiple) * multiple


def validate_reduction_params(
    t: int, m: int, *, n: Optional[int] = None, min_m: int = 0,
    driver: str = "itis",
) -> None:
    """Reject t/m values every ITIS-family driver would mishandle: t < 2
    never shrinks the point set, m below ``min_m`` is meaningless, and TC's
    k = t−1 graph needs t − 1 < n."""
    if int(t) != t or t < 2:
        raise ValueError(
            f"{driver}: threshold t must be an integer >= 2 (t={t!r} would "
            f"never shrink the point set, so every level stays full-size)")
    if int(m) != m or m < min_m:
        raise ValueError(
            f"{driver}: iteration count m must be an integer >= {min_m}, "
            f"got {m!r}")
    if n is not None and m >= 1 and t - 1 >= n:
        raise ValueError(
            f"{driver}: TC builds a k = t-1 = {t - 1} nearest-neighbour "
            f"graph, which needs t - 1 < n points; got n={n}")


def level_sizes(n0: int, t: int, m: int, *, multiple: int = 1) -> List[int]:
    """Buffer size of every ITIS level, levels 0..m inclusive."""
    validate_reduction_params(t, m, driver="level_sizes")
    sizes = [round_up(n0, multiple)]
    for _ in range(m):
        sizes.append(round_up(max(sizes[-1] // t, 1), multiple))
    return sizes


class ITISLevelOut(NamedTuple):
    protos: torch.Tensor      # (n_out_max, d)
    mass: torch.Tensor        # (n_out_max,)
    valid: torch.Tensor       # (n_out_max,) bool
    assignment: torch.Tensor  # (n_in,) int32 → [0, n_out_max), -1 for padding
    n_clusters: torch.Tensor  # () int32
    mis_rounds: int = 0


class ITISResult(NamedTuple):
    protos: torch.Tensor               # final level prototypes (padded)
    mass: torch.Tensor
    valid: torch.Tensor
    assignments: Sequence[torch.Tensor]  # one per level, for back-out
    n_prototypes: torch.Tensor           # () int32 — valid count at final level
    mis_rounds: Sequence[int] = ()       # Luby rounds of each level's TC
    n_valid: Sequence[int] = ()          # valid points entering each level


def itis_step(
    x: torch.Tensor,
    mass: torch.Tensor,
    valid: torch.Tensor,
    t: int,
    *,
    key: torch.Tensor,
    weighted: bool = False,
    impl: Optional[str] = None,
    knn_block: Optional[int] = None,
    n_out: Optional[int] = None,
    n_blocks: Optional[int] = None,
    knn_route: Optional[str] = None,
) -> ITISLevelOut:
    """One ITIS level: TC on the valid points, reduce to ≤ n//t prototypes."""
    n = x.shape[0]
    if n_out is None:
        n_out = max(n // t, 1)
    tc = threshold_clustering(x, t, valid=valid, key=key, impl=impl,
                              knn_block=knn_block, knn_route=knn_route)
    ps = reduce_to_prototypes(x, tc.labels, n_out, weights=mass,
                              weighted=weighted, impl=impl, n_blocks=n_blocks)
    return ITISLevelOut(ps.x, ps.mass, ps.valid, tc.labels, tc.n_clusters,
                        tc.mis_rounds)


def itis(
    x: torch.Tensor,
    t: int,
    m: int,
    *,
    weights: Optional[torch.Tensor] = None,
    key: Optional[torch.Tensor] = None,
    weighted: bool = False,
    impl: Optional[str] = None,
    knn_block: Optional[int] = None,
    min_points: int = 4,
    pad_multiple: int = 1,
    n_blocks: Optional[int] = None,
    knn_route: Optional[str] = None,
) -> ITISResult:
    """Run m ITIS levels on x's device (host driver). Stops early when
    fewer than ``max(min_points, 2*t)`` valid points remain."""
    cfg = active()
    impl = cfg.impl if impl is None else impl
    knn_block = cfg.knn_block if knn_block is None else knn_block
    n_blocks = cfg.n_blocks if n_blocks is None else n_blocks
    validate_reduction_params(t, m, n=x.shape[0], driver="itis")
    if key is None:
        key = prng.PRNGKey(0)
    n = x.shape[0]
    dev = x.device
    mass = (torch.ones((n,), dtype=torch.float32, device=dev) if weights is None
            else weights.float())
    valid = torch.ones((n,), dtype=torch.bool, device=dev)

    sizes = level_sizes(n, t, m, multiple=pad_multiple)
    if sizes[0] != n:
        pad = sizes[0] - n
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        mass = torch.nn.functional.pad(mass, (0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))

    assignments, rounds, n_valid_seen = [], [], []
    cur_x, cur_m, cur_v = x, mass, valid
    n_protos = cur_v.sum().to(torch.int32)
    for level in range(m):
        # repro_torch: allow[HS202]: one read a level, the early-exit floor (the reference's host decision)
        n_valid = int(cur_v.sum())  # the early-exit floor is a host decision
        if n_valid < max(min_points, 2 * t):
            break
        key, sub = prng.split(key)
        out = itis_step(cur_x, cur_m, cur_v, t, key=sub, weighted=weighted,
                        impl=impl, knn_block=knn_block, n_out=sizes[level + 1],
                        n_blocks=n_blocks, knn_route=knn_route)
        assignments.append(out.assignment)
        rounds.append(out.mis_rounds)
        n_valid_seen.append(n_valid)
        cur_x, cur_m, cur_v = out.protos, out.mass, out.valid
        n_protos = out.n_clusters
    return ITISResult(cur_x, cur_m, cur_v, assignments, n_protos, rounds,
                      n_valid_seen)
