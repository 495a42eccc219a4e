"""Threshold Clustering (TC), Higgins et al. (2016) — the port of
``repro.core.tc``.

TC partitions n points into clusters of size ≥ t while 4-approximating
the bottleneck objective:

  1. build the (t−1)-NN graph NG;
  2. pick seeds: a maximal independent set of NG², by deterministic
     Luby rounds (a vertex becomes a seed iff its fixed random priority is
     the maximum over its closed 2-hop neighbourhood of active vertices);
  3. grow: cluster(seed) = seed + its NG neighbours;
  4. assign each remaining unit to the seed with the smallest direct
     dissimilarity.

The undirected graph is the directed (n, k) index array plus implicit
reverse edges: a gather for out-edges and a scatter-max for in-edges.
Max and min do not depend on the order of a scatter, so the result is
deterministic on the card too. The MIS loop is a host loop with one
device sync per round; the round count is returned.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import prng
from repro_torch.core.knn import knn_graph, knn_graph_blocked, resolve_auto_block
from repro_torch.kernels.ops import dtype_name
from repro_torch.runtime import active

_NEG = -1  # priorities are ranks in [0, n); -1 == "-inf"


class TCResult(NamedTuple):
    labels: torch.Tensor      # (n,) int32 cluster id in [0, n_clusters), -1 invalid
    seed_of: torch.Tensor     # (n,) int32 vertex index of the owning seed, -1 invalid
    is_seed: torch.Tensor     # (n,) bool
    n_clusters: torch.Tensor  # () int32
    mis_rounds: int = 0       # Luby rounds the seed selection took


def _push_max(p: torch.Tensor, idx: torch.Tensor, idx_ok: torch.Tensor
              ) -> torch.Tensor:
    """max of p over undirected neighbours (directed idx ∪ reverse).
    p: (n,) int64 with -1 as -inf; idx: (n, k) int64; idx_ok: (n, k) bool."""
    n = p.shape[0]
    safe = torch.where(idx_ok, idx, 0)
    out_vals = torch.where(idx_ok, p[safe], _NEG)
    out_max = out_vals.amax(dim=1)
    src_vals = torch.where(idx_ok, p[:, None], _NEG)
    in_max = torch.full((n,), _NEG, dtype=p.dtype, device=p.device)
    in_max.scatter_reduce_(0, safe.reshape(-1), src_vals.reshape(-1), "amax",
                           include_self=True)
    return torch.maximum(out_max, in_max)


def _closed2_max(p: torch.Tensor, idx: torch.Tensor, idx_ok: torch.Tensor
                 ) -> torch.Tensor:
    """max of p over the closed ≤2-hop neighbourhood of each vertex."""
    q1 = torch.maximum(p, _push_max(p, idx, idx_ok))
    return torch.maximum(q1, _push_max(q1, idx, idx_ok))


def luby_mis_rounds(priorities: torch.Tensor, active0: torch.Tensor,
                    closed2_max):
    """Maximal independent set of NG² by parallel local-maxima rounds.
    Returns (is_seed (n,) bool, rounds)."""
    act = active0.clone()
    seed = torch.zeros_like(act)
    rounds = 0
    while bool(act.any()):
        p_eff = torch.where(act, priorities, _NEG)
        m2 = closed2_max(p_eff)
        newly = act & (p_eff == m2)
        seed |= newly
        # deactivate the closed 2-hop neighbourhood of the new seeds
        covered = closed2_max(newly.to(priorities.dtype)) > 0
        act = act & ~covered & ~newly
        rounds += 1
    return seed, rounds


def seed_priorities(key: torch.Tensor, n: int, *, device=None) -> torch.Tensor:
    """Fixed random priorities: ranks of a hashed permutation (the
    reference's bits, via the threefry bridge; stable argsort)."""
    u = prng.uniform(key, (n,), device=device)
    order = torch.argsort(u, stable=True)
    pri = torch.empty((n,), dtype=torch.int64, device=u.device)
    pri[order] = torch.arange(n, dtype=torch.int64, device=u.device)
    return pri


def _sq_dist_rows(x: torch.Tensor, i_rows: torch.Tensor, j_rows: torch.Tensor
                  ) -> torch.Tensor:
    """||x[i] − x[j]||² for index arrays of equal shape (in f32)."""
    a = x[i_rows].float()
    b = x[j_rows].float()
    return torch.sum(torch.square(a - b), dim=-1)


def threshold_clustering(
    x: torch.Tensor,
    t: int,
    *,
    valid: Optional[torch.Tensor] = None,
    key: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
    knn_block: Optional[int] = None,
    knn_route: Optional[str] = None,
) -> TCResult:
    """TC with minimum cluster size ``t`` on (n, d) points, on x's device.

    ``valid`` masks padded rows (they get label -1 and carry no edges);
    ``knn_block`` > 0 forces blocks of that size on the kNN, 0 = auto;
    ``knn_route`` pins the kNN kernel's route on the card (a plan's frozen
    winner; default: the tuned one, else the shape rule).
    Deterministic given ``key`` (default: PRNGKey(0)).
    """
    cfg = active()
    impl = cfg.impl if impl is None else impl
    knn_block = cfg.knn_block if knn_block is None else knn_block
    n = x.shape[0]
    dev = x.device
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
    valid = valid.bool()
    if key is None:
        key = prng.PRNGKey(0)

    if t <= 1:  # degenerate: singletons
        labels = torch.where(valid, torch.cumsum(valid.long(), 0) - 1, -1)
        seed_of = torch.where(valid, torch.arange(n, device=dev), -1)
        return TCResult(labels.to(torch.int32), seed_of.to(torch.int32), valid,
                        valid.sum().to(torch.int32), 0)

    k = t - 1
    block = knn_block or resolve_auto_block(n, x.shape[1], k,
                                            dtype_name(x.dtype), dev)
    if n > block:
        _, idx = knn_graph_blocked(x, k, valid=valid, block=block, impl=impl,
                                   route=knn_route)
    else:
        _, idx = knn_graph(x, k, valid=valid, impl=impl, route=knn_route)
    idx = torch.where(valid[:, None], idx.to(torch.int64), -1)  # invalid rows: no out-edges
    idx_ok = idx >= 0

    priorities = seed_priorities(key, n, device=dev)
    is_seed, rounds = luby_mis_rounds(
        priorities, valid, lambda p: _closed2_max(p, idx, idx_ok))

    # ---- grow: each vertex adjacent to a seed joins that seed (unique by MIS)
    n_arange = torch.arange(n, dtype=torch.int64, device=dev)
    safe = torch.where(idx_ok, idx, 0)
    out_lab = torch.where(idx_ok & is_seed[safe], safe, _NEG).amax(dim=1)
    src = torch.where(idx_ok & is_seed[:, None], n_arange[:, None], _NEG)
    in_lab = torch.full((n,), _NEG, dtype=torch.int64, device=dev)
    in_lab.scatter_reduce_(0, safe.reshape(-1), src.reshape(-1), "amax",
                           include_self=True)
    seed_of = torch.maximum(out_lab, in_lab)
    seed_of = torch.where(is_seed, n_arange, seed_of)

    # ---- assign leftovers (graph distance exactly 2) to the nearest seed
    labeled = seed_of >= 0
    cand_out = torch.where(idx_ok, seed_of[safe], _NEG)        # (n, k)
    cand_ok = cand_out >= 0
    d_out = torch.where(
        cand_ok,
        _sq_dist_rows(x, n_arange[:, None].expand_as(cand_out),
                      torch.where(cand_ok, cand_out, 0)),
        torch.inf,
    )
    best_out_d = d_out.amin(dim=1)
    best_out_s = torch.where(
        torch.isfinite(best_out_d),
        torch.gather(cand_out, 1, torch.argmin(d_out, dim=1, keepdim=True))[:, 0],
        _NEG,
    )
    # in-direction: edge (v -> i) offers seed_of[v] at distance ||x_i - x_seed||
    s_v = seed_of[:, None].expand_as(idx)
    edge_ok = idx_ok & (s_v >= 0)
    d_edge = torch.where(
        edge_ok, _sq_dist_rows(x, safe, torch.where(edge_ok, s_v, 0)), torch.inf)
    tgt = safe.reshape(-1)
    d_in = torch.full((n,), torch.inf, dtype=torch.float32, device=dev)
    d_in.scatter_reduce_(0, tgt, torch.where(edge_ok, d_edge, torch.inf).reshape(-1),
                         "amin", include_self=True)
    winners = edge_ok & (d_edge <= d_in[safe])
    s_in = torch.full((n,), _NEG, dtype=torch.int64, device=dev)
    s_in.scatter_reduce_(0, tgt, torch.where(winners, s_v, _NEG).reshape(-1),
                         "amax", include_self=True)

    use_out = best_out_d <= d_in
    fallback = torch.where(use_out, best_out_s, s_in)
    seed_of = torch.where(labeled, seed_of, fallback)
    seed_of = torch.where(valid, seed_of, _NEG)

    # ---- compact cluster ids: rank among seeds
    seed_rank = torch.cumsum(is_seed.long(), 0) - 1
    has = seed_of >= 0
    labels = torch.where(has, seed_rank[torch.where(has, seed_of, 0)], _NEG)
    n_clusters = is_seed.sum().to(torch.int32)
    return TCResult(labels.to(torch.int32), seed_of.to(torch.int32), is_seed,
                    n_clusters, rounds)
