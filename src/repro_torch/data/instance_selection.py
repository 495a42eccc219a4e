"""ITIS instance selection as a data-pipeline stage — the port of
``repro.data.instance_selection``: the paper's technique applied to LM
training corpora.

Flow: featurize each training example (its mean-pooled embedding, from the
model's own embedding table or a fixed random projection), run ITIS at
threshold t* for m iterations, keep one representative example per
prototype (the medoid: the member nearest the centroid) weighted by
cluster mass. The train step's weighted CE (``train_step.cross_entropy``)
then optimises an unbiased estimate of the full-corpus loss on
≥ (t*)^m-fold less data.

On the card ITIS runs K1 at the levels above ``core.knn.AUTO_KNN_BLOCK``
rows and K2 at the others, K3 in every prototype reduce, and the medoid
distances are K4.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch import prng
from repro_torch.core.itis import itis
from repro_torch.core.prototypes import compose_assignments, standardize
from repro_torch.kernels import ops

#: rows of the (rows, s, dim) gather one pooling pass holds
POOL_ROWS = 8192


@dataclass(frozen=True)
class SelectionConfig:
    threshold: int = 2          # t*
    iterations: int = 2         # m  → ≥ 4× corpus reduction
    feature_dim: int = 64       # random-projection feature width
    standardize: bool = True
    weighted: bool = True       # mass-correct centroids through levels
    impl: str = "auto"


class SelectedCorpus(NamedTuple):
    indices: torch.Tensor     # (n_selected_max,) int32 example ids (-1 padding)
    weights: torch.Tensor     # (n_selected_max,) float32 cluster masses
    valid: torch.Tensor       # (n_selected_max,) bool
    assignment: torch.Tensor  # (n,) int32 — the final prototype of each example


def projection(key: torch.Tensor, vocab: int, dim: int, *, device=None
               ) -> torch.Tensor:
    """The fixed random projection (vocab, dim) f32: N(0, 1) / sqrt(dim)."""
    return prng.normal(key, (vocab, dim), device=device) / (dim ** 0.5)


@torch.no_grad()
def featurize(
    tokens: torch.Tensor,  # (n, s) integer ids
    vocab: int,
    dim: int,
    *,
    key: Optional[torch.Tensor] = None,
    embed_table: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean-pooled embedding features (n, dim) f32: the first ``dim``
    columns of the mean of the example's rows of ``embed_table``, else the
    mean of its rows of :func:`projection` (key default ``PRNGKey(7)``).

    The reference gathers the whole (n, s, d) table rows, means them and
    keeps ``[:, :dim]``; each column's mean is its own, so the table is
    cut to ``dim`` columns first and the rows pooled ``POOL_ROWS`` at a
    time, the same numbers in n·s·dim·4 bytes at most ``POOL_ROWS`` rows
    at once."""
    if embed_table is None:
        if key is None:
            key = prng.PRNGKey(7)
        embed_table = projection(key, vocab, dim, device=tokens.device)
    table = embed_table.detach()[:, :dim]
    n = tokens.shape[0]
    out = torch.empty((n, table.shape[1]), dtype=torch.float32, device=table.device)
    for r0 in range(0, n, POOL_ROWS):
        rows = tokens[r0:r0 + POOL_ROWS].to(table.device)
        out[r0:r0 + POOL_ROWS] = torch.mean(table[rows].to(torch.float32), dim=1)
    return out


@torch.no_grad()
def select_instances(
    tokens: torch.Tensor,
    vocab: int,
    scfg: SelectionConfig = SelectionConfig(),
    *,
    key: Optional[torch.Tensor] = None,
    embed_table: Optional[torch.Tensor] = None,
) -> SelectedCorpus:
    """Run ITIS over example features; pick the medoid example per prototype.

    The medoid of a prototype is its member nearest the prototype's
    centroid, ties to the lowest example index: examples ordered by a
    stable sort of that distance, each prototype takes its first member
    in the order (the minimum rank over its members, an integer
    ``scatter_reduce``). The distances are K4's (n, n_max) f32 matrix
    (n_max the last ITIS level's size), n·n_max·4 bytes: at n = 65,536,
    t* = 2, m = 2 that is 65,536 × 16,384 × 4 = 4.3 GB."""
    if key is None:
        key = prng.PRNGKey(0)
    kf, ki = prng.split(key)
    feats = featurize(tokens, vocab, scfg.feature_dim, key=kf,
                      embed_table=embed_table)
    if scfg.standardize:
        feats = standardize(feats)

    r = itis(feats, scfg.threshold, scfg.iterations, key=ki,
             weighted=scfg.weighted, impl=scfg.impl)

    # back out: original example -> final prototype id
    n, dev = feats.shape[0], feats.device
    n_max = r.protos.shape[0]
    if r.assignments:
        ident = torch.arange(n_max, dtype=torch.int32, device=dev)
        assign = compose_assignments(r.assignments, ident)
    else:
        assign = torch.arange(n, dtype=torch.int32, device=dev)

    # medoid per prototype: member closest to the prototype centroid
    d = ops.pairwise_sq_l2(feats, r.protos, impl=scfg.impl)  # (n, n_max)
    ok = assign >= 0
    pid = torch.where(ok, assign, 0).to(torch.int64)
    dmem = torch.where(ok, d.gather(1, pid[:, None])[:, 0], torch.inf)
    del d
    order = torch.argsort(dmem, stable=True)  # best members first
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=dev)
    first = torch.full((n_max,), n, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, pid[ok], rank[ok], reduce="amin")
    taken = first < n
    sel = torch.where(taken, order[torch.clamp_max(first, n - 1)], -1).to(torch.int32)
    return SelectedCorpus(sel, r.mass, r.valid & taken, assign)


def reduced_batch(corpus_tokens: torch.Tensor, selected: SelectedCorpus
                  ) -> Dict[str, torch.Tensor]:
    """The weighted reduced training set (padded rows weigh 0)."""
    idx = selected.indices.to(corpus_tokens.device)
    valid = selected.valid.to(corpus_tokens.device)
    toks = corpus_tokens[torch.where(idx >= 0, idx, 0).to(torch.int64)]
    return {
        "tokens": toks[:, :-1],
        "labels": torch.where(valid[:, None], toks[:, 1:], -1),
        "weights": torch.where(valid, selected.weights.to(corpus_tokens.device),
                               0.0),
    }
