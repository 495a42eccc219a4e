"""Clustering quality metrics of the paper's tables — the port of
``repro.cluster.metrics``:

* prediction accuracy (GMM simulation, Tables 1–2), best label matching;
* BSS/TSS (real-data tables 4–6, 9), on the data's device, its segment
  sums through ``ops.segment_sum`` (K3 on the card, deterministic);
* the bottleneck objective (max within-cluster dissimilarity) and its
  brute-force optimum, which the property tests read.

Accuracy and the bottleneck functions are host numpy: they run once per
experiment on final labels, or on tiny inputs.
"""
from __future__ import annotations

import itertools
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import ops


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def confusion(true: np.ndarray, pred: np.ndarray, k_true: int, k_pred: int
              ) -> np.ndarray:
    m = np.zeros((k_true, k_pred), dtype=np.int64)
    ok = (true >= 0) & (pred >= 0)
    np.add.at(m, (true[ok], pred[ok]), 1)
    return m


def clustering_accuracy(true, pred, k: int) -> float:
    """Fraction correct under the best assignment of predicted clusters to
    true classes: exact permutation search for k ≤ 8, greedy otherwise.
    Unmatched points (label -1) count as errors."""
    true = _host(true)
    pred = _host(pred)
    n = true.shape[0]
    k_pred = max(int(pred.max()) + 1, k) if pred.size and pred.max() >= 0 else k
    m = confusion(true, pred, k, k_pred)
    if k_pred <= 8:
        best = 0
        for perm in itertools.permutations(range(k_pred), min(k, k_pred)):
            best = max(best, sum(m[i, p] for i, p in enumerate(perm) if i < k))
        return best / n
    m = m.astype(np.float64).copy()
    total = 0.0
    for _ in range(min(k, k_pred)):
        i, j = np.unravel_index(np.argmax(m), m.shape)
        total += m[i, j]
        m[i, :] = -1
        m[:, j] = -1
    return total / n


def bss_tss(
    x: torch.Tensor,
    labels: torch.Tensor,
    k: int,
    *,
    weights: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Between-cluster SS / total SS (higher = tighter clusters); rows with
    label -1 are left out. A 0-d f32 tensor on x's device."""
    n = x.shape[0]
    x = x.float()
    w = (torch.ones((n,), dtype=torch.float32, device=x.device) if weights is None
         else weights.float())
    ok = labels >= 0
    w = torch.where(ok, w, 0.0)
    tot_w = torch.clamp_min(torch.sum(w), 1e-30)
    mu = torch.sum(x * w[:, None], dim=0) / tot_w
    tss = torch.sum(w * torch.sum(torch.square(x - mu), dim=1))

    lab_safe = torch.where(ok, labels, k)  # dropped by the segment sum
    sums, mass = ops.segment_sum(x, lab_safe, k, weights=w, impl=impl)
    cent = sums / torch.clamp_min(mass, 1e-30)[:, None]
    own = cent[torch.where(ok, labels, 0).long()]
    wss = torch.sum(w * torch.sum(torch.square(x - own), dim=1) * ok.float())
    # constant or single-point data has tss == 0: report 0.0, not NaN
    return (tss - wss) / torch.clamp_min(tss, 1e-30)


def bottleneck_objective(x, labels) -> float:
    """Max within-cluster pairwise distance (brute force — small n only)."""
    x = _host(x).astype(np.float64)
    labels = _host(labels)
    worst = 0.0
    for c in np.unique(labels[labels >= 0]):
        pts = x[labels == c]
        if len(pts) < 2:
            continue
        d = np.sqrt(((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1))
        worst = max(worst, float(d.max()))
    return worst


def optimal_bottleneck(x, t: int) -> float:
    """Exact optimum λ of the bottleneck threshold partitioning problem by
    brute force over set partitions (n ≤ 10): the property tests hold TC
    to 4λ."""
    x = _host(x).astype(np.float64)
    n = len(x)
    if n > 10:
        raise ValueError(f"optimal_bottleneck: brute force takes n <= 10, got {n}")
    d = np.sqrt(((x[:, None, :] - x[None, :, :]) ** 2).sum(-1))
    best = [np.inf]

    def rec(i, parts):
        if i == n:
            if all(len(p) >= t for p in parts):
                worst = 0.0
                for p in parts:
                    for a in range(len(p)):
                        for b in range(a + 1, len(p)):
                            worst = max(worst, d[p[a], p[b]])
                best[0] = min(best[0], worst)
            return
        for p in parts:
            p.append(i)
            rec(i + 1, parts)
            p.pop()
        parts.append([i])
        rec(i + 1, parts)
        parts.pop()

    rec(0, [])
    return best[0]
