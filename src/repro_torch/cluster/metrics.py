"""The paper's prediction accuracy (GMM simulation, Tables 1–2) — the port
of ``repro.cluster.metrics.clustering_accuracy``. Host numpy: it runs
once per experiment on final labels."""
from __future__ import annotations

import itertools

import numpy as np
import torch


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
