"""The paper's GMM and Gaussian-mixture analogs of its Table-3 datasets.

A copy of the generators the JAX package's benchmarks use
(``benchmarks/common.py``), so the same seed gives the same data on a
machine that has no JAX. Host numpy; every draw comes from a seeded
``numpy.random.default_rng``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


def gmm_sample(n: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Paper §4: a mixture of three bivariate Gaussians (.5/.3/.2).
    Returns (x (n, 2) float32, component (n,))."""
    rng = np.random.default_rng(seed)
    mus = np.array([[1, 2], [7, 8], [3, 5]], float)
    sds = np.array([[1, 0.5], [2, 1], [3, 4]], float) ** 0.5
    comp = rng.choice(3, size=n, p=[0.5, 0.3, 0.2])
    x = mus[comp] + rng.normal(size=(n, 2)) * sds[comp]
    return x.astype(np.float32), comp


@dataclass(frozen=True)
class DatasetSpec:
    """Shape of one of the paper's Table-3 real datasets: n rows, d numeric
    features, k clusters requested in the paper's experiments."""
    name: str
    n: int
    d: int
    k: int


PAPER_DATASETS = [
    DatasetSpec("pm25", 41_757, 5, 4),
    DatasetSpec("credit_score", 120_269, 6, 5),
    DatasetSpec("black_friday", 166_986, 7, 4),
    DatasetSpec("covertype", 581_012, 6, 7),
    DatasetSpec("house_price", 2_885_485, 5, 5),
    DatasetSpec("stock", 7_026_593, 5, 7),
]


def dataset_analog(spec: DatasetSpec, seed: int = 0, max_n: int = 0,
                   return_components: bool = False):
    """A k-component Gaussian mixture with the spec's (n, d, k); ``max_n``
    truncates. With ``return_components`` also the component of each row."""
    n = min(spec.n, max_n) if max_n else spec.n
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=4.0, size=(spec.k, spec.d))
    comp = rng.integers(0, spec.k, size=n)
    scales = rng.uniform(0.5, 1.5, size=(spec.k, spec.d))
    x = (centers[comp] + rng.normal(size=(n, spec.d)) * scales[comp]).astype(np.float32)
    return (x, comp) if return_components else x
