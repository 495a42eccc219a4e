"""Massive point streams for the streaming fit — the port's copy of the
point-stream part of ``repro.data.pipeline`` (host numpy only, the same
draws for the same seed).

A stream is a deterministic synthetic point cloud generated chunk by
chunk: each chunk is a pure function of (seed, chunk index), so a stream
is restartable and chunks can be made anywhere.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class PointStreamConfig:
    """``kind="gmm"`` draws the paper's §4 mixture (3 bivariate Gaussians,
    weights .5/.3/.2, d forced to 2); ``kind="blobs"`` draws a ``k``-blob
    mixture in ``d`` dimensions (the Table-3 dataset analogs)."""
    n: int
    d: int = 2
    chunk: int = 65_536
    seed: int = 0
    kind: str = "gmm"
    k: int = 4


_GMM_MUS = np.array([[1, 2], [7, 8], [3, 5]], float)
_GMM_SDS = np.array([[1, 0.5], [2, 1], [3, 4]], float) ** 0.5


def point_chunk(cfg: PointStreamConfig, chunk_idx: int, *,
                with_labels: bool = False):
    """Chunk ``chunk_idx`` of the stream (pure function; float32 (c, d)).
    ``with_labels=True`` also returns the generating component of every
    row ((c,) int64), the ground truth an accuracy is measured against."""
    start = chunk_idx * cfg.chunk
    c = min(cfg.chunk, cfg.n - start)
    if c <= 0:
        x = np.zeros((0, cfg.d), np.float32)
        return (x, np.zeros((0,), np.int64)) if with_labels else x
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, chunk_idx]))
    if cfg.kind == "gmm":
        comp = rng.choice(3, size=c, p=[0.5, 0.3, 0.2])
        x = _GMM_MUS[comp] + rng.normal(size=(c, 2)) * _GMM_SDS[comp]
    elif cfg.kind == "blobs":
        centers_rng = np.random.default_rng(cfg.seed)  # shared across chunks
        centers = centers_rng.normal(scale=4.0, size=(cfg.k, cfg.d))
        scales = centers_rng.uniform(0.5, 1.5, size=(cfg.k, cfg.d))
        comp = rng.integers(0, cfg.k, size=c)
        x = centers[comp] + rng.normal(size=(c, cfg.d)) * scales[comp]
    else:
        raise ValueError(f"unknown point-stream kind {cfg.kind!r}")
    x = x.astype(np.float32)
    return (x, comp.astype(np.int64)) if with_labels else x


def point_chunks(cfg: PointStreamConfig) -> Iterator[np.ndarray]:
    """All chunks of the stream, in order."""
    n_chunks = -(-cfg.n // cfg.chunk)
    for i in range(n_chunks):
        yield point_chunk(cfg, i)
