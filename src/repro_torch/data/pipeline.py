"""Deterministic synthetic data — the port of ``repro.data.pipeline``.

Every training batch is a pure function of (seed, step): a restart at step
k regenerates exactly the batches a healthy run would have seen, with no
pipeline state to checkpoint. Tokens follow a Zipfian unigram mixed with
a hidden Markov structure, so the LM loss has signal to descend. The keys
and uniform bits are ``jax.random``'s (``repro_torch.prng``), so a batch
holds the reference's tokens; batches are made on the host unless the
caller names a device, and the caller moves them to the card.

The clustering workload's point streams follow the same contract: each
chunk is a pure function of (seed, chunk index), so a stream is
restartable and chunks can be made anywhere. :func:`stream_to_mesh` feeds
a stream onto a device mesh: every rank reads the same chunks and keeps
only the rows of its own slab, so no full-size buffer exists anywhere.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.frontends import VISION_PREFIX_TOKENS


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    n_states: int = 16          # HMM hidden states
    zipf_a: float = 1.3


def _batch_key(seed: int, step: int) -> torch.Tensor:
    return prng.fold_in(prng.PRNGKey(seed), step)


def synth_tokens(key: torch.Tensor, batch: int, seq: int, vocab: int,
                 dcfg: DataConfig, *, device=None) -> torch.Tensor:
    """Markov-modulated Zipf tokens (b, s+1) int64: learnable structure,
    stateless; the reference's tokens (its Pareto draws bit for bit)."""
    k1, k2, _ = prng.split(key, 3)
    shape = (batch, seq + 1)
    # hidden state per position: slow random walk
    steps = prng.bernoulli(k1, 0.1, shape, device=device).to(torch.int64)
    state = torch.cumsum(steps, dim=1) % dcfg.n_states
    # per-state vocab offset makes next-token statistics state-dependent
    ranks = prng.pareto(k2, dcfg.zipf_a, shape, device=device)
    base = torch.clamp(ranks * 7.0, 0, vocab // 2 - 1).to(torch.int64)
    offset = state * (vocab // (2 * dcfg.n_states))
    return (base + offset) % vocab


def frontend_batch(cfg: ModelConfig, key: torch.Tensor, b: int, s: int, *,
                   device=None) -> Dict[str, torch.Tensor]:
    """The stubbed front end's part of a batch drawn from ``key``, as the
    reference's ``make_batch`` draws it: a VLM's ``patch_embeds`` (b, 256,
    d) from ``fold_in(key, 1)``, an enc-dec model's ``frames`` (b, s, d)
    from ``fold_in(key, 2)``; N(0, 1) · 0.02 in f32, then bf16. Empty for
    an arch without a front end; an unknown front end raises."""
    if not cfg.frontend:
        return {}
    if cfg.frontend == "vision":
        name, fold, shape = "patch_embeds", 1, (b, VISION_PREFIX_TOKENS, cfg.d_model)
    elif cfg.frontend == "audio":
        name, fold, shape = "frames", 2, (b, s, cfg.d_model)
    else:
        raise ValueError(f"{cfg.name}: unknown frontend {cfg.frontend!r}")
    x = prng.normal(prng.fold_in(key, fold), shape, device=device) * 0.02
    return {name: x.to(torch.bfloat16)}


def make_batch(
    cfg: ModelConfig,
    shape: ShapeConfig,
    step: int,
    *,
    dcfg: DataConfig = DataConfig(),
    batch_override: Optional[int] = None,
    seq_override: Optional[int] = None,
    device=None,
) -> Dict[str, torch.Tensor]:
    """Training batch at ``step`` (pure function): ``{"tokens", "labels"}``
    (b, s) int64, with the front end's ``patch_embeds`` or ``frames`` (bf16,
    :func:`frontend_batch`) for the VLM and enc-dec families."""
    b = batch_override or shape.global_batch
    s = seq_override or shape.seq_len
    key = _batch_key(dcfg.seed, step)
    toks = synth_tokens(key, b, s, cfg.vocab_size, dcfg, device=device)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            **frontend_batch(cfg, key, b, s, device=device)}


def batch_iterator(
    cfg: ModelConfig, shape: ShapeConfig, *, start_step: int = 0,
    dcfg: DataConfig = DataConfig(), **kw,
) -> Iterator[Dict[str, torch.Tensor]]:
    step = start_step
    while True:
        yield make_batch(cfg, shape, step, dcfg=dcfg, **kw)
        step += 1


# ---------------------------------------------------------------------------
# Massive point streams for the clustering pipeline
# ---------------------------------------------------------------------------


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


def stream_to_mesh(
    chunks: Iterable[np.ndarray],
    mesh,
    n_total: int,
    d: int,
    *,
    axis_name: str = "data",
    pad_multiple: int = 0,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Feed host-sized chunks onto the mesh without a full-size buffer.

    Every rank iterates the same chunk stream and copies only the rows of
    its slab, ``[r·per, (r+1)·per)`` of the ``n_pad`` padded rows, into one
    slab-sized host buffer, placed on ``device`` (default: the runtime
    config's) once the stream ends: peak host memory is one slab and one
    chunk a rank. Returns ``(x, valid)`` as
    :class:`repro_torch.core.distributed.ShardedRows` — x (n_pad, d), valid
    (n_pad,) False on the padding rows, each rank holding its block —
    which ``repro_torch.fit(x, ..., valid=valid, mesh=mesh)`` takes as they
    are. ``pad_multiple`` defaults to the canonical reduction width rounded
    to the rank count, so the sharded ITIS driver needs no re-padding."""
    from repro_torch.core._collectives import Axis
    from repro_torch.core.distributed import ShardedRows
    from repro_torch.core.itis import round_up
    from repro_torch.core.prototypes import REDUCE_BLOCKS
    from repro_torch.runtime import resolve_device

    axis = Axis(mesh, axis_name)
    p, me = axis.size, axis.index
    mult = round_up(pad_multiple or max(REDUCE_BLOCKS, p), p)
    n_pad = round_up(n_total, mult)
    per = n_pad // p
    lo, hi = me * per, (me + 1) * per
    buf = np.zeros((per, d), np.float32)
    seen = 0
    for chunk in chunks:
        chunk = np.asarray(chunk, np.float32)
        if chunk.ndim != 2 or chunk.shape[1] != d:
            raise ValueError(f"stream_to_mesh: a chunk of shape {chunk.shape}, "
                             f"want (rows, {d})")
        a, b = max(seen, lo), min(seen + chunk.shape[0], hi)
        if b > a:
            buf[a - lo:b - lo] = chunk[a - seen:b - seen]
        seen += chunk.shape[0]
    if seen != n_total:
        raise ValueError(f"stream yielded {seen} rows, expected {n_total}")
    dev = resolve_device(device)
    valid = (lo + torch.arange(per)) < n_total
    return (ShardedRows(torch.from_numpy(buf).to(device=dev, dtype=dtype),
                        (n_pad, d)),
            ShardedRows(valid.to(dev), (n_pad,)))
