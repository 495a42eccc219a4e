"""IHTC KV-cache prototype compression — the port of
``repro.serve.kv_compression``: the paper's instance selection applied
to a KV cache.

The S entries of one (batch, kv-head) cache form a point set. Threshold
clustering at t collapses it to ≤ S/t prototypes: the cluster-mean key
and value, with the cluster's mass. Attention over the prototypes with an
additive ``log(mass)`` logit bias equals attention over the original
entries when a cluster's keys are identical; otherwise the error is
bounded by the cluster radius, the objective TC 4-approximates. m levels
give a (t)^m reduction.

TC runs on the keys alone (K2 builds its kNN graph at d = head_dim, K3
reduces the keys); the stacked ``[k‖v]`` payload (d = 2·head_dim) is then
reduced with the same assignment (K3 again). The compressed cache is a
regular cache plus "bias" and "mass", with ``tail`` empty slots for new
tokens after the P prototypes and ``pos = P``.

The reference vmaps one key over every head of a layer; this port loops
over the heads with that same key, which gives the same clusters.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch

from repro_torch import prng
from repro_torch.core.itis import itis_step
from repro_torch.core.prototypes import reduce_to_prototypes

_MASKED = -1e30


def compress_kv_head(
    k: torch.Tensor,      # (S, hd)
    v: torch.Tensor,      # (S, hd)
    mass: torch.Tensor,   # (S,) f32: 1 for raw entries, more once compressed
    valid: torch.Tensor,  # (S,) bool
    t: int,
    m: int = 1,
    *,
    key: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compress one head's KV set by t^m: (k̄ (P, hd) f32, v̄, mass,
    valid) with P = S // t^m. Level l draws with ``fold_in(key, l)``."""
    if key is None:
        key = prng.PRNGKey(0)
    hd = k.shape[-1]
    x, w, val = k.float(), mass, valid
    kvx = torch.cat([x, v.float()], dim=-1)
    for level in range(m):
        out = itis_step(x, w, val, t, key=prng.fold_in(key, level),
                        weighted=True, impl=impl)
        ps = reduce_to_prototypes(kvx, out.assignment, out.protos.shape[0],
                                  weights=w, weighted=True, impl=impl)
        x, w, val, kvx = out.protos, out.mass, out.valid, ps.x
    return kvx[:, :hd], kvx[:, hd:], w, val


def compress_cache(
    cache: dict,
    t: int = 2,
    m: int = 1,
    *,
    tail: int = 128,
    key: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
) -> dict:
    """Compress one layer's cache {"k", "v", "pos"[, "bias", "mass"]}.

    Every (batch, kv-head) set is compressed with the same key. The result
    holds P + tail slots: the prototypes with bias ``log(max(mass, 1e-9))``
    (−1e30 on empty prototypes), then ``tail`` zero slots with bias 0 and
    mass 1; ``pos = P``. Slots at or past the old ``pos`` are not part of
    the set.
    """
    if key is None:
        key = prng.PRNGKey(0)
    k, v = cache["k"], cache["v"]  # (b, h, S, hd)
    b, h, S, hd = k.shape
    dev = k.device
    pos = int(cache["pos"])
    mass = cache.get("mass")
    if mass is None:
        mass = torch.ones((b, h, S), dtype=torch.float32, device=dev)
    valid = torch.arange(S, device=dev) < pos

    heads = [compress_kv_head(k[i, j], v[i, j], mass[i, j], valid, t, m,
                              key=key, impl=impl)
             for i in range(b) for j in range(h)]
    P = heads[0][0].shape[0]

    def stack(n: int) -> torch.Tensor:
        return torch.stack([hh[n] for hh in heads]).reshape(
            (b, h) + heads[0][n].shape)

    kbar, vbar, pmass, pvalid = stack(0), stack(1), stack(2), stack(3)
    total = P + tail
    nk = torch.zeros((b, h, total, hd), dtype=k.dtype, device=dev)
    nv = torch.zeros((b, h, total, hd), dtype=v.dtype, device=dev)
    nk[:, :, :P] = kbar.to(k.dtype)
    nv[:, :, :P] = vbar.to(v.dtype)
    nbias = torch.zeros((b, h, total), dtype=torch.float32, device=dev)
    nbias[:, :, :P] = torch.where(
        pvalid, torch.log(torch.clamp_min(pmass, 1e-9)), _MASKED)
    nmass = torch.ones((b, h, total), dtype=torch.float32, device=dev)
    nmass[:, :, :P] = torch.where(pvalid, pmass, 1.0)
    return {"k": nk, "v": nv, "pos": P, "bias": nbias, "mass": nmass}


def _is_attn(c) -> bool:
    return isinstance(c, dict) and "k" in c and "pos" in c


def layer_keys(caches, key: torch.Tensor) -> list:
    """The key each layer's compression draws with, as the reference
    derives it: a stand-alone layer i gets ``fold_in(key, i)``; every
    repeat of sublayer j of the stacked group gets ``fold_in(key, 100 + j)``
    (the reference folds the repeat axis into the batch). The index counts
    every layer, Mamba ones too: in a hybrid whose group mixes Mamba and
    attention, the attention sublayer j keeps its own key."""
    if isinstance(caches, dict):
        n_prefix, period = caches["n_prefix"], caches["period"]
        return [prng.fold_in(key, l) if l < n_prefix
                else prng.fold_in(key, 100 + (l - n_prefix) % period)
                for l in range(len(caches["layers"]))]
    return [prng.fold_in(key, i) for i in range(len(caches))]


def compress_model_caches(caches, t: int = 2, m: int = 1, *, tail: int = 128,
                          key: Optional[torch.Tensor] = None,
                          impl: Optional[str] = None):
    """Compress every attention layer's cache; Mamba states (and any other
    entry) pass through untouched, as the same objects.

    Takes the LM layout ``{"layers": [...], "n_prefix", "period"}``
    (``transformer.init_lm_caches``) or a plain per-layer list."""
    if key is None:
        key = prng.PRNGKey(0)
    layers = caches["layers"] if isinstance(caches, dict) else caches
    out = [compress_cache(c, t, m, tail=tail, key=lk, impl=impl)
           if _is_attn(c) else c
           for c, lk in zip(layers, layer_keys(caches, key), strict=True)]
    return {**caches, "layers": out} if isinstance(caches, dict) else out


def find_attention_caches(caches) -> Iterator[dict]:
    """Yield the attention-cache dicts of either layout (of an enc-dec
    cache, each decoder layer's self-attention cache)."""
    layers = caches["layers"] if isinstance(caches, dict) else caches
    for c in layers:
        if isinstance(c, dict) and "self" in c:
            c = c["self"]
        if isinstance(c, dict) and "k" in c:
            yield c
