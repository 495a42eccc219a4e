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

The reference vmaps one key over every head of a layer; this port
compresses the heads together, as that one key lets it: each level's key
and TC's seed priorities are drawn once, TC's seed rounds, grow and
assignment run over every head's graph at once
(``threshold_clustering_heads``), and each head's kNN graph and
prototype sums stay the one-head calls (K2 and K3 launch per head, as
before), so every head gets the clusters it would get alone, bit for bit.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch

from repro_torch import prng
from repro_torch.core.prototypes import reduce_to_prototypes
from repro_torch.core.tc import seed_priorities, threshold_clustering_heads

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
    out = _compress_heads(k[None], v[None], mass[None], valid[None], t, m,
                          key=key, impl=impl)
    return tuple(a[0] for a in out)


def _compress_heads(
    k: torch.Tensor,      # (H, S, hd)
    v: torch.Tensor,      # (H, S, hd)
    mass: torch.Tensor,   # (H, S) f32
    valid: torch.Tensor,  # (H, S) bool
    t: int,
    m: int,
    *,
    key: Optional[torch.Tensor],
    impl: Optional[str],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``compress_kv_head`` on H sets that draw with one key, at once:
    (k̄ (H, P, hd) f32, v̄, mass (H, P), valid (H, P)). At each level TC
    runs over the H sets together (``threshold_clustering_heads``), then
    each set's keys (its level's prototypes and mass, ITIS's step) and its
    stacked ``[k‖v]`` are reduced with its own labels, one K3 call each."""
    if key is None:
        key = prng.PRNGKey(0)
    H, hd = k.shape[0], k.shape[-1]
    x, w, val = k.float(), mass, valid
    kvx = torch.cat([x, v.float()], dim=-1)
    for level in range(m):
        n = x.shape[1]
        pri = seed_priorities(prng.fold_in(key, level), n, device=x.device)
        labels, _, _ = threshold_clustering_heads(x, t, valid=val, priorities=pri,
                                                  impl=impl)
        n_out = max(n // t, 1)
        heads = []
        for h in range(H):
            ps = reduce_to_prototypes(x[h], labels[h], n_out, weights=w[h],
                                      weighted=True, impl=impl)
            kv = reduce_to_prototypes(kvx[h], labels[h], n_out, weights=w[h],
                                      weighted=True, impl=impl)
            heads.append((ps.x, ps.mass, ps.valid, kv.x))
        x, w, val, kvx = (torch.stack(a) for a in zip(*heads))
    return kvx[..., :hd], kvx[..., hd:], w, val


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

    A cache split along the sequence (``"seq"``, ``"slots"``: a rank's
    slice of a model axis's decode cache) is gathered whole first (an
    exact copy of every rank's slots, cut to the logical ``slots``), so
    every rank compresses the sets one device compresses, with the same
    keys, and keeps its slice of the result: P + tail slots padded to a
    multiple of the ranks (zero slots past P + tail, which the decode's
    position mask hides), ``"slots"`` P + tail.
    """
    if key is None:
        key = prng.PRNGKey(0)
    seq = cache.get("seq")
    if seq is not None:
        cache = gather_cache(cache)
    k, v = cache["k"], cache["v"]  # (b, h, S, hd)
    b, h, S, hd = k.shape
    dev = k.device
    pos = int(cache["pos"])
    mass = cache.get("mass")
    if mass is None:
        mass = torch.ones((b, h, S), dtype=torch.float32, device=dev)
    valid = torch.arange(S, device=dev) < pos

    out = _compress_heads(k.reshape(b * h, S, hd), v.reshape(b * h, S, hd),
                          mass.reshape(b * h, S), valid.expand(b * h, S), t, m,
                          key=key, impl=impl)
    P = out[0].shape[1]
    kbar, vbar, pmass, pvalid = (a.reshape((b, h) + a.shape[1:]) for a in out)
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
    out = {"k": nk, "v": nv, "pos": P, "bias": nbias, "mass": nmass}
    return out if seq is None else _slice(out, seq, total)


def gather_cache(cache: dict) -> dict:
    """A sequence-split cache's k, v and mass gathered along the slots over
    its ``"seq"`` axis (rank order, an exact copy), cut to its logical
    ``"slots"``; with its ``pos``."""
    seq, n = cache["seq"], cache["slots"]
    out = {"pos": cache["pos"]}
    for name in ("k", "v", "mass"):
        if name in cache:
            t = cache[name].movedim(2, 0).contiguous()
            out[name] = seq.gather_rows(t)[:n].movedim(0, 2)
    return out


def _slice(cache: dict, seq, slots: int) -> dict:
    """This rank's slice of a whole compressed cache of ``slots`` slots:
    padded with zero slots (bias 0, mass 1) to a multiple of the ranks."""
    per = -(-slots // seq.size)
    pad = per * seq.size - slots
    lo = seq.index * per
    out = {"pos": cache["pos"], "seq": seq, "slots": slots}
    for name in ("k", "v", "bias", "mass"):
        t = cache[name]
        if pad:
            shape = t.shape[:2] + (pad,) + t.shape[3:]
            fill = torch.ones if name == "mass" else torch.zeros
            t = torch.cat([t, fill(shape, dtype=t.dtype, device=t.device)], dim=2)
        out[name] = t[:, :, lo:lo + per].contiguous()
    return out


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
