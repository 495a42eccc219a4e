"""Bit-exact threefry2x32 keys and draws, as ``jax.random`` makes them.

The reference fit draws its TC seed priorities and its k-means++ picks
with ``jax.random`` (threefry2x32 with ``jax_threefry_partitionable``
on). The same seed must give the same seeds and centres here, so this
module reimplements those draws in int64 torch arithmetic instead of
using a ``torch.Generator``:

  * a key is a (2,) int64 CPU tensor holding two uint32 words;
  * :func:`split` and :func:`random_bits` hash the 64-bit iota of the
    output shape (high word, low word) with the key;
  * :func:`uniform` puts 23 random bits under a 1.0 exponent;
  * :func:`categorical` is Gumbel-argmax with ``-log(-log(u))`` noise (the
    reference's default low-range mode). Its ``log`` may differ from
    XLA's by an ulp, so draws agree wherever no two noisy logits tie
    within an ulp.

The counters are computed on the device the caller names; keys stay on
the CPU, so reading a key never synchronises with the card.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY_F32 = float(np.finfo(np.float32).tiny)

Shape = Union[int, Sequence[int]]


def PRNGKey(seed: int) -> torch.Tensor:
    """Key of an integer seed: ``[0, seed mod 2**32]``, as the reference
    builds it with 64-bit integers disabled."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64)


def key_from_numpy(key) -> torch.Tensor:
    """A ``uint32[2]`` key (for example ``np.asarray(jax.random.PRNGKey(0))``)
    as this module's key tensor."""
    a = np.asarray(key)
    if a.shape != (2,):
        raise ValueError(f"a raw threefry key has shape (2,), got {a.shape}")
    return torch.tensor([int(v) & _M32 for v in a.tolist()], dtype=torch.int64)


def key_to_numpy(key: torch.Tensor) -> np.ndarray:
    """Inverse of :func:`key_from_numpy`: the key as ``uint32[2]``."""
    return np.asarray(key.tolist(), dtype=np.uint32)


def _words(key: torch.Tensor) -> Tuple[int, int]:
    k = key.tolist()
    if len(k) != 2:
        raise ValueError(f"expected a (2,) key, got shape {tuple(key.shape)}")
    return int(k[0]) & _M32, int(k[1]) & _M32


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k1: int, k2: int, x0: torch.Tensor, x1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds on int64 tensors of uint32 words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)


def _hash_iota(key: torch.Tensor, shape: Tuple[int, ...], device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both threefry output words for the flat 64-bit iota of ``shape``."""
    n = int(np.prod(shape)) if shape else 1
    iota = torch.arange(n, dtype=torch.int64, device=device)
    k1, k2 = _words(key)
    b1, b2 = threefry2x32(k1, k2, iota >> 32, iota & _M32)
    return b1.reshape(shape), b2.reshape(shape)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``num`` new keys, shape (num, 2)."""
    b1, b2 = _hash_iota(key, (int(num),), "cpu")
    return torch.stack([b1, b2], dim=1)


def random_bits(key: torch.Tensor, shape: Shape, *, device=None) -> torch.Tensor:
    """Uniform uint32 words (held in int64) of the given shape."""
    b1, b2 = _hash_iota(key, _shape(shape), device)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Shape, *, minval: float = 0.0,
            maxval: float = 1.0, device=None) -> torch.Tensor:
    """float32 draws in [minval, maxval): bit-equal to the reference on
    [0, 1) and on the Gumbel range; elsewhere XLA may contract the scale
    and shift into an fma, one ulp away."""
    bits = random_bits(key, shape, device=device)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=floats.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=floats.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key: torch.Tensor, shape: Shape, *, device=None) -> torch.Tensor:
    """float32 Gumbel noise, the reference's low-range mode."""
    u = uniform(key, shape, minval=_TINY_F32, maxval=1.0, device=device)
    return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """One draw per row from ``softmax(logits)`` over the last axis
    (Gumbel-argmax; the first maximum wins a tie)."""
    noise = gumbel(key, tuple(logits.shape), device=logits.device)
    return torch.argmax(noise.to(logits.dtype) + logits, dim=-1)
