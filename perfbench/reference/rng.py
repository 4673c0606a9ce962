"""Threefry-2x32 counter-based random numbers, as jax.random computes
them with `jax_threefry_partitionable` (jax >= 0.5): every draw is a pure
function of (key, flat index), so any subset of lanes can be drawn alone.

  split(key, n)[i] = threefry(key, (0, i))
  fold_in(key, d)  = threefry(key, (0, d))
  bits(key)[i]     = w0 ^ w1 of threefry(key, (i >> 32, i & 0xFFFFFFFF))
  uniform          = float32 bits ((b >> 9) | 0x3F800000) - 1

Keys are Python tuples of two ints (they live on the host); the bits are
computed in int64 tensors masked to 32 bits on the device of the index
tensor.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry(k0, k1, x0, x1):
    """The 20-round Threefry-2x32 block on uint32 words: Python ints or
    int64 tensors (k0, k1 broadcast against x0, x1)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def key(seed: int) -> tuple:
    """The raw key of a 31-bit seed, as jax.random.PRNGKey makes it."""
    if not 0 <= seed < 2**31:
        raise ValueError(f"seed {seed} is not in [0, 2**31)")
    return (0, seed)


def split(k: tuple, n: int = 2) -> list:
    return [threefry(k[0], k[1], 0, i) for i in range(n)]


def fold_in(k: tuple, data: int) -> tuple:
    return threefry(k[0], k[1], 0, int(data) & MASK)


def bits_at(k: tuple, idx: torch.Tensor) -> torch.Tensor:
    """The uint32 draws (int64) at flat indices `idx` of an array drawn
    from key k."""
    idx = idx.to(torch.int64)
    w0, w1 = threefry(k[0], k[1], idx >> 32, idx & MASK)
    return w0 ^ w1


def uniform_at(k: tuple, idx: torch.Tensor) -> torch.Tensor:
    """float32 uniforms in [0, 1) at flat indices `idx`."""
    b = (bits_at(k, idx) >> 9) | 0x3F800000
    return b.to(torch.int32).view(torch.float32) - 1.0
