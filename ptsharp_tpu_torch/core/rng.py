"""Threefry-2x32 counter-based random numbers, bit-equal to `jax.random`.

The JAX package derives every random draw from explicit threefry keys
(`PRNGKey`, `split`, `fold_in`, `uniform`, `randint`). This module is the
port's explicit generator: the same functions on the same keys give the
same bits, which is what lets the tests compare the two integrators ray by
ray. It follows jax 0.9.0 with `jax_threefry_partitionable=True`:

  * split(key, n)[i]   = threefry(key, (0, i))
  * fold_in(key, d)    = threefry(key, (0, d)) laid out as a key
  * random bits, shape = threefry(key, (hi32(i), lo32(i))) -> b0 ^ b1 for
                         the row-major flat index i
  * uniform            = bitcast((bits >> 9) | 0x3F800000) - 1.0

A key is a (2,) int64 tensor holding two uint32 words. Keys stay on the
CPU (they are tiny and the host threads them through the loops); the bits
for a draw are made on the device the caller names. All 32-bit arithmetic
runs in int64 masked to 32 bits, because torch has no unsigned 32-bit
shifts on every device.
"""

from __future__ import annotations

import math

import torch

from ptsharp_tpu_torch import profiling

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def _threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block (20 rounds) on int64 tensors holding uint32
    words; k0/k1 broadcast against x0/x1."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def PRNGKey(seed: int) -> torch.Tensor:
    """Raw key from an integer seed: (seed >> 32, seed & 0xFFFFFFFF)."""
    seed = int(seed)
    if not 0 <= seed < 2**31:
        raise ValueError(f"seed must be in [0, 2**31), got {seed}")
    return torch.tensor([0, seed], dtype=torch.int64)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """(num, 2) new keys."""
    with profiling.span("pt.rng.keys"):
        cnt = torch.arange(num, dtype=torch.int64, device=key.device)
        b0, b1 = _threefry2x32(key[0], key[1], torch.zeros_like(cnt), cnt)
        return torch.stack([b0, b1], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """A new key that is a function of (key, data); data is a 32-bit int."""
    data = int(data) & _MASK
    with profiling.span("pt.rng.keys"):
        x = torch.tensor([0, data], dtype=torch.int64, device=key.device)
        b0, b1 = _threefry2x32(key[0], key[1], x[:1], x[1:])
        return torch.cat([b0, b1])


def random_bits(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """uint32 words (as int64) of the given shape, made on `device`."""
    with profiling.span("pt.rng.draw"):
        return _bits(key, shape, device)


def _bits(key: torch.Tensor, shape, device) -> torch.Tensor:
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    dev = torch.device(device) if device is not None else key.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    k = key.to(dev)
    b0, b1 = _threefry2x32(k[0], k[1], idx >> 32, idx & _MASK)
    return (b0 ^ b1).reshape(shape)


def _to_uniform(bits: torch.Tensor) -> torch.Tensor:
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """float32 uniforms in [0, 1) of the given shape, made on `device`."""
    with profiling.span("pt.rng.draw"):
        return _to_uniform(_bits(key, shape, device))


def uniform_per_key(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n) float32 uniforms for keys of shape (..., 2): row i is
    uniform(keys[i], (n,)), as jax.vmap of uniform over the keys."""
    with profiling.span("pt.rng.draw"):
        idx = torch.arange(n, dtype=torch.int64, device=keys.device)
        b0, b1 = _threefry2x32(keys[..., 0:1], keys[..., 1:2], idx >> 32,
                               idx & _MASK)
        return _to_uniform(b0 ^ b1)


def _mul32(a, b):
    """(a * b) mod 2**32 for uint32 words held in int64, without int64
    overflow."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def randint(key: torch.Tensor, shape, minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """int32 draws in [minval, maxval), jax's two-word modulus method."""
    with profiling.span("pt.rng.draw"):
        k1, k2 = split(key)
        higher = _bits(k1, shape, device)
        lower = _bits(k2, shape, device)
        span = (int(maxval) - int(minval)) & _MASK
        if int(maxval) <= int(minval):
            span = 1
        mult = (2**16) % span
        mult = ((mult * mult) & _MASK) % span
        off = (_mul32(higher % span, torch.full_like(higher, mult))
               + lower % span) & _MASK
        off = off % span
        return (int(minval) + off).to(torch.int32)
