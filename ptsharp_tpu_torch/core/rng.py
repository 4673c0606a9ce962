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

A key is a (2,) int64 tensor holding two uint32 words, on the CPU (keys
are tiny and the host threads them through the loops). `split` and
`fold_in` read its words once and run the block on Python integers
masked to 32 bits. A draw is made on the device the caller names. On a
CUDA device `uniform` and `randint`, the draws the integrator makes, are
one launch of csrc/threefry.cu each (kernels/threefry.py), which takes
the key's words by value, so no key is copied to the card; on any other
device they run the block in torch ops, int64 tensors masked to 32 bits
(torch has no unsigned 32-bit shifts on every device), the kernel's
plain version. `random_bits` and `uniform_per_key`, which no render or
step calls, have that plain version alone and raise on a CUDA device.
`profiling.draws()` counts draws by path while a profiler records.
"""

from __future__ import annotations

import math

import torch

from ptsharp_tpu_torch import profiling
from ptsharp_tpu_torch.kernels import threefry

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def _threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block (20 rounds) on uint32 words held in Python
    ints or int64 tensors; k0/k1 broadcast against x0/x1."""
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


def _split_words(k0: int, k1: int, num: int) -> list:
    return [_threefry2x32(k0, k1, 0, i) for i in range(num)]


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """(num, 2) new keys."""
    with profiling.span("pt.rng.keys"):
        rows = _split_words(*key.tolist(), int(num))
        return torch.tensor(rows, dtype=torch.int64,
                            device=key.device).reshape(-1, 2)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """A new key that is a function of (key, data); data is a 32-bit int."""
    data = int(data) & _MASK
    with profiling.span("pt.rng.keys"):
        k0, k1 = key.tolist()
        return torch.tensor(_threefry2x32(k0, k1, 0, data),
                            dtype=torch.int64, device=key.device)


def _on_card(dev: torch.device) -> bool:
    """Whether a draw on `dev` launches its kernel (a CUDA device) or runs
    the torch block (any other); counted by path while a profiler
    records."""
    card = dev.type == "cuda"
    profiling.count_draw("kernel" if card else "plain")
    return card


def _plain_only(dev: torch.device, name: str) -> None:
    """A draw with no kernel runs the torch block, on any device but a
    CUDA one; counted as plain while a profiler records."""
    if dev.type == "cuda":
        raise ValueError(f"{name} has no kernel for device {dev}: make it "
                         f"off the card and move it")
    profiling.count_draw("plain")


def _draw_args(key: torch.Tensor, shape, device):
    """The draw's shape as ints, its device, and the key's two words."""
    shape = tuple(int(s) for s in shape)
    dev = torch.device(device) if device is not None else key.device
    return shape, dev, key.tolist()


def _bits_plain(k0: int, k1: int, shape: tuple, dev) -> torch.Tensor:
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=dev)
    b0, b1 = _threefry2x32(k0, k1, idx >> 32, idx & _MASK)
    return (b0 ^ b1).reshape(shape)


def random_bits(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """uint32 words (as int64) of the given shape, made on `device` (not a
    CUDA device)."""
    with profiling.span("pt.rng.draw"):
        shape, dev, (k0, k1) = _draw_args(key, shape, device)
        _plain_only(dev, "random_bits")
        return _bits_plain(k0, k1, shape, dev)


def _to_uniform(bits: torch.Tensor) -> torch.Tensor:
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """float32 uniforms in [0, 1) of the given shape, made on `device`."""
    with profiling.span("pt.rng.draw"):
        shape, dev, (k0, k1) = _draw_args(key, shape, device)
        if _on_card(dev):
            return threefry.uniform(k0, k1, shape, dev)
        return _to_uniform(_bits_plain(k0, k1, shape, dev))


def uniform_per_key(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n) float32 uniforms for keys of shape (..., 2): row i is
    uniform(keys[i], (n,)), as jax.vmap of uniform over the keys. Made on
    the keys' device (not a CUDA device)."""
    with profiling.span("pt.rng.draw"):
        _plain_only(keys.device, "uniform_per_key")
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


def _randint_plain(a0, a1, b0, b1, span, mult, minval, shape, dev):
    higher = _bits_plain(a0, a1, shape, dev)
    lower = _bits_plain(b0, b1, shape, dev)
    off = (_mul32(higher % span, torch.full_like(higher, mult))
           + lower % span) & _MASK
    off = off % span
    return (minval + off).to(torch.int32)


def randint(key: torch.Tensor, shape, minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """int32 draws in [minval, maxval), jax's two-word modulus method: the
    higher and lower words under split(key)'s two keys."""
    with profiling.span("pt.rng.draw"):
        shape, dev, (k0, k1) = _draw_args(key, shape, device)
        (a0, a1), (b0, b1) = _split_words(k0, k1, 2)
        minval, maxval = int(minval), int(maxval)
        span = (maxval - minval) & _MASK if maxval > minval else 1
        mult = (2**16) % span
        mult = ((mult * mult) & _MASK) % span
        draw = threefry.randint if _on_card(dev) else _randint_plain
        return draw(a0, a1, b0, b1, span, mult, minval, shape, dev)
