"""Threefry-2x32 draws on the card: wrappers of csrc/threefry.cu.

core/rng.py calls these for a uniform or randint draw (the main path's
two) whose output lies on a CUDA device, with the key's words as Python
integers (it derives keys on the host), so a draw is one launch on the
current stream, copies nothing to the card and does not wait for it. Their plain versions are core/rng.py's torch
block, which rng runs for a draw on any other device; each kernel equals
its plain version bit for bit (tests/test_torch_rng_kernel.py).

  uniform(k0, k1, shape, device)           float32 in [0, 1)
  randint(a0, a1, b0, b1, span, mult, minval, shape, device)
                                           int32 in [minval, minval + span)

Each launch goes through kernels/build.py `launch`, which adds one to
the wrapper's `launches` count and the words it wrote to its `words` (a
draw of no words launches nothing);
`reset_launch_counts()` clears them. A device other than CUDA raises:
there is no fallback from a kernel to the plain version.
"""

from __future__ import annotations

import torch

from ptsharp_tpu_torch.kernels import build

_MASK = 0xFFFFFFFF


def _launch(wrapper, entry: str, out: torch.Tensor, *args) -> torch.Tensor:
    """Call the C entry for `out` (allocated on a CUDA device) on the
    current stream, count the launch and its words; nothing for an empty
    draw."""
    n = out.numel()
    if n:
        build.launch(wrapper, entry, out.device, out.data_ptr(), *args,
                     words=n)
    return out


def _card(device) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"no threefry kernel for device {dev}")
    return dev


def _words(*words: int) -> tuple:
    if any(not 0 <= w <= _MASK for w in words):
        raise ValueError(f"key words must be uint32 values, got {words}")
    return words


def uniform(k0: int, k1: int, shape, device) -> torch.Tensor:
    """float32 uniforms under key (k0, k1)."""
    dev, words = _card(device), _words(k0, k1)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    return _launch(uniform, "pt_threefry_uniform", out, out.numel(), *words)


def randint(a0: int, a1: int, b0: int, b1: int, span: int, mult: int,
            minval: int, shape, device) -> torch.Tensor:
    """int32 draws minval + off, off from the words under the sub-keys
    (a0, a1) (higher) and (b0, b1) (lower) by jax's two-word modulus with
    span in [1, 2^32) and mult = (2^16 % span)^2 % span."""
    if not 1 <= span <= _MASK:
        raise ValueError(f"span must be in [1, 2**32), got {span}")
    dev, words = _card(device), _words(a0, a1, b0, b1, span, mult)
    out = torch.empty(shape, dtype=torch.int32, device=dev)
    return _launch(randint, "pt_threefry_randint", out, out.numel(), *words,
                   int(minval))


WRAPPERS = (uniform, randint)
for _w in WRAPPERS:
    _w.launches = _w.words = 0


def reset_launch_counts() -> None:
    """Set every wrapper's `launches` and `words` to 0."""
    for w in WRAPPERS:
        w.launches = w.words = 0
