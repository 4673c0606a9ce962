"""Where the port's entry points put their tensors.

An entry point that takes a `device` (SceneBuilder.build, the examples,
Camera.look_at, Film.zeros, convert.*) runs on the card unless the caller
passes device="cpu". Without a card the default raises: nothing moves to
the CPU on its own.
"""

from __future__ import annotations

import torch

DEFAULT = "cuda"


def resolve(device) -> torch.device:
    """`device` as a torch.device; RuntimeError for a CUDA device when no
    card is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: no CUDA device is "
                           f"available; pass device='cpu' to run on the CPU")
    return dev
