"""Color utilities over (..., 3) linear-RGB tensors.

Counterpart of ptsharp_tpu/core/color.py for what the port uses: colour
constructors (rgb, the reference's HexColor decode), Rec.709 luminance and
the display gamma.
"""

from __future__ import annotations

import torch

from ptsharp_tpu_torch.core import vec

GAMMA = 2.2


def rgb(r, g, b):
    return torch.tensor([r, g, b], dtype=torch.float32)


def hex_color(x: int):
    """0xRRGGBB -> linear rgb (pow-2.2 decode, as HexColor,
    Colour.cs:125-132)."""
    r = ((x >> 16) & 0xFF) / 255.0
    g = ((x >> 8) & 0xFF) / 255.0
    b = (x & 0xFF) / 255.0
    return torch.tensor([r**GAMMA, g**GAMMA, b**GAMMA], dtype=torch.float32)


def luminance(c):
    """Rec.709 luma."""
    w = torch.tensor([0.2126, 0.7152, 0.0722], dtype=c.dtype, device=c.device)
    return vec.sum_last(c * w)


def to_srgb(c):
    """Linear -> display: pow(1/2.2) + clip."""
    return torch.clamp(torch.abs(c) ** (1.0 / GAMMA), 0.0, 1.0)
