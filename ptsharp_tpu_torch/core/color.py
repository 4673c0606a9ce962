"""Color utilities over (..., 3) linear-RGB tensors.

Counterpart of ptsharp_tpu/core/color.py: colour constructors (rgb, the
reference's HexColor decode, the blackbody Kelvin fit), Rec.709
luminance, mix and the display gamma both ways.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ptsharp_tpu_torch.core import vec

# numpy, as in the JAX package: module-level constants hold no device
BLACK = np.zeros(3, np.float32)
WHITE = np.ones(3, np.float32)

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


def kelvin(k: float):
    """Blackbody color temperature fit, the piecewise log fit of the
    reference's Colour.Kelvin (Colour.cs:157-217). Host-side scalar math
    in float64, rounded once to a (3,) float32 tensor in [0, 1]."""
    if k >= 6600.0:
        x = k / 100.0 - 55.0
        red = (351.97690566805693 + 0.114206453784165 * x
               - 40.25366309332127 * math.log(x))
    else:
        red = 255.0
    if k >= 6600.0:
        x = k / 100.0 - 50.0
        green = (325.4494125711974 + 0.07943456536662342 * x
                 - 28.0852963507957 * math.log(x))
    elif k >= 1000.0:
        x = k / 100.0 - 2.0
        green = (-155.25485562709179 - 0.44596950469579133 * x
                 + 104.49216199393888 * math.log(x))
    else:
        green = 0.0
    if k >= 6600.0:
        blue = 255.0
    elif k >= 2000.0:
        x = k / 100.0 - 10.0
        blue = (-254.76935184120902 + 0.8274096064007395 * x
                + 115.67994401066147 * math.log(x))
    else:
        blue = 0.0
    return torch.tensor([min(1.0, max(0.0, c / 255.0))
                         for c in (red, green, blue)], dtype=torch.float32)


def luminance(c):
    """Rec.709 luma."""
    w = torch.tensor([0.2126, 0.7152, 0.0722], dtype=c.dtype, device=c.device)
    return vec.sum_last(c * w)


def mix(a, b, pct):
    """lerp(a, b, pct), Colour.Mix. pct may be a number or a (...,)
    tensor matching the batch shape of a and b (broadcast over rgb)."""
    pct = torch.as_tensor(pct, dtype=a.dtype, device=a.device)
    if pct.ndim == a.ndim - 1:
        pct = pct[..., None]
    return a + (b - a) * pct


def to_srgb(c):
    """Linear -> display: pow(1/2.2) + clip."""
    return torch.clamp(torch.abs(c) ** (1.0 / GAMMA), 0.0, 1.0)


def from_srgb(c):
    """Display -> linear: clip, then pow(2.2)."""
    return vec.pow_f32(torch.clamp(c, 0.0, 1.0), GAMMA)
