"""Pixel reconstruction filters (counterpart of ptsharp_tpu/core/filters.py):
the renderer weights each sample by the filter evaluated at its subpixel
offset (jitter - 0.5)."""

from __future__ import annotations

import math

import torch

from ptsharp_tpu_torch.core import vec

BOX = "box"
TRIANGLE = "triangle"
GAUSSIAN = "gaussian"


def evaluate(name: str, dx, dy, radius: float = 0.5, alpha: float = 2.0):
    """Filter weight for subpixel offsets dx, dy in [-0.5, 0.5]."""
    if name == BOX:
        return torch.ones_like(dx)
    if name == TRIANGLE:
        wx = torch.clamp(radius - torch.abs(dx), min=0.0)
        wy = torch.clamp(radius - torch.abs(dy), min=0.0)
        return vec.div(wx * wy, radius * radius)
    if name == GAUSSIAN:
        floor = math.exp(-alpha * radius * radius)

        def g(d):
            return torch.clamp(torch.exp(-alpha * d * d) - floor, min=0.0)

        return g(dx) * g(dy)
    raise ValueError(f"unknown filter {name!r}")
