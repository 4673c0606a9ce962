"""A marble-like texture: sine veins over a size x size grid, tinted."""

from __future__ import annotations

import numpy as np


def make(size: int, base: float, gain: float, tint):
    ty, tx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    vein = np.sin(tx * 0.35 + 3.0 * np.sin(ty * 0.12)) * 0.5 + 0.5
    tex = base + gain * vein[..., None] * np.array(tint)
    return np.clip(tex, 0, 1).astype(np.float32)
