"""The dragon-class mesh: the displaced icosphere (a seeded phase) with a
serpentine warp about x, stretched along x, smooth normals recomputed,
fitted into a box (1,310,720 triangles at 8 subdivisions)."""

from __future__ import annotations

import numpy as np

from .common import displaced_sphere, fit_inside, smooth_normals


def make(subdivisions: int, seed: int, box_min, box_max, anchor):
    v0, _n, uv = displaced_sphere(subdivisions, seed, normals=False)
    v = v0.reshape(-1, 3).copy()
    t = v[:, 0] * 1.5
    c, s = np.cos(t * 0.8), np.sin(t * 0.8)
    y = v[:, 1] * c - v[:, 2] * s
    z = v[:, 1] * s + v[:, 2] * c
    v[:, 1], v[:, 2] = y * 0.6, z * 0.8
    v[:, 0] *= 1.9
    v = v.reshape(-1, 3, 3).astype(np.float32)
    v, n = fit_inside(v, smooth_normals(v), box_min, box_max, anchor)
    return v, n, uv
