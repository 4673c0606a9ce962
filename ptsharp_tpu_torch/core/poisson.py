"""Bridson Poisson-disc sampling in 2D (Poisson.cs).

A numpy copy of ptsharp_tpu/core/poisson.py: the same draws from the same
seed, so both packages place the same points."""

from __future__ import annotations

import numpy as np


def poisson_disc(width: float, height: float, radius: float, k: int = 30,
                 seed: int = 0) -> np.ndarray:
    """Generate points >= radius apart inside [0, width) x [0, height).
    Returns (N, 2) float32."""
    rng = np.random.default_rng(seed)
    cell = radius / np.sqrt(2.0)
    gw = int(np.ceil(width / cell))
    gh = int(np.ceil(height / cell))
    grid = -np.ones((gw, gh), np.int64)
    points: list[np.ndarray] = []
    active: list[int] = []

    def grid_idx(p):
        return int(p[0] / cell), int(p[1] / cell)

    def fits(p):
        gx, gy = grid_idx(p)
        for ix in range(max(0, gx - 2), min(gw, gx + 3)):
            for iy in range(max(0, gy - 2), min(gh, gy + 3)):
                j = grid[ix, iy]
                if j >= 0 and np.linalg.norm(points[j] - p) < radius:
                    return False
        return True

    p0 = np.array([rng.uniform(0, width), rng.uniform(0, height)])
    points.append(p0)
    active.append(0)
    gx, gy = grid_idx(p0)
    grid[gx, gy] = 0

    while active:
        i = active[int(rng.integers(len(active)))]
        base = points[i]
        placed = False
        for _ in range(k):
            ang = rng.uniform(0, 2 * np.pi)
            rad = rng.uniform(radius, 2 * radius)
            p = base + rad * np.array([np.cos(ang), np.sin(ang)])
            if 0 <= p[0] < width and 0 <= p[1] < height and fits(p):
                grid[grid_idx(p)] = len(points)
                points.append(p)
                active.append(len(points) - 1)
                placed = True
                break
        if not placed:
            active.remove(i)
    return np.asarray(points, np.float32)
