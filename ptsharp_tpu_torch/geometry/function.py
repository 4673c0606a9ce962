"""Heightfield function shape: the region z < f(x, y) inside a box.

Counterpart of ptsharp_tpu/geometry/function.py (reference Function.cs):
an inside-test march with step 1/32 up to t = 12 (Function.cs:43-56), a
bisection over the last step, finite-difference normals
(Function.cs:74-82). `f` is a torch callable over tensors.

The JAX package runs all 385 steps for every lane. A lane stops changing
its crossing once it has found one or passed its exit, so the march runs
in geometry/march.py's lockstep loop over the lanes still marching, which
gives every lane the same crossing; the bisection runs over the lanes
that found one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ptsharp_tpu_torch.core import vec
from ptsharp_tpu_torch.geometry.march import march

MARCH_STEP = 1.0 / 32.0  # Function.cs:47
MAX_T = 12.0  # Function.cs:48
N_STEPS = int(MAX_T / MARCH_STEP) + 1
BISECT_STEPS = 16


@dataclass(eq=False)
class Heightfield:
    """f maps x, y (...,) tensors -> z heights (...,); the box bounds the
    shape."""

    f: Callable
    bmin: Any
    bmax: Any

    def inside(self, p):
        """z < f(x, y) (Function.Contains)."""
        return p[..., 2] < self.f(p[..., 0], p[..., 1])


def intersect(hf: Heightfield, org, dirn, t_enter, t_exit,
              tag: str | None = None):
    """The first of the steps t = t0 + i / 32, i < 385, with t <= the exit
    (capped at 12) whose point is inside, then 16 bisection steps over
    the step before it (ptsharp_tpu/geometry/function.py:38-71). Returns t
    (R,), INF on a miss. Detached."""
    org, dirn = org.detach(), dirn.detach()
    t0 = torch.clamp(t_enter.detach(), min=MARCH_STEP)
    t_hi = torch.clamp(t_exit.detach(), max=MAX_T)

    def step(lanes, active):
        i = lanes["i"]
        t = lanes["t0"] + i * MARCH_STEP
        hit = (hf.inside(lanes["org"] + lanes["dirn"] * t[:, None])
               & (t <= lanes["t_hi"]) & active)
        lanes["cross_t"] = torch.where(hit, t, lanes["cross_t"])
        lanes["i"] = i + 1
        # the steps' t only grow: past t_hi a lane can find nothing more
        return (active & ~hit
                & (lanes["t0"] + (i + 1) * MARCH_STEP <= lanes["t_hi"]))

    lanes = dict(org=org, dirn=dirn, t0=t0, t_hi=t_hi,
                 i=torch.zeros_like(t0),
                 cross_t=torch.full_like(t0, vec.INF))
    cross_t = march(step, lanes, t0 <= t_hi, ("cross_t",), N_STEPS,
                    tag)["cross_t"]

    out = torch.full_like(cross_t, vec.INF)
    lane = torch.nonzero(cross_t < vec.INF).squeeze(1)
    if lane.numel():
        o, d = org[lane], dirn[lane]
        lo = cross_t[lane] - MARCH_STEP
        hi = cross_t[lane]
        for _ in range(BISECT_STEPS):
            mid = 0.5 * (lo + hi)
            inside = hf.inside(o + d * mid[:, None])
            lo = torch.where(inside, lo, mid)
            hi = torch.where(inside, mid, hi)
        out[lane] = hi
    return out


def normal_at(hf: Heightfield, p, eps: float = 1e-3):
    """Gradient normal of z - f(x, y) (Function.cs:74-82): the four offset
    heights as one batch."""
    x, y = p[..., 0], p[..., 1]
    z = hf.f(torch.stack([x + eps, x - eps, x, x]),
             torch.stack([y, y, y + eps, y - eps]))
    fx = vec.div(z[0] - z[1], 2 * eps)
    fy = vec.div(z[2] - z[3], 2 * eps)
    return vec.normalize(vec.vec3(-fx, -fy, torch.ones_like(fx)))
