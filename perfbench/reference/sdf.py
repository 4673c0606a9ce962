"""Signed distance fields of PTSharp's SDF.cs and its sphere trace, in
plain PyTorch, for a configuration's `scene.sdf.tree`.

A node is a dict with a `kind`:

  sphere        {radius}: |p| - radius (SphereSDF, exponent 2)
  cube          {size: [x, y, z]}: the box of half-extents size / 2,
                min(max(q), 0) + |max(q, 0)| with q = |p| - size / 2
                (CubeSDF)
  cylinder      {radius, height}: the capped y-axis cylinder,
                min(max(a, b), 0) + |max((a, b), 0)| with
                a = sqrt(x^2 + z^2) - radius, b = |y| - height / 2
                (CylinderSDF)
  union         {items}: min over the items (UnionSDF)
  intersection  {items}: max over the items (IntersectionSDF)
  difference    {items}: max(d0, -d1, -d2, ...) (DifferenceSDF)
  transform     {child, rotate: {axis, degrees}, translate}: the child at
                M^-1 p, M = translate x rotate (TransformSDF; Matrix.cs's
                Rotate)

Every parameter is a float32 of the configuration, taken to the points'
precision; a square root is taken in float64 and rounded once; sums run
left to right. The box a trace is clipped to is the tree's bound: a
primitive's own box, the union's hull, the intersection's overlap, the
difference's first item's, a transform's eight corners moved by M.

The sphere trace follows SDF.cs:32-76 (SDFShape.Intersect): from the
box's entry (at least 1e-4) step t += d; while the ray has not yet
penetrated, steps near the surface (d < 1e-3) are of 1e-3; on the first
d < 0 jump back 1e-3 once and go on; accept where d < 1e-5; stop past
the box's exit or after 1,000 steps. Every lane steps on every pass of
the loop (a finished lane's result no longer changes), and the loop ends
when no lane is marching. The normal is the central difference at 1e-4
(SDF.cs:83-92) evaluated in float64 and rounded to the points' precision.
"""

from __future__ import annotations

import math

import numpy as np
import torch

EPS = 1e-5
START = 1e-4
JUMP = 1e-3
MAX_STEPS = 1000
NORMAL_EPS = 1e-4
INF = 1e9


def _sqrt(x):
    return torch.sqrt(x.double()).to(x.dtype)


def _length(a):
    return _sqrt((a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1])
                 + a[..., 2] * a[..., 2])


def matrix(node: dict) -> np.ndarray:
    """A transform node's 4x4 M in float32: translate x rotate."""
    m = np.eye(4, dtype=np.float64)
    rot = node.get("rotate")
    if rot is not None:
        x, y, z = np.asarray(rot["axis"], np.float64) / np.linalg.norm(
            rot["axis"])
        a = math.radians(rot["degrees"])
        s, c = math.sin(a), math.cos(a)
        k = 1.0 - c
        m[:3, :3] = [[k * x * x + c, k * x * y + z * s, k * z * x - y * s],
                     [k * x * y - z * s, k * y * y + c, k * y * z + x * s],
                     [k * z * x + y * s, k * y * z - x * s, k * z * z + c]]
    m[:3, 3] = node.get("translate", (0.0, 0.0, 0.0))
    return m.astype(np.float32)


def bounds(node: dict):
    """(lo, hi) float32 of the tree's box, as the module states it."""
    kind = node["kind"]
    f32 = np.float32
    if kind == "sphere":
        r = f32(node["radius"])
        return np.full(3, -r, f32), np.full(3, r, f32)
    if kind == "cube":
        half = np.asarray(node["size"], f32) / f32(2)
        return -half, half
    if kind == "cylinder":
        r, h = f32(node["radius"]), f32(node["height"]) / f32(2)
        return np.array([-r, -h, -r], f32), np.array([r, h, r], f32)
    if kind in ("union", "intersection"):
        los, his = zip(*(bounds(it) for it in node["items"]))
        if kind == "union":
            return np.min(los, axis=0), np.max(his, axis=0)
        return np.max(los, axis=0), np.min(his, axis=0)
    if kind == "difference":
        return bounds(node["items"][0])
    if kind == "transform":
        lo, hi = bounds(node["child"])
        corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                            for y in (lo[1], hi[1]) for z in (lo[2], hi[2])],
                           f32)
        m = matrix(node)
        world = corners @ m[:3, :3].T + m[:3, 3]
        return world.min(0), world.max(0)
    raise ValueError(f"no SDF node {kind!r}")


def field(node: dict, device, dtype):
    """The tree's signed distance as a function of points p (..., 3) of
    `dtype` on `device`, its constants made once."""
    kind = node["kind"]

    def c(x):
        return torch.as_tensor(np.asarray(x, np.float32),
                               device=device).to(dtype)

    if kind == "sphere":
        r = c(node["radius"])
        return lambda p: _length(p) - r
    if kind == "cube":
        half = c(node["size"]) / 2.0

        def cube(p):
            q = torch.abs(p) - half
            inside = torch.clamp(torch.maximum(torch.maximum(
                q[..., 0], q[..., 1]), q[..., 2]), max=0.0)
            return inside + _length(torch.clamp(q, min=0.0))
        return cube
    if kind == "cylinder":
        r, h = c(node["radius"]), c(node["height"]) / 2.0

        def cylinder(p):
            a = _sqrt(p[..., 0] * p[..., 0] + p[..., 2] * p[..., 2]) - r
            b = torch.abs(p[..., 1]) - h
            inside = torch.clamp(torch.maximum(a, b), max=0.0)
            pa, pb = torch.clamp(a, min=0.0), torch.clamp(b, min=0.0)
            return inside + _sqrt(pa * pa + pb * pb)
        return cylinder
    if kind in ("union", "intersection", "difference"):
        fs = [field(it, device, dtype) for it in node["items"]]

        def combine(p):
            d = fs[0](p)
            for f in fs[1:]:
                if kind == "union":
                    d = torch.minimum(d, f(p))
                elif kind == "intersection":
                    d = torch.maximum(d, f(p))
                else:
                    d = torch.maximum(d, -f(p))
            return d
        return combine
    if kind == "transform":
        inv = c(np.linalg.inv(matrix(node).astype(np.float64)))
        child = field(node["child"], device, dtype)

        def transform(p):
            x, y, z = p[..., 0], p[..., 1], p[..., 2]
            return child(torch.stack(
                [(inv[i, 0] * x + inv[i, 1] * y) + inv[i, 2] * z + inv[i, 3]
                 for i in range(3)], dim=-1))
        return transform
    raise ValueError(f"no SDF node {kind!r}")


def box_clip(o, d, lo, hi):
    """Slab entry and exit t of rays o + t d against the box [lo, hi]
    (a zero direction component divides by +-1e-30)."""
    tiny = torch.where(d < 0, -1e-30, 1e-30).to(d.dtype)
    inv = 1.0 / torch.where(torch.abs(d) < 1e-30, tiny, d)
    n = (lo - o) * inv
    f = (hi - o) * inv
    near, far = torch.minimum(n, f), torch.maximum(n, f)
    return (torch.maximum(torch.maximum(near[:, 0], near[:, 1]), near[:, 2]),
            torch.minimum(torch.minimum(far[:, 0], far[:, 1]), far[:, 2]))


def sphere_trace(f, o, d, t_enter, t_exit):
    """t (R,) of each ray's hit on the field f, INF where it misses (see
    the module)."""
    t = torch.clamp(t_enter, min=START)
    active = t_exit >= torch.clamp(t_enter, min=0.0)
    jump = active.clone()
    hit_t = torch.full_like(t, INF)
    for _ in range(MAX_STEPS):
        if not bool(active.any()):
            break
        dist = f(o + d * t[:, None])
        back = jump & (dist < 0.0)
        hit = active & ~back & (dist < EPS)
        hit_t = torch.where(hit, t, hit_t)
        stride = torch.where(jump & (dist < JUMP),
                             torch.full_like(dist, JUMP), dist)
        t = torch.where(back, t - JUMP, t + stride)
        jump = jump & ~back
        active = active & ~hit & ~(t > t_exit)
    return hit_t


def normal(f64, p):
    """The unit central-difference normal of the float64 field f64 at p
    (R, 3), rounded to p's dtype."""
    q = p.double()
    cols = []
    for i in range(3):
        e = torch.zeros(3, dtype=torch.float64, device=p.device)
        e[i] = NORMAL_EPS
        cols.append(f64(q + e) - f64(q - e))
    n = torch.stack(cols, dim=-1)
    s = (n[:, 0] * n[:, 0] + n[:, 1] * n[:, 1]) + n[:, 2] * n[:, 2]
    return (n / torch.sqrt(torch.clamp(s, min=1e-300))[:, None]).to(p.dtype)
