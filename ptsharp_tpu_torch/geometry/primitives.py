"""Batched analytic primitive intersection over SoA tables.

Counterpart of ptsharp_tpu/geometry/primitives.py: each primitive type is
a flat table and its intersector evaluates an (R rays x P primitives)
block in one vectorized op. All intersectors accept unnormalized
directions, return t = INF on a miss and use EPS_T as the minimum hit
distance.
"""

from __future__ import annotations

import math

import torch

from ptsharp_tpu_torch.core import vec

INF = vec.INF
EPS_T = 1e-4


def _safe_div(a, b):
    """Division that avoids 0/0 NaNs (slab tests keep +/-inf)."""
    tiny = torch.where(b < 0, -1e-30, 1e-30)
    return a / torch.where(torch.abs(b) < 1e-30, tiny, b)


def _where_inf(cond, t):
    return torch.where(cond, t, torch.full_like(t, INF))


# ---- spheres: centers (S, 3), radii (S,) ----------------------------------


def intersect_spheres(org, dirn, centers, radii):
    """org/dirn (R, 1, 3) or (R, S, 3); returns t (R, S)."""
    oc = org - centers[None, :, :]
    d = dirn
    a = vec.dot(d, d)
    b = 2.0 * vec.dot(oc, d)
    c = vec.dot(oc, oc) - (radii**2)[None, :]
    disc = b * b - 4.0 * a * c
    sq = vec.sqrt(torch.clamp(disc, min=0.0))
    inv2a = 0.5 / torch.clamp(a, min=1e-30)
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    t = torch.where(t0 > EPS_T, t0, _where_inf(t1 > EPS_T, t1))
    return _where_inf(disc > 0.0, t)


def sphere_normal(p, center):
    return vec.normalize(p - center)


def sphere_uv(p, center, radius):
    """Spherical lat-long UV."""
    d = vec.normalize(p - center)
    u = vec.atan2(d[..., 2], d[..., 0])
    flat = vec.vec3(d[..., 0], torch.zeros_like(d[..., 1]), d[..., 2])
    v = vec.atan2(d[..., 1], vec.length(flat))
    u = 1.0 - vec.div(u + math.pi, 2.0 * math.pi)
    v = vec.div(v + math.pi / 2.0, math.pi)
    return u, v


# ---- planes: points (P, 3), normals (P, 3) --------------------------------


def intersect_planes(org, dirn, points, normals):
    """org/dirn (R, 1, 3) or (R, P, 3); returns t (R, P)."""
    d_dot_n = vec.dot(dirn, normals[None, :, :])
    po = points[None, :, :] - org
    t = _safe_div(vec.dot(po, normals[None, :, :]), d_dot_n)
    valid = (torch.abs(d_dot_n) > vec.EPS) & (t > EPS_T)
    return _where_inf(valid, t)


# ---- axis-aligned boxes: bmin, bmax (C, 3) --------------------------------


def intersect_cubes(org, dirn, bmin, bmax):
    """org/dirn (R, 1, 3) or (R, C, 3); returns t (R, C)."""
    invd = _safe_div(torch.ones_like(dirn), dirn)
    n = (bmin[None, :, :] - org) * invd
    f = (bmax[None, :, :] - org) * invd
    t0 = torch.amax(torch.minimum(n, f), dim=-1)
    t1 = torch.amin(torch.maximum(n, f), dim=-1)
    # only the entry hit counts (Cube.cs:40)
    return _where_inf((t0 > EPS_T) & (t0 < t1), t0)


def cube_normal(p, bmin, bmax, eps: float = 1e-4):
    """Face-epsilon normal; default +Y."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    n = vec.vec3(zeros, ones, zeros)
    for cond, nvec in [
        (torch.abs(z - bmax[..., 2]) < eps, vec.vec3(zeros, zeros, ones)),
        (torch.abs(z - bmin[..., 2]) < eps, vec.vec3(zeros, zeros, -ones)),
        (torch.abs(y - bmax[..., 1]) < eps, vec.vec3(zeros, ones, zeros)),
        (torch.abs(y - bmin[..., 1]) < eps, vec.vec3(zeros, -ones, zeros)),
        (torch.abs(x - bmax[..., 0]) < eps, vec.vec3(ones, zeros, zeros)),
        (torch.abs(x - bmin[..., 0]) < eps, vec.vec3(-ones, zeros, zeros)),
    ]:
        n = torch.where(cond[..., None], nvec, n)
    return n


def cube_uv(p, bmin, bmax):
    q = (p - bmin) / torch.clamp(bmax - bmin, min=1e-12)
    return q[..., 0], q[..., 2]


# ---- capped z-cylinders: radius, z0, z1 (C,) ------------------------------


def intersect_cylinders(org, dirn, radius, z0, z1):
    """org/dirn (R, 1, 3) or (R, C, 3); returns t (R, C)."""
    o = org
    d = dirn
    r = radius[None, :]
    tz0 = _safe_div(z0[None, :] - o[..., 2], d[..., 2])
    tz1 = _safe_div(z1[None, :] - o[..., 2], d[..., 2])

    def cap_ok(tc):
        px = o[..., 0] + d[..., 0] * tc
        py = o[..., 1] + d[..., 1] * tc
        return (tc > EPS_T) & (px * px + py * py <= r * r)

    t_top = _where_inf(cap_ok(tz1), tz1)
    t_bot = _where_inf(cap_ok(tz0), tz0)
    a = d[..., 0] ** 2 + d[..., 1] ** 2
    b = 2.0 * (o[..., 0] * d[..., 0] + o[..., 1] * d[..., 1])
    c = o[..., 0] ** 2 + o[..., 1] ** 2 - r * r
    disc = b * b - 4.0 * a * c
    sq = vec.sqrt(torch.clamp(disc, min=0.0))
    inv2a = 0.5 / torch.clamp(a, min=1e-30)
    tl0 = (-b - sq) * inv2a
    tl1 = (-b + sq) * inv2a

    def lat_ok(tl):
        z = o[..., 2] + d[..., 2] * tl
        return ((tl > EPS_T) & (z >= z0[None, :]) & (z <= z1[None, :])
                & (disc >= 0.0))

    t_lat = torch.where(lat_ok(tl0), tl0, _where_inf(lat_ok(tl1), tl1))
    return torch.minimum(torch.minimum(t_top, t_bot), t_lat)


def cylinder_normal(p, z0, z1, eps: float = 1e-4):
    """Lateral radial normal, cap normals at the z extremes."""
    zeros = torch.zeros_like(p[..., 0])
    ones = torch.ones_like(zeros)
    n = vec.normalize(vec.vec3(p[..., 0], p[..., 1], zeros))
    n = torch.where((torch.abs(p[..., 2] - z0) < eps)[..., None],
                    vec.vec3(zeros, zeros, -ones), n)
    n = torch.where((torch.abs(p[..., 2] - z1) < eps)[..., None],
                    vec.vec3(zeros, zeros, ones), n)
    return n


def intersect_triangles(org, dirn, v0, v1, v2, eps: float = 1e-9):
    """Brute-force Moller-Trumbore over a triangle block: org/dirn (R, 3),
    vertices (T, 3). Returns (t, u, v), each (R, T), t = INF on a miss;
    u runs along v1 - v0, v along v2 - v0. The oracle the BVH walks are
    tested against."""
    e1 = (v1 - v0)[None, :, :]
    e2 = (v2 - v0)[None, :, :]
    d = dirn[:, None, :]
    h = vec.cross(d, e2)
    det = vec.dot(e1, h)
    inv_det = _safe_div(torch.ones_like(det), det)
    s = org[:, None, :] - v0[None, :, :]
    u = vec.dot(s, h) * inv_det
    q = vec.cross(s, e1)
    v = vec.dot(d, q) * inv_det
    t = vec.dot(e2, q) * inv_det
    ok = ((torch.abs(det) > eps) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
          & (u + v <= 1.0) & (t > EPS_T))
    return _where_inf(ok, t), u, v


def triangle_interpolate(attr0, attr1, attr2, u, v):
    """Barycentric interpolation with w = 1-u-v at vertex 0."""
    w = 1.0 - u - v
    return attr0 * w[..., None] + attr1 * u[..., None] + attr2 * v[..., None]



def box_entry_exit(org, dirn, bmin, bmax):
    """Slab entry and exit t (tmin, tmax) of rays against boxes, with
    broadcasting over the leading axes of bmin/bmax; the SDF, volume and
    heightfield marches clip to their shape's box with it."""
    invd = _safe_div(torch.ones_like(dirn), dirn)
    n = (bmin - org) * invd
    f = (bmax - org) * invd
    return (torch.amax(torch.minimum(n, f), dim=-1),
            torch.amin(torch.maximum(n, f), dim=-1))
