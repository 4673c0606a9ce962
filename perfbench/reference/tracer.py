"""The reference path tracer: PTSharp's estimator over one triangle mesh,
planes and sphere lights, lane by lane.

A lane is one camera path. Its random numbers are drawn at its own index
in the wavefront from the keys of the program's specification (the key
chain below), so that a lane's path is a function of (scene, key, lane)
alone and any subset of lanes can be traced by itself. Per depth:
closest hit over planes, spheres and the mesh (the mesh bounded by the
nearest analytic hit); the environment on a miss; emission where the
path may still add it; a Fresnel coin between a cone-sampled mirror
direction and a cosine-weighted diffuse one; next-event estimation to
the sphere light through a disc sample, a coverage factor min(1,
r^2/(d^2 - r^2)) and an any-hit shadow ray; no Russian roulette.

Transcendentals and square roots are taken in float64 and rounded once,
so the CPU and the card agree. `dt` is the arithmetic's precision:
float32, or bfloat16 for the precision control.
"""

from __future__ import annotations

import math

import torch

from . import bvh, rng

INF = 1e9
EPS_T = 1e-4


def _f64(fn, *xs):
    dt = xs[0].dtype
    return fn(*(x.double() for x in xs)).to(dt)


def sqrt(x):
    return _f64(torch.sqrt, x)


def dot(a, b):
    p = a * b
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def normalize(a):
    return a * (1.0 / sqrt(torch.clamp(dot(a, a), min=1e-20)))[..., None]


def onb(w):
    """An orthonormal pair (t, b) perpendicular to unit w (Duff et al.)."""
    z = w[..., 2]
    sign = torch.where(z >= 0.0, 1.0, -1.0).to(w.dtype)
    a = -1.0 / (sign + z)
    b = w[..., 0] * w[..., 1] * a
    t = torch.stack([1.0 + sign * w[..., 0] * w[..., 0] * a, sign * b,
                     -sign * w[..., 0]], dim=-1)
    bb = torch.stack([b, sign + w[..., 1] * w[..., 1] * a, -w[..., 1]],
                     dim=-1)
    return t, bb


class Walker:
    """The scene's geometry queries: planes and spheres in closed form,
    the mesh through the reference's own BVH."""

    def __init__(self, scene):
        self.s = scene
        self.tree = bvh.build(scene.v0, scene.e1, scene.e2)

    def _planes(self, o, d):
        s = self.s
        n = s.plane_normal[None]
        ddn = dot(d[:, None], n)
        num = dot(s.plane_point[None] - o[:, None], n)
        tiny = torch.where(ddn < 0, -1e-30, 1e-30).to(ddn.dtype)
        t = num / torch.where(torch.abs(ddn) < 1e-30, tiny, ddn)
        ok = (torch.abs(ddn) > 1e-9) & (t > EPS_T)
        return torch.where(ok, t, torch.full_like(t, INF))

    def _spheres(self, o, d):
        s = self.s
        oc = o[:, None] - s.sphere_center[None]
        dd = d[:, None]
        a = dot(dd, dd)
        b = 2.0 * dot(oc, dd)
        c = dot(oc, oc) - (s.sphere_radius**2)[None]
        disc = b * b - 4.0 * a * c
        sq = sqrt(torch.clamp(disc, min=0.0))
        inv2a = 0.5 / torch.clamp(a, min=1e-30)
        t0 = (-b - sq) * inv2a
        t1 = (-b + sq) * inv2a
        inf = torch.full_like(t0, INF)
        t = torch.where(t0 > EPS_T, t0, torch.where(t1 > EPS_T, t1, inf))
        return torch.where(disc > 0.0, t, inf)

    def closest(self, o, d):
        """(t, kind, index, u, v): kind 0 none, 1 plane, 2 sphere,
        3 triangle; the first of equal minima within a kind, and a later
        kind only where strictly nearer."""
        r = o.shape[0]
        best = torch.full((r,), INF, dtype=o.dtype, device=o.device)
        kind = torch.zeros(r, dtype=torch.int64, device=o.device)
        idx = torch.zeros(r, dtype=torch.int64, device=o.device)
        for k, ts in ((1, self._planes(o, d)), (2, self._spheres(o, d))):
            tk, ik = torch.amin(ts, dim=1), torch.argmin(ts, dim=1)
            better = tk < best
            best = torch.where(better, tk, best)
            kind = torch.where(better, k, kind)
            idx = torch.where(better, ik, idx)
        t, tri, u, v = bvh.walk(self.tree, self.s.v0, self.s.e1, self.s.e2,
                                o, d, best)
        hit = tri >= 0
        kind = torch.where(hit, 3, kind)
        idx = torch.where(hit, tri, idx)
        t = torch.where(kind == 0, torch.full_like(t, INF), t)
        return t, kind, idx, u, v

    def occluded(self, o, d, t_cut):
        """Whether a plane, sphere or triangle lies at t in (1e-4, t_cut)."""
        occ = (self._planes(o, d) < t_cut[:, None]).any(dim=1)
        occ = occ | (self._spheres(o, d) < t_cut[:, None]).any(dim=1)
        cut = torch.where(occ, torch.full_like(t_cut, -INF), t_cut)
        return occ | bvh.walk(self.tree, self.s.v0, self.s.e1, self.s.e2,
                              o, d, cut, any_hit=True)


def camera_rays(scene, x, y, width: int, height: int, ju, jv):
    """Pinhole rays through pixel (x, y) at jitter (ju, jv) in [0, 1): the
    image plane spans [-1, 1] from the first pixel's centre to the last's,
    scaled by the aspect ratio across."""
    dt = ju.dtype
    x = x.to(dt)
    y = y.to(dt)
    aspect = width / float(height)
    px = (x + ju - 0.5) / torch.tensor(width - 1.0, dtype=dt) * 2.0 - 1.0
    py = (y + jv - 0.5) / torch.tensor(height - 1.0, dtype=dt) * 2.0 - 1.0
    d = (scene.cu.to(dt) * (-px * aspect)[:, None]
         + scene.cv.to(dt) * (-py)[:, None] + scene.cw.to(dt) * scene.m)
    d = normalize(d)
    return torch.broadcast_to(scene.eye.to(dt), d.shape), d


def _texture(scene, tid, u, v):
    """Bilinear, wrapped sample of texture tid at (u, v), v flipped."""
    h, w = scene.texture_size
    tex = scene.texture
    uu = torch.remainder(u, 1.0) * (w - 1.0)
    vv = (1.0 - torch.remainder(v, 1.0)) * (h - 1.0)
    x0 = torch.floor(uu).long()
    y0 = torch.floor(vv).long()
    fx = (uu - x0)[..., None]
    fy = (vv - y0)[..., None]
    x1 = torch.where(x0 + 1 >= w, 0, x0 + 1)
    y1 = torch.where(y0 + 1 >= h, 0, y0 + 1)
    i = torch.clamp(tid, 0, tex.shape[0] - 1)
    c0 = tex[i, y0, x0] * (1 - fx) + tex[i, y0, x1] * fx
    c1 = tex[i, y1, x0] * (1 - fx) + tex[i, y1, x1] * fx
    return c0 * (1 - fy) + c1 * fy


def _shade(scene, o, d, t, kind, idx, u, v, colors):
    """Hit point, shading normal toward the ray, inside flag, material id
    and albedo of each lane (garbage where kind is 0)."""
    s = scene
    dt = o.dtype
    pos = o + d * t[:, None]
    r = o.shape[0]
    normal = torch.zeros((r, 3), dtype=dt, device=o.device)
    normal[:, 1] = 1.0
    mat = torch.zeros(r, dtype=torch.int64, device=o.device)
    tu = torch.zeros(r, dtype=dt, device=o.device)
    tv = torch.zeros(r, dtype=dt, device=o.device)
    si = torch.clamp(idx, max=s.sphere_center.shape[0] - 1)
    sph = kind == 2
    normal = torch.where(sph[:, None], normalize(pos - s.sphere_center[si]),
                         normal)
    mat = torch.where(sph, s.sphere_material[si], mat)
    pi = torch.clamp(idx, max=s.plane_point.shape[0] - 1)
    pla = kind == 1
    normal = torch.where(pla[:, None], s.plane_normal[pi], normal)
    mat = torch.where(pla, s.plane_material[pi], mat)
    ti = torch.clamp(idx, max=s.v0.shape[0] - 1)
    tri = kind == 3
    w = 1.0 - u - v
    nt = s.n[ti]
    n_obj = normalize(nt[:, 0] * w[:, None] + nt[:, 1] * u[:, None]
                      + nt[:, 2] * v[:, None])
    uvt = s.uv[ti]
    uv = uvt[:, 0] * w[:, None] + uvt[:, 1] * u[:, None] \
        + uvt[:, 2] * v[:, None]
    normal = torch.where(tri[:, None], normalize(n_obj), normal)
    mat = torch.where(tri, s.mesh_material, mat)
    tu = torch.where(tri, uv[:, 0], tu)
    tv = torch.where(tri, uv[:, 1], tv)
    facing = dot(normal, d) > 0.0
    normal = torch.where(facing[:, None], -normal, normal)
    inside = facing & (kind != 0)
    m = {k: f[mat] for k, f in s.materials.items()}
    color = colors[mat]
    if s.texture.shape[1] > 1:
        color = torch.where((m["texture"] >= 0)[:, None],
                            _texture(s, m["texture"], tu, tv), color)
    return pos, normal, inside, m, color


def _reflectance(n, i, n1, n2):
    """Unpolarised Fresnel reflectance, 1 on total internal reflection."""
    nr2 = (n1 * n1) / (n2 * n2)
    cos_i = -dot(n, i)
    sin_t2 = nr2 * (1.0 - cos_i * cos_i)
    cos_t = sqrt(torch.clamp(1.0 - sin_t2, min=0.0))
    a = n1 * cos_i
    b = n2 * cos_t
    r_orth = (a - b) / torch.clamp(a + b, min=1e-9)
    r_par = (b - a) / torch.clamp(b + a, min=1e-9)
    r = 0.5 * (r_orth * r_orth + r_par * r_par)
    return torch.where(sin_t2 > 1.0, torch.ones_like(r),
                       torch.clamp(r, 0.0, 1.0))


def _cone(d, theta_max, u1, u2):
    """A direction in the cone of half-angle theta_max about unit d."""
    theta = theta_max * (1.0 - 2.0 * _f64(torch.acos, torch.clamp(
        u1, 0.0, 1.0)) / torch.tensor(math.pi, dtype=u1.dtype))
    m1 = _f64(torch.sin, theta)
    m2 = _f64(torch.cos, theta)
    a = u2 * 2.0 * math.pi
    s, t = onb(d)
    out = normalize(s * (m1 * _f64(torch.cos, a))[:, None]
                    + t * (m1 * _f64(torch.sin, a))[:, None]
                    + d * m2[:, None])
    return torch.where((theta_max < 1e-9)[:, None], d, out)


def _cosine(n, u1, u2):
    t, b = onb(n)
    radius = sqrt(u1)
    theta = 2.0 * math.pi * u2
    z = sqrt(torch.clamp(1.0 - u1, min=0.0))
    return (t * (radius * _f64(torch.cos, theta))[:, None]
            + b * (radius * _f64(torch.sin, theta))[:, None]
            + n * z[:, None])


def _light_t(scene, o, d):
    """The distance along d to the light sphere's surface, INF if none."""
    c = scene.sphere_center[scene.light_sphere]
    rad = scene.sphere_radius[scene.light_sphere]
    oc = o - c
    a = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
    b = 2.0 * ((oc[:, 0] * d[:, 0] + oc[:, 1] * d[:, 1]) + oc[:, 2] * d[:, 2])
    cq = ((oc[:, 0] * oc[:, 0] + oc[:, 1] * oc[:, 1])
          + oc[:, 2] * oc[:, 2]) - rad * rad
    disc = b * b - (4.0 * a) * cq
    sq = sqrt(torch.clamp(disc, min=0.0))
    inv2a = 0.5 / torch.clamp(a, min=1e-30)
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    inf = torch.full_like(t0, INF)
    t = torch.where(t0 > EPS_T, t0, torch.where(t1 > EPS_T, t1, inf))
    return torch.where(disc > 0.0, t, inf)


def _direct(walker, colors, pos, normal, key, lanes):
    """NEE to the one sphere light: its contribution before the albedo
    weighting (zero where the light faces away or is occluded)."""
    s = walker.s
    _kpick, ksmp = rng.split(key)
    k1, k2, _k3 = rng.split(ksmp, 3)
    u1 = rng.uniform_at(k1, lanes).to(pos.dtype)
    u2 = rng.uniform_at(k2, lanes).to(pos.dtype)
    li = s.light_sphere
    center = s.sphere_center[li]
    radius = s.sphere_radius[li]
    angle = u1 * 2.0 * math.pi
    rr = sqrt(u2)
    dx = _f64(torch.cos, angle) * rr
    dy = _f64(torch.sin, angle) * rr
    ta, ba = onb(normalize(center - pos))
    point = center + ta * (dx * radius)[:, None] + ba * (dy * radius)[:, None]
    ray_dir = normalize(point - pos)
    cos_t = dot(ray_dir, normal)
    facing = cos_t > 0.0
    t_light = _light_t(s, pos, ray_dir)
    t_hit = t_light < INF
    t_cut = t_light * (1.0 - 1e-3) - 1e-3
    t_cut = torch.where(facing & t_hit, t_cut, torch.full_like(t_cut, -INF))
    visible = t_hit & ~walker.occluded(pos, ray_dir, t_cut)
    hyp = sqrt(torch.clamp(dot(center - pos, center - pos), min=0.0))
    cov = (radius * radius) / torch.clamp(hyp * hyp - radius * radius,
                                          min=1e-12)
    cov = torch.where(hyp < radius, torch.ones_like(cov),
                      torch.clamp(cov, max=1.0))
    lm = int(s.sphere_material[li])
    scale = s.materials["emittance"][lm] * cos_t * cov
    contrib = colors[lm] * scale[:, None]
    return torch.where((facing & visible)[:, None], contrib,
                       torch.zeros_like(contrib))


def trace(walker: Walker, org, dirn, key: tuple, lanes, colors=None):
    """Radiance (R, 3) of the camera paths org, dirn whose wavefront
    indices are `lanes`, from the trace key `key`. `colors` (M, 3), the
    material colours, may require grad; None takes the scene's."""
    s = walker.s
    dt = org.dtype
    if colors is None:
        colors = s.materials["color"]
    r = org.shape[0]
    dev = org.device
    k0, krest = rng.split(key)
    k0a, k0u, k0v = rng.split(k0, 3)
    thr = torch.ones((r, 3), dtype=dt, device=dev)
    rad = torch.zeros((r, 3), dtype=dt, device=dev)
    emission_ok = torch.ones(r, dtype=torch.bool, device=dev)
    live = torch.arange(r, device=dev)  # rows of the alive lanes
    o, d = org, dirn
    for depth in range(s.max_bounces + 1):
        if depth == 0:
            dk = k0a
            ka, kb_ = k0u, k0v
        else:
            dk = rng.fold_in(rng.fold_in(krest, 0), depth)
            ka, kb_ = rng.split(rng.fold_in(dk, 7))
        ln = lanes[live]
        u1 = rng.uniform_at(ka, ln).to(dt)
        u2 = rng.uniform_at(kb_, ln).to(dt)
        t, kind, idx, hu, hv = walker.closest(o, d)
        pos, normal, inside, m, color = _shade(s, o, d, t, kind, idx, hu, hv,
                                               colors)
        tp = thr[live]
        missed = kind == 0
        add = torch.where(missed[:, None], tp * s.env, torch.zeros_like(tp))
        emissive = m["emittance"] > 0.0
        ok_e = emission_ok[live]
        emit = ~missed & emissive & ok_e
        add = add + torch.where(emit[:, None],
                                tp * color * m["emittance"][:, None],
                                torch.zeros_like(tp))
        alive = ~missed & ~(emissive & ~ok_e)
        kbounce, kn, _krr = rng.split(dk, 3)
        kcoin, kcone = rng.split(kbounce)
        ku, kv = rng.split(kcone)
        n1 = torch.where(inside, m["index"], torch.ones_like(m["index"]))
        n2 = torch.where(inside, torch.ones_like(m["index"]), m["index"])
        p = torch.where(m["reflectivity"] >= 0.0, m["reflectivity"],
                        _reflectance(normal, d, n1, n2))
        p = torch.clamp(p, 0.0, 1.0)
        spec = rng.uniform_at(kcoin, ln).to(dt) < p
        cu = rng.uniform_at(ku, ln).to(dt)
        cv = rng.uniform_at(kv, ln).to(dt)
        refl = d - 2.0 * dot(normal, d)[:, None] * normal
        spec_dir = _cone(normalize(refl), m["gloss"], cu, cv)
        new_dir = torch.where(spec[:, None], spec_dir,
                              _cosine(normal, u1, u2))
        one = torch.ones_like(color)
        tinted = one + (color - one) * m["tint"][:, None]
        tp = tp * torch.where(spec[:, None], tinted, color)
        nee = alive & ~spec
        direct = _direct(walker, colors, pos, normal, kn, ln)
        add = add + torch.where(nee[:, None], tp * direct,
                                torch.zeros_like(tp))
        rad = rad.index_add(0, live, add)
        keep = torch.nonzero(alive).squeeze(1)
        thr = thr.index_put((live[keep],), tp[keep])
        emission_ok = emission_ok.index_put((live[keep],), spec[keep])
        o = (pos + new_dir * 1e-4)[keep]
        d = new_dir[keep]
        live = live[keep]
        if live.numel() == 0:
            break
    return rad
