"""The reference path tracer over a marched scene: one SDF tree (sdf.py),
infinite planes, spheres (one emissive: the light), a flat environment
and a thin-lens camera, described by a configuration's `scene`.

The estimator is tracer.trace's, PTSharp's, lane by lane and on the same
key chain: the SDF is a fourth kind of closest hit (after planes and
spheres, its trace clipped to its box and bounded by the nearest
analytic hit), of shadow ray (marched up to the cut) and of shading (the
central-difference normal, flipped toward the ray; an SDF hit never
reports `inside`, as the JAX package's Hit.Info has it). NEE, the
Fresnel coin, the cone and cosine samples and the light's coverage are
tracer.py's own functions.

The camera is PTSharp's Camera.cs: the pinhole ray of tracer.camera_rays,
then, with an aperture, an origin on the lens disc at angle 2 pi u and
radius v x aperture (uniform in radius, as Camera.cs draws it, not in
area), aimed at the point the pinhole ray reaches at the focal distance
|focus - eye|.

Departures from PTSharp: float32 (PTSharp computes in double) with
square roots and transcendentals in float64, rounded once; the SDF
normal in float64; the JAX package's reading of the scene's sizes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import rng, sdf, tracer
from .scene import MATERIAL_DEFAULTS, _camera_basis, _normalize
from .tracer import INF, _cone, _cosine, _direct, _reflectance, dot, \
    normalize

SDF_KIND = 4
BATCH = 1 << 21  # lanes traced at once


@dataclass
class Scene:
    field: object               # the tree's distance in the scene's dtype
    field64: object             # the same in float64 (normals)
    box_lo: torch.Tensor
    box_hi: torch.Tensor
    sdf_material: int
    plane_point: torch.Tensor
    plane_normal: torch.Tensor
    plane_material: torch.Tensor
    sphere_center: torch.Tensor
    sphere_radius: torch.Tensor
    sphere_material: torch.Tensor
    light_sphere: int
    materials: dict
    env: torch.Tensor
    eye: torch.Tensor
    cu: torch.Tensor
    cv: torch.Tensor
    cw: torch.Tensor
    m: float
    focal_distance: torch.Tensor
    aperture: float
    max_bounces: int


def build(desc: dict, device, dtype=torch.float32) -> Scene:
    """The marched scene of `desc` on `device`, every float table in
    `dtype` (float32, or bfloat16 for the control)."""

    def f(x):
        return torch.as_tensor(np.asarray(x, np.float32),
                               device=device).to(dtype)

    def i64(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=device)

    mats = [dict(MATERIAL_DEFAULTS, **m) for m in desc["materials"]]
    materials = {k: f([m[k] for m in mats]) for k in
                 ("color", "emittance", "index", "gloss", "tint",
                  "reflectivity")}
    planes, spheres = desc["planes"], desc["spheres"]
    lights = [i for i, s in enumerate(spheres)
              if mats[s["material"]]["emittance"] > 0]
    if len(lights) != 1:
        raise ValueError("the reference samples exactly one sphere light")
    tree = desc["sdf"]["tree"]
    lo, hi = sdf.bounds(tree)
    cam = desc["camera"]
    eye = np.asarray(cam["eye"], np.float32)
    focus = np.asarray(cam.get("focus", cam["center"]), np.float32)
    gap = torch.as_tensor(focus - eye, device=device)
    return Scene(
        field=sdf.field(tree, device, dtype),
        field64=sdf.field(tree, device, torch.float64),
        box_lo=f(lo), box_hi=f(hi), sdf_material=int(desc["sdf"]["material"]),
        plane_point=f([p["point"] for p in planes]),
        plane_normal=f([_normalize(np.asarray(p["normal"], np.float32))
                        for p in planes]),
        plane_material=i64([p["material"] for p in planes]),
        sphere_center=f([s["center"] for s in spheres]),
        sphere_radius=f([s["radius"] for s in spheres]),
        sphere_material=i64([s["material"] for s in spheres]),
        light_sphere=lights[0], materials=materials,
        env=f(desc["environment"]), eye=torch.as_tensor(eye, device=device),
        **_camera_basis(cam, device),
        m=1.0 / math.tan(cam["fovy"] * math.pi / 360.0),
        focal_distance=tracer.sqrt(dot(gap, gap)),
        aperture=float(np.float32(cam.get("aperture", 0.0))),
        max_bounces=int(desc["max_bounces"]))


class Walker(tracer.Walker):
    """tracer.Walker's planes and spheres, and the SDF in place of the
    mesh."""

    def __init__(self, scene: Scene):
        self.s = scene

    def _sdf(self, o, d, bound):
        s = self.s
        te, tx = sdf.box_clip(o, d, s.box_lo, s.box_hi)
        return sdf.sphere_trace(s.field, o, d, te, torch.minimum(tx, bound))

    def closest(self, o, d):
        """(t, kind, index, u, v): kind 0 none, 1 plane, 2 sphere, 4 the
        SDF; the first of equal minima within a kind, and a later kind
        only where strictly nearer."""
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
        t = self._sdf(o, d, best)
        better = t < best
        best = torch.where(better, t, best)
        kind = torch.where(better, SDF_KIND, kind)
        idx = torch.where(better, 0, idx)
        zero = torch.zeros_like(best)
        return best, kind, idx, zero, zero

    def occluded(self, o, d, t_cut):
        """Whether a plane, sphere or the SDF lies at t in (1e-4, t_cut)."""
        occ = (self._planes(o, d) < t_cut[:, None]).any(dim=1)
        occ = occ | (self._spheres(o, d) < t_cut[:, None]).any(dim=1)
        cut = torch.where(occ, torch.full_like(t_cut, -INF), t_cut)
        return occ | (self._sdf(o, d, cut) < t_cut)


def camera_rays(scene: Scene, x, y, width: int, height: int, ju, jv, lu,
                lv):
    """Thin-lens rays through pixel (x, y) at jitter (ju, jv) and lens
    sample (lu, lv), all in [0, 1) (see the module)."""
    o, d = tracer.camera_rays(scene, x, y, width, height, ju, jv)
    if scene.aperture <= 0.0:
        return o, d
    dt = d.dtype
    angle = lu * 2.0 * math.pi
    radius = lv * scene.aperture
    focal = o + d * scene.focal_distance.to(dt)
    org = (o + scene.cu.to(dt) * (tracer._f64(torch.cos, angle)
                                  * radius)[:, None]
           + scene.cv.to(dt) * (tracer._f64(torch.sin, angle)
                                * radius)[:, None])
    return org, normalize(focal - org)


def _shade(scene: Scene, o, d, t, kind, idx, colors):
    """Hit point, shading normal toward the ray, inside flag, material
    fields and albedo of each lane (garbage where kind is 0)."""
    s = scene
    pos = o + d * t[:, None]
    r = o.shape[0]
    normal = torch.zeros((r, 3), dtype=o.dtype, device=o.device)
    normal[:, 1] = 1.0
    mat = torch.full((r,), s.sdf_material, dtype=torch.int64,
                     device=o.device)
    si = torch.clamp(idx, max=s.sphere_center.shape[0] - 1)
    sph = kind == 2
    normal = torch.where(sph[:, None], normalize(pos - s.sphere_center[si]),
                         normal)
    mat = torch.where(sph, s.sphere_material[si], mat)
    pi = torch.clamp(idx, max=s.plane_point.shape[0] - 1)
    pla = kind == 1
    normal = torch.where(pla[:, None], s.plane_normal[pi], normal)
    mat = torch.where(pla, s.plane_material[pi], mat)
    on = torch.nonzero(kind == SDF_KIND).squeeze(1)
    if on.numel():
        normal = normal.index_put((on,), sdf.normal(s.field64, pos[on]))
    facing = dot(normal, d) > 0.0
    normal = torch.where(facing[:, None], -normal, normal)
    inside = facing & (kind != 0) & (kind != SDF_KIND)
    m = {k: v[mat] for k, v in s.materials.items()}
    return pos, normal, inside, m, colors[mat]


def trace(walker: Walker, org, dirn, key: tuple, lanes, colors=None):
    """Radiance (R, 3) of the camera paths org, dirn whose wavefront
    indices are `lanes`, from the trace key `key`: tracer.trace's
    estimator with the SDF's closest hit, occlusion and shading."""
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
        t, kind, idx, _u, _v = walker.closest(o, d)
        pos, normal, inside, m, color = _shade(s, o, d, t, kind, idx, colors)
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


def samples(rs: Scene, ys, xs, width: int, height: int, spp: int, key,
            dt=torch.float32):
    """(spp, P, 3) radiance of `spp` camera paths through each pixel
    (ys, xs), jittered uniformly in the pixel and on the lens, from
    `key`."""
    walker = Walker(rs)
    p = ys.shape[0]
    n = spp * p
    kj, kl, kt = rng.split(key, 3)
    out = []
    for a in range(0, n, BATCH):
        lanes = torch.arange(a, min(n, a + BATCH), device=ys.device)
        px = lanes % p
        o, d = camera_rays(rs, xs[px], ys[px], width, height,
                           rng.uniform_at(kj, lanes).to(dt),
                           rng.uniform_at(kj, lanes + n).to(dt),
                           rng.uniform_at(kl, lanes).to(dt),
                           rng.uniform_at(kl, lanes + n).to(dt))
        out.append(trace(walker, o, d, kt, lanes).float())
    return torch.cat(out).reshape(spp, p, 3)
