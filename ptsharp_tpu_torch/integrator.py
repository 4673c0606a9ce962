"""Wavefront path integrator over torch tensors.

Counterpart of ptsharp_tpu/integrator.py for the forward render: a whole
SoA wavefront advances one bounce at a time (closest-hit -> masked
material sampling -> next-event estimation -> Russian roulette), and the
depths run as a Python loop. Every random draw comes from the threefry
key chain of core/rng.py, with the JAX package's keys and layout, so the
two integrators make the same decisions ray by ray.

Covered here: the naive specular mode, light modes "random" and "power",
analytic lights with any-hit shadow rays, and the sync-free compacted
trace. The rest raises
NotImplementedError naming the ROADMAP item that ports it. The port is
forward-only: the JAX package's remat options (backward-pass memory) and
its tape have no counterpart.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ptsharp_tpu_torch.core import rng, sampling, vec
from ptsharp_tpu_torch.intersect import (
    Hit, HitInfo, closest_hit, hit_info, light_hit_t, occlusion_query,
)
from ptsharp_tpu_torch.scene import PT_NONE, SceneData, not_ported

LIGHT_MODE_RANDOM = "random"  # one random light x nLights
LIGHT_MODE_ALL = "all"        # average over all lights
LIGHT_MODE_POWER = "power"    # one light picked proportional to power

SPECULAR_MODE_NAIVE = "naive"
SPECULAR_MODE_FIRST = "first"
SPECULAR_MODE_ALL = "all"

INF = vec.INF


@dataclass(frozen=True)
class IntegratorConfig:
    max_bounces: int = 4
    direct_lighting: bool = True
    soft_shadows: bool = True
    light_mode: str = LIGHT_MODE_RANDOM
    specular_mode: str = SPECULAR_MODE_NAIVE
    russian_roulette: bool = False
    rr_start_depth: int = 2
    rr_min_prob: float = 0.05
    # sort each bounce's wavefront by direction octant + origin Morton code
    # before closest-hit (results scattered back)
    sort_bounces: bool = True
    # NEE shadow rays as any-hit queries bounded by the light's analytic
    # hit distance (the closest-hit visibility variant is not ported)
    anyhit_shadows: bool = True

    def __post_init__(self):
        if not self.anyhit_shadows:
            raise not_ported("closest-hit shadow rays (anyhit_shadows=False)",
                             "Queue 1 item 10")
        if self.light_mode not in (LIGHT_MODE_RANDOM, LIGHT_MODE_POWER):
            if self.light_mode == LIGHT_MODE_ALL:
                raise not_ported("light mode 'all'", "Queue 1 item 10")
            raise ValueError(self.light_mode)
        if self.specular_mode != SPECULAR_MODE_NAIVE:
            if self.specular_mode in (SPECULAR_MODE_FIRST, SPECULAR_MODE_ALL):
                raise not_ported(f"specular mode {self.specular_mode!r}",
                                 "Queue 1 item 10")
            raise ValueError(self.specular_mode)


class RayState(NamedTuple):
    org: torch.Tensor          # (R, 3)
    dirn: torch.Tensor         # (R, 3)
    throughput: torch.Tensor   # (R, 3)
    radiance: torch.Tensor     # (R, 3)
    emission_ok: torch.Tensor  # (R,) bool: add emitter radiance on hit?
    alive: torch.Tensor        # (R,) bool


class TraceResult(NamedTuple):
    radiance: torch.Tensor     # (R, 3)
    albedo: torch.Tensor       # (R, 3) first-hit material color
    normal: torch.Tensor       # (R, 3) first-hit shading normal
    rays_traced: torch.Tensor  # () int64, on the wavefront's device


def _uniform(key, r: int, like):
    return rng.uniform(key, (r,), device=like.device)


def _resolve_color(scene: SceneData, mat, info: HitInfo):
    """Per-point textured albedo (Material.MaterialAt)."""
    color = mat.color
    if scene.textures.nontrivial:
        tex_c = scene.textures.sample(mat.texture, info.tex_u, info.tex_v)
        color = torch.where((mat.texture >= 0)[:, None], tex_c, color)
    return color


def _resolve_gloss(scene: SceneData, mat, info: HitInfo):
    gloss = mat.gloss
    if scene.textures.nontrivial:
        tex_g = scene.textures.sample(mat.gloss_texture, info.tex_u,
                                      info.tex_v)
        gloss = torch.where(mat.gloss_texture >= 0,
                            torch.mean(tex_g, dim=-1), gloss)
    return gloss


def env_uv(scene: SceneData, dirn):
    """Lat-long env coordinates for a direction batch."""
    d = dirn
    u = torch.atan2(d[..., 2], d[..., 0]) + scene.texture_angle
    v = torch.atan2(d[..., 1], torch.sqrt(d[..., 0] ** 2 + d[..., 2] ** 2))
    u = (u + math.pi) / (2.0 * math.pi)
    v = (v + math.pi / 2.0) / math.pi
    return u, v


def sample_environment(scene: SceneData, dirn):
    """Panoramic lat-long environment or flat color."""
    if scene.env_texture >= 0:
        u, v = env_uv(scene, dirn)
        tid = torch.full(dirn.shape[:-1], scene.env_texture,
                         dtype=torch.int32, device=dirn.device)
        return scene.textures.sample(tid, u, v)
    return torch.broadcast_to(scene.env_color, dirn.shape)


def sample_lights(scene: SceneData, cfg: IntegratorConfig, position, normal,
                  key, active=None):
    """Batched NEE (Sampler.sampleLights): the direct-light contribution
    BEFORE albedo weighting, and the shadow-ray count. Lanes where
    `active` is False skip all shadow traversal; their contribution is
    garbage the caller masks."""
    n_lights = scene.num_lights
    r = position.shape[0]
    dev = position.device
    if n_lights == 0 or not cfg.direct_lighting:
        return torch.zeros((r, 3), device=dev), 0
    if active is None:
        active = torch.ones(r, dtype=torch.bool, device=dev)

    def one_light(lidx, key):
        center = scene.light_center[lidx]
        radius = scene.light_radius[lidx]
        k1, k2, _k3 = rng.split(key, 3)
        if cfg.soft_shadows:
            u1 = _uniform(k1, r, position)
            u2 = _uniform(k2, r, position)
            dx, dy = sampling.uniform_disc_area(u1, u2)
            t_ax, b_ax = vec.orthonormal_basis(vec.normalize(center - position))
            point = (center + t_ax * (dx * radius)[:, None]
                     + b_ax * (dy * radius)[:, None])
        else:
            point = center
        ray_dir = vec.normalize(point - position)
        cos_t = vec.dot(ray_dir, normal)
        facing = cos_t > 0.0
        # the ray must reach the light's own surface: its analytic hit
        # distance, less a margin so the light never self-occludes, bounds
        # a boolean any-hit query
        t_light = light_hit_t(scene, position, ray_dir, lidx)
        t_hit = t_light < INF
        t_cut = t_light * (1.0 - 1e-3) - 1e-3
        t_cut = torch.where(facing & t_hit & active, t_cut,
                            torch.full_like(t_cut, -INF))
        if cfg.sort_bounces and scene.has_meshes:
            occ = _sorted_occlusion(scene, position, ray_dir, t_cut)
        else:
            occ = occlusion_query(scene, position, ray_dir, t_cut)
        visible = t_hit & ~occ
        # solid-angle coverage ~ r^2/d^2 capped at 1 (Sampler.cs:277-289)
        hyp = vec.length(center - position)
        cov = (radius * radius) / torch.clamp(hyp * hyp - radius * radius,
                                              min=1e-12)
        cov = torch.where(hyp < radius, 1.0, torch.clamp(cov, max=1.0))
        lmat = scene.materials.gather(scene.light_mat[lidx])
        scale = lmat.emittance * cos_t * cov
        contrib = lmat.color * scale[:, None]
        ok = facing & visible
        return torch.where(ok[:, None], contrib, 0.0)

    kpick, ksmp = rng.split(key)
    if cfg.light_mode == LIGHT_MODE_POWER:
        u = _uniform(kpick, r, position)
        lidx = torch.clamp(
            torch.searchsorted(scene.light_cdf, u, right=True),
            0, n_lights - 1)
        inv_pdf = 1.0 / torch.clamp(scene.light_pmf[lidx], min=1e-12)
        return one_light(lidx, ksmp) * inv_pdf[:, None], r
    lidx = rng.randint(kpick, (r,), 0, n_lights, device=dev).long()
    return one_light(lidx, ksmp) * float(n_lights), r


def _bounce(scene: SceneData, cfg: IntegratorConfig, state: RayState,
            info: HitInfo, mat, color, gloss, key, u1, u2):
    """One material-sampling event over the wavefront (Ray.Bounce,
    Ray.cs:44-85). Returns (new_org, new_dirn, branch_weight, is_specular)."""
    n = info.normal
    d = state.dirn
    n1 = torch.where(info.inside, mat.index, 1.0)
    n2 = torch.where(info.inside, 1.0, mat.index)
    fresnel = vec.reflectance(n, d, n1, n2)
    p = torch.where(mat.reflectivity >= 0.0, mat.reflectivity, fresnel)
    p = torch.clamp(p, 0.0, 1.0)

    r = p.shape[0]
    kcoin, kcone = rng.split(key)
    reflect_branch = _uniform(kcoin, r, p) < p
    ku, kv = rng.split(kcone)
    cu = _uniform(ku, r, p)
    cv = _uniform(kv, r, p)

    spec_dir = sampling.cone(vec.normalize(vec.reflect(n, d)), gloss, cu, cv)
    refr_raw = vec.refract(n, d, n1, n2)
    tir = vec.dot(refr_raw, refr_raw) < 1e-12
    refr_dir = sampling.cone(vec.normalize(refr_raw), gloss, cu, cv)
    diff_dir = sampling.cosine_hemisphere(n, u1, u2)

    transparent = mat.transparent & ~reflect_branch
    # TIR in the transparent branch reflects (energy-conserving)
    transparent_dir = torch.where(tir[:, None], spec_dir, refr_dir)
    new_dir = torch.where(
        reflect_branch[:, None], spec_dir,
        torch.where(transparent[:, None], transparent_dir, diff_dir))
    is_specular = reflect_branch | transparent

    # specular/refract tinted by Mix(1, color, tint); diffuse by albedo
    one = torch.ones_like(color)
    tinted = one + (color - one) * mat.tint[:, None]
    branch_weight = torch.where(is_specular[:, None], tinted, color)
    new_org = info.position + new_dir * 1e-4
    return new_org, new_dir, branch_weight, is_specular


def _mesh_root_box(scene: SceneData):
    """World-space root box of the flat mesh tree (a sort-partition hint:
    rays that miss every mesh go to the end of the Morton order). Only
    the "pallas" table is world-space; the XLA walks' per-instance roots
    are object-space and would misclassify, so they give no hint."""
    if scene.intersector == "pallas" and scene.has_meshes \
            and scene.p_fat.shape[0] > 0:
        return scene.p_fat[0, 0:3], scene.p_fat[0, 3:6]
    return None


def _inverse_perm(perm):
    n = perm.shape[0]
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n, dtype=perm.dtype, device=perm.device)
    return inv


def _sorted_closest_hit(scene: SceneData, org, dirn, t_max=None):
    """closest_hit on the wavefront permuted into Morton/octant order; the
    hit record is scattered back to the caller's lane order."""
    perm = torch.argsort(_morton_key(org, dirn, box=_mesh_root_box(scene)),
                         stable=True)
    tm = None if t_max is None else t_max[perm]
    hit = closest_hit(scene, org[perm], dirn[perm], t_max=tm)
    inv = _inverse_perm(perm)
    return Hit(*(f[inv] for f in hit))


def _sorted_occlusion(scene: SceneData, org, dirn, t_cut):
    """occlusion_query in Morton/octant order, scattered back."""
    perm = torch.argsort(_morton_key(org, dirn, box=_mesh_root_box(scene)),
                         stable=True)
    occ = occlusion_query(scene, org[perm], dirn[perm], t_cut[perm])
    return occ[_inverse_perm(perm)]


def _step(scene: SceneData, cfg: IntegratorConfig, state: RayState, rays,
          depth_key, u1, u2, depth: int, sort_rays: bool = False):
    """One wavefront bounce. Returns (state, rays, first_albedo,
    first_normal)."""
    do_sort = sort_rays and cfg.sort_bounces and scene.has_meshes
    # dead lanes carry a collapsed t bound so traversal retires them
    lane_tmax = torch.where(state.alive, INF, -INF)
    if do_sort:
        hit = _sorted_closest_hit(scene, state.org, state.dirn, lane_tmax)
    else:
        hit = closest_hit(scene, state.org, state.dirn, t_max=lane_tmax)
    rays = rays + torch.sum(state.alive)
    info = hit_info(scene, state.org, state.dirn, hit)
    mat = scene.materials.gather(info.mat_id)
    color = _resolve_color(scene, mat, info)
    gloss = _resolve_gloss(scene, mat, info)

    missed = hit.ptype == PT_NONE
    env = sample_environment(scene, state.dirn)
    radiance = state.radiance + torch.where(
        (state.alive & missed)[:, None], state.throughput * env, 0.0)
    alive = state.alive & ~missed

    # emissive hit: with NEE only specular-continued paths add emission
    emissive = mat.emittance > 0.0
    allowed = (state.emission_ok if cfg.direct_lighting
               else torch.ones_like(state.emission_ok))
    emit_add = alive & emissive & allowed
    radiance = radiance + torch.where(
        emit_add[:, None], state.throughput * color * mat.emittance[:, None],
        0.0)
    if cfg.direct_lighting:
        alive = alive & ~(emissive & ~state.emission_ok)

    kb, kn, krr = rng.split(depth_key, 3)
    new_org, new_dir, branch_w, is_spec = _bounce(
        scene, cfg, state, info, mat, color, gloss, kb, u1, u2)
    throughput = state.throughput * branch_w

    # NEE on the diffuse branch: post-branch throughput * direct
    if cfg.direct_lighting and scene.num_lights > 0:
        nee_active = alive & ~is_spec
        direct, _n = sample_lights(scene, cfg, info.position, info.normal,
                                   kn, active=nee_active)
        radiance = radiance + torch.where(nee_active[:, None],
                                          throughput * direct, 0.0)
        rays = rays + torch.sum(nee_active)

    if cfg.russian_roulette:
        prob = torch.clamp(torch.amax(throughput, dim=-1), cfg.rr_min_prob,
                           1.0)
        if depth < cfg.rr_start_depth:
            prob = torch.ones_like(prob)
        survive = _uniform(krr, prob.shape[0], prob) < prob
        throughput = torch.where(survive[:, None], throughput / prob[:, None],
                                 throughput)
        alive = alive & survive

    a3 = alive[:, None]
    new_state = RayState(
        org=torch.where(a3, new_org, state.org),
        dirn=torch.where(a3, new_dir, state.dirn),
        throughput=torch.where(a3, throughput, state.throughput),
        radiance=radiance,
        emission_ok=torch.where(alive, is_spec, state.emission_ok),
        alive=alive,
    )
    return new_state, rays, color, info.normal


def _initial_state(org, dirn) -> RayState:
    r = org.shape[0]
    dev = org.device
    return RayState(
        org=org, dirn=dirn,
        throughput=torch.ones((r, 3), dtype=torch.float32, device=dev),
        radiance=torch.zeros((r, 3), dtype=torch.float32, device=dev),
        emission_ok=torch.ones(r, dtype=torch.bool, device=dev),
        alive=torch.ones(r, dtype=torch.bool, device=dev))


def _trace_span(scene, cfg: IntegratorConfig, state, rays, krest, d0: int,
                d1: int, si: int = 0):
    """Depths [d0, d1) with the one key chain
    fold_in(fold_in(krest, si*1024), depth) that every trace variant uses."""
    r = state.org.shape[0]
    for depth in range(d0, d1):
        dk = rng.fold_in(rng.fold_in(krest, si * 1024), depth)
        ku, kv = rng.split(rng.fold_in(dk, 7))
        uu = _uniform(ku, r, state.org)
        vv = _uniform(kv, r, state.org)
        state, rays, _, _ = _step(scene, cfg, state, rays, dk, uu, vv, depth,
                                  sort_rays=True)
    return state, rays


def _trace_prefix(scene, cfg: IntegratorConfig, org, dirn, key, strat_idx,
                  n_strat: int, d_stop: int):
    """Depths [0, d_stop). Returns the carried state, the ray count, the
    depth-0 albedo and normal, and krest for the later depths."""
    r = org.shape[0]
    k0, krest = rng.split(key)
    k0a, k0u, k0v = rng.split(k0, 3)
    u1 = _uniform(k0u, r, org)
    u2 = _uniform(k0v, r, org)
    if strat_idx is not None and n_strat > 1:
        u1, u2 = sampling.stratified_pair(u1, u2, n_strat, strat_idx)
    rays = torch.zeros((), dtype=torch.int64, device=org.device)
    state, rays, alb, nrm = _step(scene, cfg, _initial_state(org, dirn), rays,
                                  k0a, u1, u2, 0)
    state, rays = _trace_span(scene, cfg, state, rays, krest, 1, d_stop)
    return state, rays, alb, nrm, krest


def trace(scene: SceneData, cfg: IntegratorConfig, org, dirn, key,
          strat_idx=None, n_strat: int = 1) -> TraceResult:
    """Trace a wavefront of R primary rays to completion. strat_idx:
    optional (R,) sample index in [0, n_strat^2) for stratified first-hit
    sampling. The forward pass needs no gradients."""
    with torch.no_grad():
        state, rays, alb, nrm, _ = _trace_prefix(
            scene, cfg, org, dirn, key, strat_idx, n_strat,
            cfg.max_bounces + 1)
    return TraceResult(state.radiance, alb, nrm, rays)


def _morton_key(p, d, box=None):
    """(R,) coherence key in int64 holding a uint32: [31] mesh-root-box
    miss bit (with `box`) | [27:30] direction octant | [0:27] origin
    Morton code over the batch's bounding box."""
    lo = torch.amin(p, dim=0)
    hi = torch.amax(p, dim=0)
    q = torch.clamp((p - lo) / torch.clamp(hi - lo, min=1e-9), 0.0, 1.0)

    def expand(x):
        v = (x * 511.0).to(torch.int64)  # 9 bits per axis
        v = (v * 0x00010001) & 0xFF0000FF
        v = (v * 0x00000101) & 0x0F00F00F
        v = (v * 0x00000011) & 0xC30C30C3
        v = (v * 0x00000005) & 0x49249249
        return v

    m = (expand(q[..., 0]) << 2) | (expand(q[..., 1]) << 1) | expand(q[..., 2])
    octant = ((d[..., 0] > 0).to(torch.int64)
              | ((d[..., 1] > 0).to(torch.int64) << 1)
              | ((d[..., 2] > 0).to(torch.int64) << 2))
    key = (octant << 27) | m
    if box is not None:
        blo, bhi = box
        tiny = torch.where(d < 0, -1e-30, 1e-30)
        inv = 1.0 / torch.where(torch.abs(d) < 1e-30, tiny, d)
        n = (blo[None, :] - p) * inv
        f = (bhi[None, :] - p) * inv
        t0 = torch.amax(torch.minimum(n, f), dim=-1)
        t1 = torch.amin(torch.maximum(n, f), dim=-1)
        miss = (t1 < torch.clamp(t0, min=0.0)).to(torch.int64)
        key = (miss << 31) | key
    return key


def _reservoir_compact(state: RayState, cap: int, key):
    """Shrink the wavefront to `cap` lanes with no host sync and no bias:
    if S = #alive exceeds cap, a uniform-random subset of cap lanes
    survives and each survivor's throughput is reweighted by S/cap. Kept
    lanes are packed to the front in Morton/octant order (stable sorts, so
    equal keys keep lane order and the next depth's draws line up with the
    reference). Returns (small_state, src)."""
    alive = state.alive
    r = alive.shape[0]
    s_cnt = torch.sum(alive)
    u = _uniform(key, r, state.org)
    order = torch.argsort(torch.where(alive, u, 2.0), stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(r, device=order.device)
    keep = alive & (rank < cap)
    w = torch.where(s_cnt > cap, s_cnt.to(torch.float32) / cap, 1.0)
    throughput = torch.where(keep[:, None], state.throughput * w,
                             state.throughput)
    pack = torch.where(keep, _morton_key(state.org, state.dirn), 0xFFFFFFFF)
    src = torch.argsort(pack, stable=True)[:cap]
    small = RayState(
        org=state.org[src],
        dirn=state.dirn[src],
        throughput=throughput[src],
        radiance=torch.zeros((cap, 3), dtype=torch.float32,
                             device=alive.device),
        emission_ok=state.emission_ok[src],
        alive=keep[src],
    )
    return small, src


def _static_tail(scene, cfg: IntegratorConfig, state: RayState, krest,
                 schedule, d_max: int):
    """Depths [schedule[0].d, d_max) with reservoir compaction at each
    scheduled (depth, cap); radiance of each smaller buffer is added back
    up the chain."""
    rays = torch.zeros((), dtype=torch.int64, device=state.org.device)
    stack = []
    cur = state
    for i, (d, cap) in enumerate(schedule):
        ck = rng.fold_in(krest, 70000 + 131 * d)
        small, src = _reservoir_compact(cur, cap, ck)
        stack.append((cur.radiance, src))
        d_next = schedule[i + 1][0] if i + 1 < len(schedule) else d_max
        cur, rays = _trace_span(scene, cfg, small, rays, krest, d, d_next)
    rad = cur.radiance
    for parent_rad, src in reversed(stack):
        rad = parent_rad.index_add(0, src, rad)
    return rad, rays


def compaction_schedule(cfg: IntegratorConfig, r: int,
                        schedule: tuple | None = None,
                        min_cap: int = 1 << 12) -> tuple:
    """The static (depth, cap) reservoir schedule trace_compacted_static
    uses for an r-ray wavefront; empty means compaction cannot engage."""
    if cfg.specular_mode != SPECULAR_MODE_NAIVE:
        return ()
    if schedule is None:
        if cfg.russian_roulette:
            d1 = cfg.rr_start_depth + 1
            schedule = ((d1, max(min_cap, r // 4)),
                        (d1 + 2, max(min_cap, r // 16)))
        else:
            schedule = ((2, max(min_cap, r // 2)),
                        (3, max(min_cap, r // 4)),
                        (4, max(min_cap, r // 8)))
    return tuple((d, c) for (d, c) in schedule
                 if d <= cfg.max_bounces and c < r)


def trace_compacted_static(scene: SceneData, cfg: IntegratorConfig, org,
                           dirn, key, strat_idx=None, n_strat: int = 1,
                           schedule: tuple | None = None,
                           min_cap: int = 1 << 12) -> TraceResult:
    """Sync-free wavefront compaction: capacities fixed up front by
    compaction_schedule, and _reservoir_compact keeps the estimator
    unbiased if more lanes survive than a cap allows. Falls back to trace()
    when the schedule is empty."""
    r = org.shape[0]
    schedule = compaction_schedule(cfg, r, schedule, min_cap)
    if not schedule:
        return trace(scene, cfg, org, dirn, key, strat_idx, n_strat)
    with torch.no_grad():
        state, rays, alb, nrm, krest = _trace_prefix(
            scene, cfg, org, dirn, key, strat_idx, n_strat, schedule[0][0])
        radiance, tail_rays = _static_tail(scene, cfg, state, krest, schedule,
                                           cfg.max_bounces + 1)
    return TraceResult(radiance, alb, nrm, rays + tail_rays)
