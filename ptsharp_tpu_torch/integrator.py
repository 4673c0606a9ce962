"""Wavefront path integrator over torch tensors.

Counterpart of ptsharp_tpu/integrator.py for the forward render: a whole
SoA wavefront advances one bounce at a time (closest-hit -> masked
material sampling -> next-event estimation -> Russian roulette), and the
depths run as a Python loop. Every random draw comes from the threefry
key chain of core/rng.py, with the JAX package's keys and layout, so the
two integrators make the same decisions ray by ray.

Covered here: the specular modes "naive", "first" and "all" (the branch
split: one shared closest hit feeds a diffuse and a specular wavefront at
each split depth), light modes "random", "power" and "all", analytic and
mesh lights (emissive triangles sampled by area) with any-hit or
closest-hit shadow rays, and the two compacted traces, the sync-free
trace_compacted_static and trace_compacted with its one host sync (naive
mode only; the split modes trace plainly, as in the JAX package).

Radiance is differentiable in the material table, the texture atlas and
the environment color, as in the JAX package: geometry and every discrete
decision (branch coins, light picks, Russian roulette's probability, the
Morton keys, the reservoir weight) are detached where it calls
stop_gradient, and traversal never sees a tensor that requires grad.
`remat` recomputes each scanned depth in the backward pass
(torch.utils.checkpoint), `want_tape` records the per-depth TapeRecord
that tape.py's analytic backward replays.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch.utils import checkpoint

from ptsharp_tpu_torch import profiling
from ptsharp_tpu_torch.core import rng, sampling, vec
from ptsharp_tpu_torch.intersect import (
    Hit, HitInfo, closest_hit, hit_info, light_hit_t, occlusion_query,
)
from ptsharp_tpu_torch.scene import (
    PT_CUBE, PT_CYLINDER, PT_NONE, PT_SPHERE, PT_TRIANGLE, SceneData,
)

LIGHT_MODE_RANDOM = "random"  # one random light x nLights
LIGHT_MODE_ALL = "all"        # average over all lights
LIGHT_MODE_POWER = "power"    # one light picked proportional to power

SPECULAR_MODE_NAIVE = "naive"  # one coin-flipped branch every bounce
SPECULAR_MODE_FIRST = "first"  # both branches at the first hit
SPECULAR_MODE_ALL = "all"      # both at the first all_split_depth hits

INF = vec.INF

# the light types whose own hit distance light_hit_t knows (a mesh light's:
# the sampled point's), which any-hit shadows need
_ANALYTIC_LIGHT_TYPES = (PT_SPHERE, PT_CUBE, PT_CYLINDER, PT_TRIANGLE)


@dataclass(frozen=True)
class IntegratorConfig:
    max_bounces: int = 4
    direct_lighting: bool = True
    soft_shadows: bool = True
    light_mode: str = LIGHT_MODE_RANDOM
    specular_mode: str = SPECULAR_MODE_NAIVE
    all_split_depth: int = 2  # branch-split depths of SPECULAR_MODE_ALL
    russian_roulette: bool = False
    rr_start_depth: int = 2
    rr_min_prob: float = 0.05
    # recompute each scanned depth (1..max_bounces) in the backward pass
    # instead of keeping its residuals: "full" re-runs the whole depth,
    # closest-hit included; "hits" keeps the depth's hit record and
    # re-runs shading and NEE (shadow rays included). Exact either way.
    remat: bool = True
    remat_policy: str = "full"
    # sort each bounce's wavefront by direction octant + origin Morton code
    # before closest-hit (results scattered back)
    sort_bounces: bool = True
    # NEE shadow rays as any-hit queries bounded by the light's hit
    # distance, where every light has one (analytic primitives, sampled
    # mesh-light points; not an emissive SDF: uses_anyhit_shadows); else,
    # and with False, a closest-hit bounded just past the light that must
    # land on it
    anyhit_shadows: bool = True

    def __post_init__(self):
        if self.remat_policy not in ("full", "hits"):
            raise ValueError(self.remat_policy)
        if self.light_mode not in (LIGHT_MODE_RANDOM, LIGHT_MODE_ALL,
                                   LIGHT_MODE_POWER):
            raise ValueError(self.light_mode)
        if self.specular_mode not in (SPECULAR_MODE_NAIVE,
                                      SPECULAR_MODE_FIRST, SPECULAR_MODE_ALL):
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


# tape flag bits (TapeRecord.flags)
TAPE_MISS_ENV = 1   # lane adds throughput * env this depth
TAPE_EMIT = 2       # lane adds throughput * color * emittance
TAPE_NEE = 4        # lane adds (throughput * B) * direct
TAPE_SPEC = 8       # bounce took the specular branch (B = tint mix)
TAPE_TEX = 16       # resolved color came from the texture atlas
TAPE_ALIVE = 32     # lane survives into the next depth


class TapeRecord(NamedTuple):
    """One depth's record for tape.py's analytic backward: what rebuilds
    the depth's radiance terms and throughput update as a pointwise
    function of the differentiable scene parameters (no traversal, no RNG,
    no sort in the backward)."""

    t_in: torch.Tensor    # (R, 3) throughput entering the depth
    mat_id: torch.Tensor  # (R,) i32 hit material
    uv: torch.Tensor      # (R, 2) texture uv at the hit (env uv on a miss)
    lm: torch.Tensor      # (R,) i32 NEE light material id
    kappa: torch.Tensor   # (R,) f32: direct = C[lm] * e[lm] * kappa
    rr: torch.Tensor      # (R,) f32 RR survivor scale (1/prob; 1 if off)
    flags: torch.Tensor   # (R,) i32 TAPE_* bits


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
    u = vec.atan2(d[..., 2], d[..., 0]) + scene.texture_angle
    v = vec.atan2(d[..., 1], vec.sqrt(d[..., 0] ** 2 + d[..., 2] ** 2))
    u = vec.div(u + math.pi, 2.0 * math.pi)
    v = vec.div(v + math.pi / 2.0, math.pi)
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
                  key, active=None, want_aux: bool = False):
    """Batched NEE (Sampler.sampleLights): the direct-light contribution
    BEFORE albedo weighting, and the shadow-ray count. Lanes where
    `active` is False skip all shadow traversal; their contribution is
    garbage the caller masks. The light pick and the sampled point are
    detached. A mesh light (PT_TRIANGLE) samples one of its emissive
    triangles by area and a point on it; any other light a point of the
    disc facing the shading point.

    want_aux: also return the tape decomposition (lm (R,) i32, kappa (R,)
    f32, detached) with direct = color[lm] * emittance[lm] * kappa; lm is
    the sampled triangle's material for a mesh light. Light mode "all"
    returns None there: it averages over the lights."""
    n_lights = scene.num_lights
    r = position.shape[0]
    dev = position.device
    if n_lights == 0 or not cfg.direct_lighting:
        zero = torch.zeros((r, 3), device=dev)
        if want_aux:
            return zero, 0, (torch.zeros(r, dtype=torch.int32, device=dev),
                             torch.zeros(r, device=dev))
        return zero, 0
    if active is None:
        active = torch.ones(r, dtype=torch.bool, device=dev)
    has_em = scene.em_v0.shape[0] > 0  # some light samples triangles

    def one_light(lidx, key):
        center = scene.light_center[lidx]
        radius = scene.light_radius[lidx]
        is_tri = scene.light_ptype[lidx] == PT_TRIANGLE
        k1, k2, k3 = rng.split(key, 3)
        if cfg.soft_shadows or has_em:
            u1 = _uniform(k1, r, position)
            u2 = _uniform(k2, r, position)
        if cfg.soft_shadows:
            dx, dy = sampling.uniform_disc_area(u1, u2)
            t_ax, b_ax = vec.orthonormal_basis(vec.normalize(center - position))
            point = (center + t_ax * (dx * radius)[:, None]
                     + b_ax * (dy * radius)[:, None])
        else:
            point = center
        if has_em:
            tri = _sample_triangle(scene, lidx, _uniform(k3, r, position))
            su = vec.sqrt(u1)
            b1 = su * (1.0 - u2)
            b2 = su * u2
            p_tri = (scene.em_v0[tri] + scene.em_e1[tri] * b1[:, None]
                     + scene.em_e2[tri] * b2[:, None])
            point = torch.where(is_tri[:, None], p_tri, point)
        point = point.detach()
        ray_dir = vec.normalize(point - position)
        cos_t = vec.dot(ray_dir, normal)
        facing = cos_t > 0.0
        if uses_anyhit_shadows(scene, cfg):
            # the ray must reach the light's own surface: its analytic hit
            # distance (a mesh light's: the sampled point's), less a margin
            # so the light never self-occludes, bounds a boolean any-hit
            # query. A closer emissive triangle of the same light occludes
            # the sampled point, as its area pdf requires.
            t_light = light_hit_t(scene, position, ray_dir, lidx)
            if PT_TRIANGLE in scene.light_types:
                t_light = torch.where(is_tri, vec.length(point - position),
                                      t_light)
            t_hit = t_light < INF
            t_cut = t_light * (1.0 - 1e-3) - 1e-3
            t_cut = torch.where(facing & t_hit & active, t_cut,
                                torch.full_like(t_cut, -INF))
            with profiling.span("pt.occlusion"):
                if cfg.sort_bounces and scene.has_meshes:
                    occ = _sorted_occlusion(scene, position, ray_dir, t_cut)
                else:
                    occ = occlusion_query(scene, position, ray_dir, t_cut)
            visible = t_hit & ~occ
        else:
            with profiling.span("pt.occlusion"):
                visible = _shadow_hit_visible(scene, cfg, position, ray_dir,
                                              point, center, radius, lidx,
                                              is_tri, has_em, active)
        # solid-angle coverage ~ r^2/d^2 capped at 1 (Sampler.cs:277-289)
        hyp = vec.length(center - position)
        cov = (radius * radius) / torch.clamp(hyp * hyp - radius * radius,
                                              min=1e-12)
        cov = torch.where(hyp < radius, 1.0, torch.clamp(cov, max=1.0))
        lm = scene.light_mat[lidx]
        lmat = scene.materials.gather(lm)
        scale = lmat.emittance * cos_t * cov
        contrib = lmat.color * scale[:, None]
        kap = cos_t * cov
        if has_em:
            # area sampling: pdf 1 / light_area at the sampled point
            em_mat = scene.em_mat[tri]
            emat = scene.materials.gather(em_mat)
            d2 = vec.dot(point - position, point - position)
            cos_l = torch.abs(vec.dot(scene.em_nrm[tri], ray_dir))
            kap_tri = (cos_t * cos_l * scene.light_area[lidx]
                       / torch.clamp(d2, min=1e-8))
            scale_tri = emat.emittance * kap_tri
            contrib = torch.where(is_tri[:, None],
                                  emat.color * scale_tri[:, None], contrib)
            lm = torch.where(is_tri, em_mat, lm)
            kap = torch.where(is_tri, kap_tri, kap)
        ok = facing & visible
        aux = (lm.to(torch.int32), torch.where(ok, kap, 0.0).detach())
        return torch.where(ok[:, None], contrib, 0.0), aux

    if cfg.light_mode == LIGHT_MODE_ALL:
        total = torch.zeros((r, 3), device=dev)
        keys = rng.split(key, n_lights)
        for li in range(n_lights):
            c, _aux = one_light(
                torch.full((r,), li, dtype=torch.long, device=dev), keys[li])
            total = total + c
        if want_aux:
            return vec.div(total, n_lights), n_lights * r, None
        return vec.div(total, n_lights), n_lights * r
    kpick, ksmp = rng.split(key)
    if cfg.light_mode == LIGHT_MODE_POWER:
        u = _uniform(kpick, r, position)
        lidx = torch.clamp(
            torch.searchsorted(scene.light_cdf, u, right=True),
            0, n_lights - 1)
        inv_pdf = (1.0 / torch.clamp(scene.light_pmf[lidx],
                                     min=1e-12)).detach()
        contrib, (lm, kap) = one_light(lidx, ksmp)
        contrib, kap = contrib * inv_pdf[:, None], kap * inv_pdf
    else:
        lidx = rng.randint(kpick, (r,), 0, n_lights, device=dev).long()
        contrib, (lm, kap) = one_light(lidx, ksmp)
        contrib, kap = contrib * float(n_lights), kap * float(n_lights)
    if want_aux:
        return contrib, r, (lm, kap)
    return contrib, r


def uses_anyhit_shadows(scene: SceneData, cfg: IntegratorConfig) -> bool:
    """Shadow rays take the any-hit query where the config asks for it and
    every light type's own hit distance is known (an emissive SDF's is
    not: light_hit_t would read INF and every such shadow ray "invisible");
    else a closest-hit bounded just past the light, as the JAX package
    decides (ptsharp_tpu/integrator.py:298-302)."""
    return (cfg.anyhit_shadows and len(scene.light_types) > 0
            and all(t in _ANALYTIC_LIGHT_TYPES for t in scene.light_types))


def _sample_triangle(scene: SceneData, lidx, uc):
    """Each lane's emissive triangle of its light, by area: the first
    index in [light_tri_start, light_tri_end) whose em_cdf is not below
    uc, by a fixed 21-step binary search (up to 2**21 triangles a light).
    Lanes of other lights get index 0."""
    n_em = scene.em_v0.shape[0]
    start = scene.light_tri_start[lidx].long()
    end = scene.light_tri_end[lidx].long()
    lo = start
    hi = torch.maximum(end - 1, start)
    for _ in range(21):
        mid = (lo + hi) // 2
        go_hi = scene.em_cdf[torch.clamp(mid, 0, n_em - 1)] < uc
        lo = torch.where(go_hi, mid + 1, lo)
        hi = torch.where(go_hi, hi, mid)
    return torch.clamp(lo, start, torch.clamp(end - 1, min=0))


def _shadow_hit_visible(scene: SceneData, cfg: IntegratorConfig, position,
                        ray_dir, point, center, radius, lidx, is_tri, has_em,
                        active):
    """Visibility by a closest-hit bounded just past the light, which must
    land on it: on the light's primitive (its instance, for a mesh light,
    and there on an emissive triangle where the scene has mesh lights).
    Dead lanes carry a -INF bound."""
    hyp0 = vec.length(center - position)
    shadow_tmax = torch.where(
        is_tri, vec.length(point - position) * 1.001 + 1e-3,
        hyp0 + 2.0 * radius + 1e-3)
    shadow_tmax = torch.where(active, shadow_tmax,
                              torch.full_like(shadow_tmax, -INF))
    if cfg.sort_bounces and scene.has_meshes:
        hit = _sorted_closest_hit(scene, position, ray_dir, shadow_tmax)
    else:
        hit = closest_hit(scene, position, ray_dir, t_max=shadow_tmax)
    pindex = scene.light_pindex[lidx]
    idx_match = torch.where(is_tri, hit.inst == pindex, hit.pindex == pindex)
    if has_em:
        hp = torch.clamp(hit.pindex, 0, scene.tri_mat.shape[0] - 1).long()
        hover = scene.inst_mat[torch.clamp(hit.inst, min=0).long()]
        htm = torch.where(hover >= 0, hover, scene.tri_mat[hp])
        emissive = scene.materials.gather(htm).emittance > 0.0
        idx_match = idx_match & (~is_tri | emissive)
    return ((hit.ptype == scene.light_ptype[lidx]) & idx_match
            & (hit.t < INF))


def _bounce(scene: SceneData, cfg: IntegratorConfig, state: RayState,
            info: HitInfo, mat, color, gloss, key, u1, u2,
            force_mode: str | None = None):
    """One material-sampling event over the wavefront (Ray.Bounce,
    Ray.cs:44-85). force_mode: None flips the Fresnel coin; "specular" or
    "diffuse" forces the reflect branch or the other one and weights it
    by its probability (the branch split, Sampler.cs:85-131). Returns
    (new_org, new_dirn, branch_weight, is_specular)."""
    n = info.normal
    d = state.dirn
    n1 = torch.where(info.inside, mat.index, 1.0)
    n2 = torch.where(info.inside, 1.0, mat.index)
    fresnel = vec.reflectance(n, d, n1, n2)
    p = torch.where(mat.reflectivity >= 0.0, mat.reflectivity, fresnel)
    p = torch.clamp(p, 0.0, 1.0)

    r = p.shape[0]
    kcoin, kcone = rng.split(key)
    if force_mode is None:
        reflect_branch = _uniform(kcoin, r, p) < p
    else:
        reflect_branch = torch.full_like(p, force_mode == "specular",
                                         dtype=torch.bool)
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
    if force_mode is not None:
        weight = p if force_mode == "specular" else 1.0 - p
        branch_weight = branch_weight * weight[:, None]
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
    tm = None if t_max is None else t_max.detach()[perm]
    hit = closest_hit(scene, org[perm], dirn[perm], t_max=tm)
    inv = _inverse_perm(perm)
    return Hit(*(f[inv] for f in hit))


def _sorted_occlusion(scene: SceneData, org, dirn, t_cut):
    """occlusion_query in Morton/octant order, scattered back."""
    perm = torch.argsort(_morton_key(org, dirn, box=_mesh_root_box(scene)),
                         stable=True)
    occ = occlusion_query(scene, org[perm], dirn[perm], t_cut[perm])
    return occ[_inverse_perm(perm)]


def _depth_hit(scene: SceneData, cfg: IntegratorConfig, state: RayState,
               sort_rays: bool) -> Hit:
    """The depth's closest hit. Dead lanes carry a collapsed t bound so
    traversal retires them."""
    with profiling.span("pt.hit"):
        lane_tmax = torch.where(state.alive, INF, -INF)
        if sort_rays and cfg.sort_bounces and scene.has_meshes:
            return _sorted_closest_hit(scene, state.org, state.dirn,
                                       lane_tmax)
        return closest_hit(scene, state.org, state.dirn, t_max=lane_tmax)


def _step(scene: SceneData, cfg: IntegratorConfig, state: RayState, rays,
          depth_key, u1, u2, depth: int, sort_rays: bool = False,
          pre_hit: Hit | None = None, want_tape: bool = False,
          force_mode: str | None = None, count_primary: bool = True,
          suppress_shared: bool = False):
    """One wavefront bounce. Returns (state, rays, first_albedo,
    first_normal), and the depth's TapeRecord last with want_tape.
    pre_hit: the depth's closest hit, found by the caller (a branch split
    shares one between its two wavefronts). force_mode: _bounce's.
    count_primary: count the depth's rays. suppress_shared: this is the
    second wavefront of a split, whose environment and emission at this
    hit the first one added (the caller zeroes its inherited radiance),
    so only its continuation adds radiance."""
    hit = (pre_hit if pre_hit is not None
           else _depth_hit(scene, cfg, state, sort_rays))
    if count_primary:
        n_alive = torch.sum(state.alive)
        rays = rays + n_alive
        profiling.count(depth, "alive", n_alive)
        profiling.count(depth, "carried", state.alive.shape[0])
    info = hit_info(scene, state.org, state.dirn, hit)
    mat = scene.materials.gather(info.mat_id)
    color = _resolve_color(scene, mat, info)
    gloss = _resolve_gloss(scene, mat, info)

    missed = hit.ptype == PT_NONE
    miss_env = state.alive & missed
    radiance = state.radiance
    if not suppress_shared:
        env = sample_environment(scene, state.dirn)
        radiance = radiance + torch.where(
            miss_env[:, None], state.throughput * env, 0.0)
    alive = state.alive & ~missed

    # emissive hit: with NEE only specular-continued paths add emission
    emissive = mat.emittance > 0.0
    allowed = (state.emission_ok if cfg.direct_lighting
               else torch.ones_like(state.emission_ok))
    emit_add = alive & emissive & allowed
    if not suppress_shared:
        radiance = radiance + torch.where(
            emit_add[:, None],
            state.throughput * color * mat.emittance[:, None], 0.0)
    if cfg.direct_lighting:
        alive = alive & ~(emissive & ~state.emission_ok)

    kb, kn, krr = rng.split(depth_key, 3)
    new_org, new_dir, branch_w, is_spec = _bounce(
        scene, cfg, state, info, mat, color, gloss, kb, u1, u2, force_mode)
    throughput = state.throughput * branch_w

    # NEE on the diffuse branch: post-branch throughput * direct
    nee_mask = torch.zeros_like(alive)
    nee_aux = None
    if cfg.direct_lighting and scene.num_lights > 0:
        nee_mask = alive & ~is_spec
        direct, _n, nee_aux = sample_lights(
            scene, cfg, info.position, info.normal, kn, active=nee_mask,
            want_aux=True)
        radiance = radiance + torch.where(nee_mask[:, None],
                                          throughput * direct, 0.0)
        rays = rays + torch.sum(nee_mask)

    rr_scale = torch.ones_like(u1)
    if cfg.russian_roulette:
        # the survival probability is a decision: no gradient through it
        prob = torch.clamp(torch.amax(throughput.detach(), dim=-1),
                           cfg.rr_min_prob, 1.0)
        if depth < cfg.rr_start_depth:
            prob = torch.ones_like(prob)
        survive = _uniform(krr, prob.shape[0], prob) < prob
        throughput = torch.where(survive[:, None], throughput / prob[:, None],
                                 throughput)
        alive = alive & survive
        rr_scale = 1.0 / prob

    a3 = alive[:, None]
    new_state = RayState(
        org=torch.where(a3, new_org, state.org),
        dirn=torch.where(a3, new_dir, state.dirn),
        throughput=torch.where(a3, throughput, state.throughput),
        radiance=radiance,
        emission_ok=torch.where(alive, is_spec, state.emission_ok),
        alive=alive,
    )
    if not want_tape:
        return new_state, rays, color, info.normal
    has_tex = (mat.texture >= 0) & scene.textures.nontrivial
    uv = torch.stack([info.tex_u, info.tex_v], dim=-1)
    if scene.env_texture >= 0:
        eu, ev = env_uv(scene, state.dirn)
        uv = torch.where(miss_env[:, None], torch.stack([eu, ev], dim=-1), uv)
    if nee_aux is not None:
        lm, kappa = nee_aux
    else:
        lm = torch.zeros_like(info.mat_id)
        kappa = torch.zeros_like(u1)
    flags = (miss_env.to(torch.int32) * TAPE_MISS_ENV
             | emit_add.to(torch.int32) * TAPE_EMIT
             | nee_mask.to(torch.int32) * TAPE_NEE
             | is_spec.to(torch.int32) * TAPE_SPEC
             | has_tex.to(torch.int32) * TAPE_TEX
             | alive.to(torch.int32) * TAPE_ALIVE)
    tape = TapeRecord(t_in=state.throughput.detach(), mat_id=info.mat_id,
                      uv=uv.detach(), lm=lm.to(torch.int32), kappa=kappa,
                      rr=rr_scale.detach(), flags=flags)
    return new_state, rays, color, info.normal, tape


def _initial_state(org, dirn) -> RayState:
    r = org.shape[0]
    dev = org.device
    return RayState(
        org=org, dirn=dirn,
        throughput=torch.ones((r, 3), dtype=torch.float32, device=dev),
        radiance=torch.zeros((r, 3), dtype=torch.float32, device=dev),
        emission_ok=torch.ones(r, dtype=torch.bool, device=dev),
        alive=torch.ones(r, dtype=torch.bool, device=dev))


def _remat_step(scene, cfg, state, rays, dk, uu, vv, depth, pre_hit):
    state, rays, _, _ = _step(scene, cfg, state, rays, dk, uu, vv, depth,
                              sort_rays=True, pre_hit=pre_hit)
    return state, rays


def _trace_span(scene, cfg: IntegratorConfig, state, rays, krest, d0: int,
                d1: int, si: int = 0, tape: list | None = None):
    """Depths [d0, d1) with the one key chain
    fold_in(fold_in(krest, si*1024), depth) that every trace variant uses.
    Under autograd with cfg.remat each depth is a checkpoint that the
    backward re-runs ("full"), or re-runs past the depth's closest hit,
    kept from the forward ("hits"). `tape`, if a list, collects each
    depth's TapeRecord."""
    r = state.org.shape[0]
    remat = cfg.remat and torch.is_grad_enabled() and tape is None
    for depth in range(d0, d1):
        with profiling.span("pt.depth"):
            dk = rng.fold_in(rng.fold_in(krest, si * 1024), depth)
            ku, kv = rng.split(rng.fold_in(dk, 7))
            uu = _uniform(ku, r, state.org)
            vv = _uniform(kv, r, state.org)
            if remat:
                pre_hit = (_depth_hit(scene, cfg, state, sort_rays=True)
                           if cfg.remat_policy == "hits" else None)
                state, rays = checkpoint.checkpoint(
                    _remat_step, scene, cfg, state, rays, dk, uu, vv, depth,
                    pre_hit, use_reentrant=False, preserve_rng_state=False)
            elif tape is not None:
                state, rays, _, _, record = _step(
                    scene, cfg, state, rays, dk, uu, vv, depth,
                    sort_rays=True, want_tape=True)
                tape.append(record)
            else:
                state, rays, _, _ = _step(scene, cfg, state, rays, dk, uu,
                                          vv, depth, sort_rays=True)
    return state, rays


def _depth0_draws(org, key, strat_idx, n_strat: int):
    """Depth 0's key k0a and (possibly stratified) uniforms u1, u2, and
    krest for the later depths."""
    r = org.shape[0]
    k0, krest = rng.split(key)
    k0a, k0u, k0v = rng.split(k0, 3)
    u1 = _uniform(k0u, r, org)
    u2 = _uniform(k0v, r, org)
    if strat_idx is not None and n_strat > 1:
        u1, u2 = sampling.stratified_pair(u1, u2, n_strat, strat_idx)
    return k0a, u1, u2, krest


def _trace_prefix(scene, cfg: IntegratorConfig, org, dirn, key, strat_idx,
                  n_strat: int, d_stop: int, tape: list | None = None):
    """Depths [0, d_stop). Returns the carried state, the ray count, the
    depth-0 albedo and normal, and krest for the later depths. Depth 0 is
    never a checkpoint. `tape`, if a list, collects each depth's
    TapeRecord."""
    with profiling.span("pt.depth"):
        k0a, u1, u2, krest = _depth0_draws(org, key, strat_idx, n_strat)
        rays = torch.zeros((), dtype=torch.int64, device=org.device)
        out = _step(scene, cfg, _initial_state(org, dirn), rays, k0a, u1, u2,
                    0, want_tape=tape is not None)
    state, rays, alb, nrm = out[:4]
    if tape is not None:
        tape.append(out[4])
    state, rays = _trace_span(scene, cfg, state, rays, krest, 1, d_stop,
                              tape=tape)
    return state, rays, alb, nrm, krest


def _n_split(cfg: IntegratorConfig) -> int:
    """Depths that force both branches (the wavefront doubles at each)."""
    if cfg.specular_mode == SPECULAR_MODE_FIRST:
        return 1
    if cfg.specular_mode == SPECULAR_MODE_ALL:
        return max(1, min(cfg.all_split_depth, cfg.max_bounces + 1))
    return 0


def trace(scene: SceneData, cfg: IntegratorConfig, org, dirn, key,
          strat_idx=None, n_strat: int = 1) -> TraceResult:
    """Trace a wavefront of R primary rays to completion. strat_idx:
    optional (R,) sample index in [0, n_strat^2) for stratified first-hit
    sampling. Differentiable in the scene's material table, texture atlas
    and environment color where autograd is on (Renderer turns it off).

    The split modes run each split depth d on every state si with the key
    fold_in(fold_in(k0a, d*131), si) (the specular wavefront's folded
    with 1) from one unsorted closest hit the two branches share, then
    each state's remaining depths with _trace_span's key chain of index
    si; the radiances are summed in state order."""
    n_split = _n_split(cfg)
    if n_split == 0:
        state, rays, alb, nrm, _ = _trace_prefix(
            scene, cfg, org, dirn, key, strat_idx, n_strat,
            cfg.max_bounces + 1)
        return TraceResult(state.radiance, alb, nrm, rays)
    r = org.shape[0]
    k0a, u1, u2, krest = _depth0_draws(org, key, strat_idx, n_strat)
    rays = torch.zeros((), dtype=torch.int64, device=org.device)
    states = [_initial_state(org, dirn)]
    alb = nrm = None
    for d in range(n_split):
        split = []
        for si, st in enumerate(states):
            with profiling.span("pt.depth"):
                dk = rng.fold_in(rng.fold_in(k0a, d * 131), si)
                if d == 0:
                    uu, vv = u1, u2
                else:
                    ku, kv = rng.split(rng.fold_in(dk, 7))
                    uu = _uniform(ku, r, org)
                    vv = _uniform(kv, r, org)
                with profiling.span("pt.hit"):
                    hit0 = closest_hit(scene, st.org, st.dirn)
                s_d, rays, a_, n_ = _step(scene, cfg, st, rays, dk, uu, vv,
                                          d, pre_hit=hit0,
                                          force_mode="diffuse")
                st_z = st._replace(radiance=torch.zeros_like(st.radiance))
                s_s, rays, _, _ = _step(scene, cfg, st_z, rays,
                                        rng.fold_in(dk, 1), uu, vv, d,
                                        pre_hit=hit0, force_mode="specular",
                                        count_primary=False,
                                        suppress_shared=True)
            if d == 0 and si == 0:
                alb, nrm = a_, n_
            split += [s_d, s_s]
        states = split
    radiance = None
    for si, st in enumerate(states):
        cur, rays = _trace_span(scene, cfg, st, rays, krest, n_split,
                                cfg.max_bounces + 1, si=si)
        radiance = (cur.radiance if radiance is None
                    else radiance + cur.radiance)
    return TraceResult(radiance, alb, nrm, rays)


def _compact_state(state: RayState, cap: int):
    """Survivors to a dense prefix (a stable argsort of ~alive), the first
    `cap` lanes kept. Returns (the small state with zero radiance,
    src)."""
    order = torch.argsort((~state.alive).to(torch.uint8), stable=True)
    src = order[:cap]
    small = RayState(
        org=state.org[src],
        dirn=state.dirn[src],
        throughput=state.throughput[src],
        radiance=torch.zeros((cap, 3), dtype=torch.float32,
                             device=state.org.device),
        emission_ok=state.emission_ok[src],
        alive=state.alive[src],
    )
    return small, src


def _compact_and_finish(scene, cfg: IntegratorConfig, state: RayState,
                        krest, cap: int, d0: int, d1: int):
    """Compact to `cap` lanes, run depths [d0, d1) at that width and add
    the small buffer's radiance back at its source lanes. Returns
    (radiance, the tail's rays)."""
    small, src = _compact_state(state, cap)
    rays = torch.zeros((), dtype=torch.int64, device=state.org.device)
    small, rays = _trace_span(scene, cfg, small, rays, krest, d0, d1)
    return state.radiance.index_add(0, src, small.radiance), rays


def _morton_key(p, d, box=None):
    """(R,) coherence key in int64 holding a uint32: [31] mesh-root-box
    miss bit (with `box`) | [27:30] direction octant | [0:27] origin
    Morton code over the batch's bounding box."""
    p = p.detach()
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


def _reservoir_compact(state: RayState, cap: int, key, *,
                       depth: int | None = None):
    """Shrink the wavefront to `cap` lanes with no host sync and no bias:
    if S = #alive exceeds cap, a uniform-random subset of cap lanes
    survives and each survivor's throughput is reweighted by S/cap. Kept
    lanes are packed to the front in Morton/octant order (stable sorts, so
    equal keys keep lane order and the next depth's draws line up with the
    reference). Returns (small_state, src). depth: the depth the small
    state enters, under which a counted pass adds S to its survivors."""
    alive = state.alive
    r = alive.shape[0]
    s_cnt = torch.sum(alive)
    if depth is not None:
        profiling.count(depth, "survivors", s_cnt)
    u = _uniform(key, r, state.org)
    order = torch.argsort(torch.where(alive, u, 2.0), stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(r, device=order.device)
    keep = alive & (rank < cap)
    w = torch.where(s_cnt > cap, vec.div(s_cnt.to(torch.float32), cap),
                    1.0).detach()
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
        with profiling.span("pt.compact"):
            small, src = _reservoir_compact(cur, cap, ck, depth=d)
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
    state, rays, alb, nrm, krest = _trace_prefix(
        scene, cfg, org, dirn, key, strat_idx, n_strat, schedule[0][0])
    radiance, tail_rays = _static_tail(scene, cfg, state, krest, schedule,
                                       cfg.max_bounces + 1)
    return TraceResult(radiance, alb, nrm, rays + tail_rays)


def trace_compacted(scene: SceneData, cfg: IntegratorConfig, org, dirn,
                    key, strat_idx=None, n_strat: int = 1,
                    compact_at: int | None = None,
                    min_cap: int = 1 << 12) -> TraceResult:
    """trace() with one host-synced compaction point: depths up to
    `compact_at` (default rr_start_depth + 1) run at full width; the
    survivors are then compacted on the device into the smallest
    power-of-two buffer (at least min_cap) and the remaining depths run at
    that width. Its one host sync reads the survivor count. Falls back to
    trace() where the JAX package's does: no Russian roulette, a split
    specular mode, or nothing culled."""
    if cfg.specular_mode != SPECULAR_MODE_NAIVE or not cfg.russian_roulette:
        return trace(scene, cfg, org, dirn, key, strat_idx, n_strat)
    d_stop = compact_at if compact_at is not None else cfg.rr_start_depth + 1
    d_stop = min(d_stop, cfg.max_bounces + 1)
    state, rays, alb, nrm, krest = _trace_prefix(
        scene, cfg, org, dirn, key, strat_idx, n_strat, d_stop)
    if d_stop > cfg.max_bounces:
        return TraceResult(state.radiance, alb, nrm, rays)
    r = org.shape[0]
    n_alive = int(state.alive.sum())  # the one host sync
    cap = max(min_cap, 1 << max(0, n_alive - 1).bit_length())
    if cap >= r:  # nothing culled: finish at full width
        state, rays = _trace_span(scene, cfg, state, rays, krest, d_stop,
                                  cfg.max_bounces + 1)
        return TraceResult(state.radiance, alb, nrm, rays)
    radiance, tail_rays = _compact_and_finish(
        scene, cfg, state, krest, cap, d_stop, cfg.max_bounces + 1)
    return TraceResult(radiance, alb, nrm, rays + tail_rays)
