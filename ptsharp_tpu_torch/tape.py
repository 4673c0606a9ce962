"""Analytic tape backward for the bounce chain: an autograd.Function over
the trace.

Counterpart of ptsharp_tpu/tape.py. With geometry and every discrete
decision detached, the radiance estimator is a product chain in the
differentiable scene parameters:

  L = sum_d [ miss_d  * T_d . env
            + emit_d  * T_d . c_d * e_d
            + nee_d   * (T_d . B_d) . C[lm_d] * e[lm_d] * kappa_d ]
  T_{d+1} = alive_d ? T_d . B_d * rr_d : T_d,
  B_d     = spec_d ? 1 + (c_d - 1) * tint : c_d        (naive mode: w = 1)

so the backward needs only a small per-depth tape (integrator.TapeRecord:
throughput, material id, uv, light material, kappa, RR scale, flag bits)
and a reverse loop over the depths that rebuilds those pointwise terms and
takes their local vector-Jacobian product: no traversal, no RNG, no sort,
no shading re-run. Per-lane cotangents are summed into the (M,) and (M, 3)
tables by kernels/table_sum.py (on a card one launch of
csrc/table_sum.cu, elsewhere index_add_), as the atlas fetches' are summed
into the texels (textures.TextureAtlas.sample).

Parameter contract (DiffParams): material color, emittance and tint
(lights share the table; a mesh light's NEE term reads the row of the
triangle it sampled, lm), the environment color and the texture atlas's
texels. Parameters whose gradient runs only through sampled directions
(gloss, index of refraction) are dropped, as in the JAX package; use
autograd through integrator.trace where those matter.

Scope: the naive specular mode with a single-light NEE mode ("random",
"power"); trace_tape_radiance falls back to autograd through trace()
elsewhere (tape_supported).
"""

from __future__ import annotations

from dataclasses import replace
from typing import NamedTuple

import torch

from ptsharp_tpu_torch.integrator import (
    LIGHT_MODE_ALL, SPECULAR_MODE_NAIVE, TAPE_ALIVE, TAPE_EMIT,
    TAPE_MISS_ENV, TAPE_NEE, TAPE_SPEC, TAPE_TEX, IntegratorConfig,
    TapeRecord, _trace_prefix, trace,
)
from ptsharp_tpu_torch.kernels import table_sum
from ptsharp_tpu_torch.scene import SceneData
from ptsharp_tpu_torch.textures import TextureAtlas


class DiffParams(NamedTuple):
    """The differentiable scene-parameter leaves the tape backward covers."""

    color: torch.Tensor      # (M, 3) material colors (also light colors)
    emittance: torch.Tensor  # (M,)
    tint: torch.Tensor       # (M,)
    env_color: torch.Tensor  # (3,)
    tex_data: torch.Tensor   # (K, H, W, 3) texture atlas

    @staticmethod
    def of(scene: SceneData) -> "DiffParams":
        return DiffParams(scene.materials.color, scene.materials.emittance,
                          scene.materials.tint, scene.env_color,
                          scene.textures.data)


def plug(scene: SceneData, p: DiffParams) -> SceneData:
    """The scene with its DiffParams leaves replaced by `p`."""
    return replace(
        scene,
        materials=scene.materials._replace(
            color=p.color, emittance=p.emittance, tint=p.tint),
        env_color=p.env_color,
        textures=scene.textures._replace(data=p.tex_data))


def tape_supported(scene: SceneData, cfg: IntegratorConfig) -> bool:
    return (cfg.specular_mode == SPECULAR_MODE_NAIVE
            and cfg.light_mode != LIGHT_MODE_ALL)


def _trace_tape(scene: SceneData, cfg: IntegratorConfig, org, dirn, key,
                strat_idx=None, n_strat: int = 1):
    """trace() collecting one TapeRecord a depth: the same _step and the
    same key chain, so the radiance is bit-equal to trace()'s. Returns
    (radiance, (albedo, normal, rays), tape)."""
    tape = []
    state, rays, alb, nrm, _ = _trace_prefix(
        scene, cfg, org, dirn, key, strat_idx, n_strat, cfg.max_bounces + 1,
        tape=tape)
    return state.radiance, (alb, nrm, rays), tape


def _row(ids, m: int):
    """Table rows of per-lane ids, clamped as MaterialTable.gather does."""
    return torch.clamp(ids, 0, m - 1).long()


def _rebuild_terms_lanes(scene: SceneData, lanes, T, tp: TapeRecord):
    """One depth's radiance terms and throughput update (the module
    docstring's equations; the semantics of integrator._step) as a
    pointwise function of the gathered per-lane parameter values, the
    environment color, the atlas and the entering throughput T."""
    cm, e, tint, cl, el, envc, tex = lanes
    atlas = TextureAtlas(data=tex, sizes=scene.textures.sizes)
    c = cm
    if scene.textures.nontrivial:
        tex_ids = scene.materials.texture
        tid = tex_ids[_row(tp.mat_id, tex_ids.shape[0])]
        c_tex = atlas.sample(tid, tp.uv[:, 0], tp.uv[:, 1])
        c = torch.where(((tp.flags & TAPE_TEX) != 0)[:, None], c_tex, c)
    is_spec = ((tp.flags & TAPE_SPEC) != 0)[:, None]
    one = torch.ones_like(c)
    B = torch.where(is_spec, one + (c - one) * tint[:, None], c)
    if scene.env_texture >= 0:
        etid = torch.full(tp.mat_id.shape, scene.env_texture,
                          dtype=torch.int32, device=c.device)
        env = atlas.sample(etid, tp.uv[:, 0], tp.uv[:, 1])
    else:
        env = torch.broadcast_to(envc, c.shape)
    D = cl * (el * tp.kappa)[:, None]
    miss = ((tp.flags & TAPE_MISS_ENV) != 0)[:, None]
    emit = ((tp.flags & TAPE_EMIT) != 0)[:, None]
    nee = ((tp.flags & TAPE_NEE) != 0)[:, None]
    alive = ((tp.flags & TAPE_ALIVE) != 0)[:, None]
    terms = (torch.where(miss, T * env, 0.0)
             + torch.where(emit, T * c * e[:, None], 0.0)
             + torch.where(nee, (T * B) * D, 0.0))
    t_next = torch.where(alive, T * B * tp.rr[:, None], T)
    return terms, t_next


def _tape_backward(scene: SceneData, p: DiffParams, tape, g) -> DiffParams:
    """Reverse loop over the tape: the DiffParams cotangents of radiance
    cotangent g, carrying the throughput cotangent up the chain."""
    m = p.color.shape[0]
    acc = DiffParams(*(torch.zeros_like(x) for x in p))
    ybar = torch.zeros_like(g)
    for tp in reversed(tape):
        mid = _row(tp.mat_id, m)
        lm = _row(tp.lm, m)
        vals = (p.color[mid], p.emittance[mid], p.tint[mid], p.color[lm],
                p.emittance[lm], p.env_color, p.tex_data, tp.t_in)
        with torch.enable_grad():
            wrt = [x.detach().requires_grad_() for x in vals]
            terms, t_next = _rebuild_terms_lanes(scene, wrt[:7], wrt[7], tp)
            grads = torch.autograd.grad((terms, t_next), wrt, (g, ybar),
                                        allow_unused=True)
        dcm, de, dtint, dcl, del_, denv, dtex, ybar = (
            torch.zeros_like(x) if d is None else d
            for d, x in zip(grads, wrt))
        at_mid = table_sum.table_sum(mid, torch.cat(
            [dcm, de[:, None], dtint[:, None]], dim=1), m)
        at_lm = table_sum.table_sum(lm, torch.cat([dcl, del_[:, None]],
                                                  dim=1), m)
        acc.color.add_(at_mid[:, :3] + at_lm[:, :3])
        acc.emittance.add_(at_mid[:, 3] + at_lm[:, 3])
        acc.tint.add_(at_mid[:, 4])
        acc.env_color.add_(denv)
        acc.tex_data.add_(dtex)
    return acc


class TapeResult(NamedTuple):
    radiance: torch.Tensor
    albedo: torch.Tensor
    normal: torch.Tensor
    rays_traced: torch.Tensor


class _TapeRadiance(torch.autograd.Function):
    """Radiance of trace() with the tape backward. Inputs: the scene with
    its DiffParams leaves detached, the config, rays and key, then the
    leaves; albedo, normal and the ray count carry no gradient (the JAX
    custom_vjp drops their cotangents)."""

    @staticmethod
    def forward(ctx, skel, cfg, org, dirn, key, *leaves):
        radiance, (alb, nrm, rays), tape = _trace_tape(
            plug(skel, DiffParams(*leaves)), cfg, org, dirn, key)
        ctx.skel, ctx.tape = skel, tape
        ctx.save_for_backward(*leaves)
        ctx.mark_non_differentiable(alb, nrm, rays)
        return radiance, alb, nrm, rays

    @staticmethod
    def backward(ctx, g, *_aux):
        p = DiffParams(*ctx.saved_tensors)
        grads = _tape_backward(plug(ctx.skel, p), p, ctx.tape, g)
        return (None,) * 5 + tuple(grads)


def trace_tape_radiance(scene: SceneData, cfg: IntegratorConfig, org, dirn,
                        key) -> TapeResult:
    """trace() with the analytic tape backward: the same radiance (bit for
    bit), gradients with respect to the scene's DiffParams leaves by the
    tape. Falls back to autograd through trace() where tape_supported is
    false."""
    if not tape_supported(scene, cfg):
        return TapeResult(*trace(scene, cfg, org, dirn, key))
    p = DiffParams.of(scene)
    skel = plug(scene, DiffParams(*(x.detach() for x in p)))
    return TapeResult(*_TapeRadiance.apply(skel, cfg, org, dirn, key, *p))
