"""Scene-wide closest-hit, occlusion and shading data over ray wavefronts.

Counterpart of ptsharp_tpu/intersect.py for the port's slice, in one of
two tiers, chosen per scene at build time (`scene.use_tlas`), as there:

  * per primitive type the whole batch is intersected in one vectorized
    pass (planes, spheres, cubes, cylinders, in that order), then the
    meshes, bounded by the best t found so far, by `scene.intersector`
    (kernels/traverse.py):
      "pallas"   flat (`scene.p_flat`): the world-space table in one
                 launch; else per instance, object-space rays over the
                 instance's mesh table; the ordered walk where
                 `scene.p_ordered`, the preorder walk otherwise;
      "wide"     per instance, object-space rays through the K-wide walk
                 over w_rows (closest_hit_wide_rows);
      "walk"     per instance, the binary walk over u_rows
                 (closest_hit_binary);
      "cluster"  per instance, the cluster cull (accel/cluster.py), whose
                 unresolved rays take the binary walk.
    Shadow rays of the last three go through the K-wide any-hit walk over
    w_rows, per instance (any_hit_wide_rows);
  * `scene.use_tlas` (instancing, or many analytic primitives): the planes,
    then every other object in one walk of the TLAS that re-enters each
    instance's BLAS (`traverse_scene`: closest_hit_tlas, any_hit_tlas
    for shadow rays; binary rows for "walk", K-wide rows else).
In both tiers the marched shapes come last, each clipped to its box and
bounded by the best t so far (the shadow cut for occlusion): SDF trees
sphere traced (geometry/sdf.py), volumes (geometry/volume.py) and
heightfields (geometry/function.py), in geometry/march.py's lockstep loop,
which counts their steps under "closest" and "shadow".
Object-space rays are not normalised: t is parametric in the world ray.
Hit records follow Hit.Info (Hit.cs:26-55): the shading normal, on a
mapped scene's triangles after its normal and bump maps, is flipped
toward the ray and `inside` set on a flip, never for SDF and volume
hits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ptsharp_tpu_torch.accel import cluster
from ptsharp_tpu_torch.accel import traverse as walks
from ptsharp_tpu_torch.core import vec
from ptsharp_tpu_torch.geometry import function as fn_mod
from ptsharp_tpu_torch.geometry import primitives
from ptsharp_tpu_torch.geometry import sdf as sdf_mod
from ptsharp_tpu_torch.geometry import volume as vol_mod
from ptsharp_tpu_torch.kernels import traverse
from ptsharp_tpu_torch.scene import (
    PT_CUBE,
    PT_CYLINDER,
    PT_FUNCTION,
    PT_NONE,
    PT_PLANE,
    PT_SDF,
    PT_SPHERE,
    PT_TRIANGLE,
    PT_VOLUME,
    SceneData,
)

INF = vec.INF


class Hit(NamedTuple):
    """Per-ray closest hit. pindex is the within-type primitive index (the
    scene triangle slot for meshes); inst is the mesh instance (-1 else)."""

    t: torch.Tensor
    ptype: torch.Tensor
    pindex: torch.Tensor
    inst: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor


class HitInfo(NamedTuple):
    """Shading data for hit rays (garbage where ptype == PT_NONE)."""

    position: torch.Tensor
    normal: torch.Tensor  # flipped toward the ray
    inside: torch.Tensor
    mat_id: torch.Tensor
    tex_u: torch.Tensor
    tex_v: torch.Tensor


def _xform_point(aff, p):
    """aff (..., 3, 4) applied to points p (..., 3)."""
    return vec.affine(aff, p)


def _xform_dir(aff, d):
    return vec.linear(aff, d)


def _xform_normal(aff_inv, n):
    """Normal transform: n_world ~ aff_inv_lin^T n_obj."""
    return vec.normalize(vec.linear(aff_inv[..., :3].transpose(-1, -2), n))


def _local(inv, xform: bool, o1, d1):
    if not xform:
        return o1, d1
    return _xform_point(inv[None], o1), _xform_dir(inv[None], d1)


def _instance_rays(scene: SceneData, i: int, org, dirn):
    """Rays of instance i's object space, unnormalised."""
    inv = scene.inst_inv[i][None]
    return (_xform_point(inv, org).contiguous(),
            _xform_dir(inv, dirn).contiguous())


def scene_tlas(scene: SceneData) -> walks.TlasTables:
    """The tables of `scene` that its TLAS walk reads: binary u_rows for
    "walk", else the K-wide w_rows (ptsharp_tpu/intersect.py:178-184)."""
    wide = scene.intersector != "walk"
    return walks.TlasTables(
        rows=scene.w_rows if wide else scene.u_rows, leaf=scene.leaf_rows,
        inst_inv=scene.inst_inv,
        inst_range=scene.w_inst_range if wide else scene.u_inst_range,
        sphere_center=scene.sphere_center, sphere_radius=scene.sphere_radius,
        sphere_inv=scene.sphere_inv, cube_min=scene.cube_min,
        cube_max=scene.cube_max, cube_inv=scene.cube_inv,
        cyl_radius=scene.cyl_radius, cyl_z0=scene.cyl_z0,
        cyl_z1=scene.cyl_z1, cyl_inv=scene.cyl_inv,
        tlas_end=scene.w_tlas_end if wide else scene.tlas_end,
        leaf_size=scene.max_leaf, k=scene.wide_k if wide else 0,
        sphere_xform=scene.sphere_xform, cube_xform=scene.cube_xform,
        cyl_xform=scene.cyl_xform)


def traverse_scene(scene: SceneData, org, dirn, t_max):
    """One walk of the scene's TLAS, whose instance leaves re-enter each
    instance's BLAS with object-space rays (ptsharp_tpu/intersect.py
    traverse_scene): (t, kind, index, inst, u, v), kind PT_NONE and t INF
    where nothing beat t_max ((R,)). Detached: traversal is discrete."""
    return traverse.closest_hit_tlas(
        scene_tlas(scene), org.detach().contiguous(),
        dirn.detach().contiguous(),
        _as_rays(t_max, org.shape[0], org).detach().contiguous())


def _as_rays(x, r, like):
    return torch.broadcast_to(
        torch.as_tensor(x, dtype=torch.float32, device=like.device), (r,))


def _box(lo, hi, device):
    return (torch.tensor(lo, dtype=torch.float32, device=device),
            torch.tensor(hi, dtype=torch.float32, device=device))


def marched(scene: SceneData, org, dirn, bound, tag: str):
    """Each marched shape's t (INF on a miss) with its type code and index,
    in the JAX package's order (SDFs, volumes, heightfields;
    ptsharp_tpu/intersect.py:553-578): each clipped to its box and its
    march bounded at `bound()`, called before each shape (the best t so
    far, or the shadow cut), so a shape takes the bound left by those
    before it. A generator: the caller folds each t in before the next
    shape starts."""
    dev = org.device
    for i, (sdf_obj, _mid, lo, hi) in enumerate(scene.sdf_objects):
        te, tx = primitives.box_entry_exit(org, dirn, *_box(lo, hi, dev))
        yield sdf_mod.sphere_trace(sdf_obj, org, dirn, te,
                                   torch.minimum(tx, bound()),
                                   tag=tag), PT_SDF, i
    for i, vol in enumerate(scene.volumes):
        te, tx = primitives.box_entry_exit(org, dirn, *vol.box(dev))
        yield vol_mod.intersect(scene.volume_data[i], vol, org, dirn, te,
                                torch.minimum(tx, bound()),
                                tag=tag), PT_VOLUME, i
    for i, (hf, _mid) in enumerate(scene.functions):
        te, tx = primitives.box_entry_exit(
            org, dirn, *_box(np.asarray(hf.bmin, np.float32),
                             np.asarray(hf.bmax, np.float32), dev))
        yield fn_mod.intersect(hf, org, dirn, te, torch.minimum(tx, bound()),
                               tag=tag), PT_FUNCTION, i


def closest_hit(scene: SceneData, org, dirn, t_max=None) -> Hit:
    """org/dirn (R, 3), unit directions. Returns the closest hit per ray;
    t_max (scalar or (R,)) bounds the search. Detached where the JAX
    package detaches: t_max at the entry (ptsharp_tpu/intersect.py:356),
    the rays where they enter a mesh walk (its traversal entry points,
    :168-170, and the pallas wrappers); an analytic primitive's t stays
    differentiable in org and dirn, as there."""
    r = org.shape[0]
    dev = org.device
    if t_max is None:
        best_t = torch.full((r,), INF, dtype=torch.float32, device=dev)
    else:
        best_t = _as_rays(t_max, r, org).detach().clone()
    best_type = torch.zeros(r, dtype=torch.int32, device=dev)
    best_idx = torch.full((r,), -1, dtype=torch.int32, device=dev)
    best_inst = torch.full((r,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(r, dtype=torch.float32, device=dev)
    best_v = torch.zeros(r, dtype=torch.float32, device=dev)

    def take(t_new, ptype, pidx, inst=-1, u=0.0, v=0.0):
        nonlocal best_t, best_type, best_idx, best_inst, best_u, best_v
        better = t_new < best_t
        best_t = torch.where(better, t_new, best_t)
        best_type = torch.where(better, ptype, best_type)
        best_idx = torch.where(better, pidx, best_idx)
        best_inst = torch.where(better, inst, best_inst)
        best_u = torch.where(better, u, best_u)
        best_v = torch.where(better, v, best_v)

    def take_min(ts, ptype):
        # argmin: the first of equal minima, as jnp.argmin picks it
        idx = torch.argmin(ts, dim=1)
        take(torch.amin(ts, dim=1), ptype, idx.to(torch.int32))

    def finish():
        # the marched shapes, each bounded by the best t so far
        for t, ptype, i in marched(scene, org, dirn, lambda: best_t,
                                   "closest"):
            take(t, ptype, i)
        bt = best_t
        if t_max is not None:
            bt = torch.where(best_type == PT_NONE, torch.full_like(bt, INF),
                             bt)
        return Hit(bt, best_type, best_idx, best_inst, best_u, best_v)

    o1 = org[:, None, :]
    d1 = dirn[:, None, :]
    if scene.plane_point.shape[0] > 0:
        take_min(primitives.intersect_planes(o1, d1, scene.plane_point,
                                             scene.plane_normal), PT_PLANE)

    if scene.use_tlas:
        # planes are never in the TLAS; everything else but the marched
        # shapes is
        t, k, i, binst, u, v = traverse_scene(scene, org, dirn, best_t)
        take(t, k, i, inst=binst, u=u, v=v)
        return finish()
    if scene.sphere_center.shape[0] > 0:
        o, d = _local(scene.sphere_inv, scene.sphere_xform, o1, d1)
        take_min(primitives.intersect_spheres(o, d, scene.sphere_center,
                                              scene.sphere_radius), PT_SPHERE)
    if scene.cube_min.shape[0] > 0:
        o, d = _local(scene.cube_inv, scene.cube_xform, o1, d1)
        take_min(primitives.intersect_cubes(o, d, scene.cube_min,
                                            scene.cube_max), PT_CUBE)
    if scene.cyl_radius.shape[0] > 0:
        o, d = _local(scene.cyl_inv, scene.cyl_xform, o1, d1)
        take_min(primitives.intersect_cylinders(o, d, scene.cyl_radius,
                                                scene.cyl_z0, scene.cyl_z1),
                 PT_CYLINDER)
    # the walks take raw pointers: they see detached rays and bounds
    org, dirn = org.detach(), dirn.detach()
    if scene.has_meshes and scene.intersector == "pallas":
        walk = (traverse.closest_hit if scene.p_ordered
                else traverse.closest_hit_preorder)
        if scene.p_flat:
            # one world-space launch over every instance, bounded by the
            # best analytic t; slot maps recover scene triangle and instance
            t, kslot, u, v = walk(
                scene.p_fat, org.contiguous(), dirn.contiguous(),
                best_t.detach().contiguous(), scene.p_inst_base[0],
                scene.p_inst_end[0], scene.max_leaf, scene.wide_k)
            ks = torch.clamp(kslot, 0, scene.p_slot_tri.shape[0] - 1).long()
            take(t, PT_TRIANGLE, scene.p_slot_tri[ks],
                 inst=scene.p_slot_inst[ks], u=u, v=v)
        else:
            # per instance, object-space rays over its mesh's table,
            # bounded by the best t so far; kernel slots are scene slots
            for i in range(scene.inst_inv.shape[0]):
                o, d = _instance_rays(scene, i, org, dirn)
                t, slot, u, v = walk(
                    scene.p_fat, o, d, best_t.detach().contiguous(),
                    scene.p_inst_base[i], scene.p_inst_end[i],
                    scene.max_leaf, scene.wide_k)
                take(t, PT_TRIANGLE, slot, inst=i, u=u, v=v)
    elif scene.has_meshes:
        # per instance, object-space rays; slots index the scene's slot
        # arrays directly
        tpc = (scene.cluster_rows.shape[1] // 9
               if scene.cluster_rows.shape[0] else 0)
        for i in range(scene.inst_inv.shape[0]):
            o, d = _instance_rays(scene, i, org, dirn)
            if scene.intersector == "cluster" and tpc:
                t, slot, u, v = cluster.intersect_clustered(
                    (scene.cluster_bmin, scene.cluster_bmax,
                     scene.cluster_rows, tpc, scene.inst_cluster_base[i],
                     scene.inst_cluster_end[i], scene.u_rows,
                     scene.leaf_rows, scene.u_inst_base[i],
                     scene.u_inst_end[i], scene.max_leaf),
                    o, d, best_t.detach())
            elif scene.intersector == "walk":
                t, slot, u, v = traverse.closest_hit_binary(
                    scene.u_rows, scene.leaf_rows, o, d,
                    best_t.detach().contiguous(), scene.u_inst_base[i],
                    scene.u_inst_end[i], scene.max_leaf)
            else:
                t, slot, u, v = traverse.closest_hit_wide_rows(
                    scene.w_rows, scene.leaf_rows, o, d,
                    best_t.detach().contiguous(),
                    scene.w_inst_base[i], scene.w_inst_end[i],
                    scene.max_leaf, scene.wide_k)
            take(t, PT_TRIANGLE, slot, inst=i, u=u, v=v)
    return finish()


def occlusion_query(scene: SceneData, org, dirn, t_cut) -> torch.Tensor:
    """True where any surface intersects the ray at t in (eps, t_cut);
    lanes with t_cut <= 0 are never occluded. Mesh instances go through
    the any-hit kernel of the scene's walk order over the fat table
    ("pallas", once, or per instance where not flat), else, per instance,
    through the K-wide any-hit walk over w_rows.
    ptsharp_tpu/intersect.py:722-728 runs the K-wide closest-hit bounded by
    t_cut there and tests t < INF: the same boolean wherever t_cut <= INF,
    which every cut the integrator passes is. A `use_tlas` scene's objects
    other than planes go through the TLAS any-hit walk, the boolean of
    the bounded TLAS closest-hit's kind != PT_NONE (:624-626). The marched
    shapes come last, each marched up to the cut (:730-752). Discrete, so
    every input is detached (ptsharp_tpu/intersect.py:602-606)."""
    org, dirn = org.detach(), dirn.detach()
    r = org.shape[0]
    tc = _as_rays(t_cut, r, org).detach()
    occ = torch.zeros(r, dtype=torch.bool, device=org.device)
    o1 = org[:, None, :]
    d1 = dirn[:, None, :]

    def any_below(ts):
        return torch.any(ts < tc[:, None], dim=1)

    if scene.plane_point.shape[0] > 0:
        occ = occ | any_below(primitives.intersect_planes(
            o1, d1, scene.plane_point, scene.plane_normal))

    def cut():
        # already-occluded lanes carry a -INF bound and test nothing
        return torch.where(occ, torch.full_like(tc, -INF), tc).contiguous()

    def finish():
        # the marched shapes, each bounded by the cut left by those before
        nonlocal occ
        for t, _ptype, _i in marched(scene, org, dirn, cut, "shadow"):
            occ = occ | (t < tc)
        return occ

    if scene.use_tlas:
        occ = occ | traverse.any_hit_tlas(scene_tlas(scene), org.contiguous(),
                                          dirn.contiguous(), cut())
        return finish()
    if scene.sphere_center.shape[0] > 0:
        o, d = _local(scene.sphere_inv, scene.sphere_xform, o1, d1)
        occ = occ | any_below(primitives.intersect_spheres(
            o, d, scene.sphere_center, scene.sphere_radius))
    if scene.cube_min.shape[0] > 0:
        o, d = _local(scene.cube_inv, scene.cube_xform, o1, d1)
        occ = occ | any_below(primitives.intersect_cubes(
            o, d, scene.cube_min, scene.cube_max))
    if scene.cyl_radius.shape[0] > 0:
        o, d = _local(scene.cyl_inv, scene.cyl_xform, o1, d1)
        occ = occ | any_below(primitives.intersect_cylinders(
            o, d, scene.cyl_radius, scene.cyl_z0, scene.cyl_z1))
    if scene.has_meshes and scene.intersector == "pallas":
        walk = (traverse.any_hit if scene.p_ordered
                else traverse.any_hit_preorder)
        if scene.p_flat:
            occ = occ | walk(
                scene.p_fat, org.contiguous(), dirn.contiguous(), cut(),
                scene.p_inst_base[0], scene.p_inst_end[0], scene.max_leaf,
                scene.wide_k)
        else:
            for i in range(scene.inst_inv.shape[0]):
                o, d = _instance_rays(scene, i, org, dirn)
                occ = occ | walk(scene.p_fat, o, d, cut(),
                                 scene.p_inst_base[i], scene.p_inst_end[i],
                                 scene.max_leaf, scene.wide_k)
    elif scene.has_meshes:
        for i in range(scene.inst_inv.shape[0]):
            o, d = _instance_rays(scene, i, org, dirn)
            occ = occ | traverse.any_hit_wide_rows(
                scene.w_rows, scene.leaf_rows, o, d, cut(),
                scene.w_inst_base[i], scene.w_inst_end[i], scene.max_leaf,
                scene.wide_k)
    return finish()


def light_hit_t(scene: SceneData, org, dirn, lidx) -> torch.Tensor:
    """Analytic hit distance of each ray against ITS sampled light's
    primitive (lidx (R,) per-ray light index); INF where it misses."""
    r = org.shape[0]
    t_light = torch.full((r,), INF, dtype=torch.float32, device=org.device)
    pi = torch.clamp(scene.light_pindex[lidx], min=0).long()
    lt = scene.light_ptype[lidx]

    def local(inv, xform, pic):
        if not xform:
            return org, dirn
        m = inv[pic]
        return _xform_point(m, org), _xform_dir(m, dirn)

    if PT_SPHERE in scene.light_types:
        pic = torch.clamp(pi, 0, scene.sphere_center.shape[0] - 1)
        o, d = local(scene.sphere_inv, scene.sphere_xform, pic)
        t = walks.sphere_t(o, d, scene.sphere_center[pic],
                           scene.sphere_radius[pic])
        t_light = torch.where(lt == PT_SPHERE, t, t_light)
    if PT_CUBE in scene.light_types:
        pic = torch.clamp(pi, 0, scene.cube_min.shape[0] - 1)
        o, d = local(scene.cube_inv, scene.cube_xform, pic)
        t = walks.cube_t(o, d, scene.cube_min[pic], scene.cube_max[pic])
        t_light = torch.where(lt == PT_CUBE, t, t_light)
    if PT_CYLINDER in scene.light_types:
        pic = torch.clamp(pi, 0, scene.cyl_radius.shape[0] - 1)
        o, d = local(scene.cyl_inv, scene.cyl_xform, pic)
        t = walks.cyl_t(o, d, scene.cyl_radius[pic], scene.cyl_z0[pic],
                        scene.cyl_z1[pic])
        t_light = torch.where(lt == PT_CYLINDER, t, t_light)
    return t_light


def _surface_maps(scene: SceneData, i, tm, n_obj, uv):
    """The object-space shading normal of triangle slots i under their
    materials' normal map (tangent-space RGB) and then bump map (a height
    gradient along tangent and bitangent), each where the material has
    one (Triangle.cs:142-186). The tangent frame comes from the slot's
    object-space edges and uv deltas; a zero uv delta gives a zero axis,
    as vec.normalize leaves it."""
    mat = scene.materials.gather(tm)
    duv1 = scene.tri_uv1[i] - scene.tri_uv0[i]
    duv2 = scene.tri_uv2[i] - scene.tri_uv0[i]
    e1 = scene.tri_e1[i]
    e2 = scene.tri_e2[i]
    tangent = vec.normalize(e1 * duv2[..., 1:2] - e2 * duv1[..., 1:2])
    bitangent = vec.normalize(e2 * duv1[..., 0:1] - e1 * duv2[..., 0:1])
    ns = scene.textures.normal_sample(mat.normal_texture, uv[..., 0],
                                      uv[..., 1])
    tbn_n = vec.normalize(vec.cross(tangent, bitangent))
    mapped = vec.normalize(tangent * ns[..., 0:1] + bitangent * ns[..., 1:2]
                           + tbn_n * ns[..., 2:3])
    n_obj = torch.where((mat.normal_texture >= 0)[..., None], mapped, n_obj)
    bump = scene.textures.bump_sample(mat.bump_texture, uv[..., 0],
                                      uv[..., 1])
    k = mat.bump_multiplier[..., None]
    bumped = vec.normalize(n_obj + tangent * (bump[..., 0:1] * k)
                           + bitangent * (bump[..., 1:2] * k))
    return torch.where((mat.bump_texture >= 0)[..., None], bumped, n_obj)


def hit_info(scene: SceneData, org, dirn, hit: Hit) -> HitInfo:
    """Shading data for the winning primitive of each ray: every present
    type's info is computed masked and selected."""
    r = org.shape[0]
    dev = org.device
    pos = org + dirn * hit.t[..., None]
    normal = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    normal[:, 1] = 1.0  # default up-normal keeps miss lanes finite
    mat_id = torch.zeros(r, dtype=torch.int32, device=dev)
    tex_u = torch.zeros(r, dtype=torch.float32, device=dev)
    tex_v = torch.zeros(r, dtype=torch.float32, device=dev)

    def sel(mask, new_n, new_m, new_u=None, new_v=None):
        nonlocal normal, mat_id, tex_u, tex_v
        normal = torch.where(mask[:, None], new_n, normal)
        mat_id = torch.where(mask, new_m, mat_id)
        if new_u is not None:
            tex_u = torch.where(mask, new_u, tex_u)
            tex_v = torch.where(mask, new_v, tex_v)

    idx = torch.clamp(hit.pindex, min=0).long()

    if scene.sphere_center.shape[0] > 0:
        i = torch.clamp(idx, max=scene.sphere_center.shape[0] - 1)
        c = scene.sphere_center[i]
        rad = scene.sphere_radius[i]
        if scene.sphere_xform:
            inv = scene.sphere_inv[i]
            p_obj = _xform_point(inv, pos)
            n = _xform_normal(inv, vec.normalize(p_obj - c))
            u, v = primitives.sphere_uv(p_obj, c, rad)
        else:
            n = primitives.sphere_normal(pos, c)
            u, v = primitives.sphere_uv(pos, c, rad)
        sel(hit.ptype == PT_SPHERE, n, scene.sphere_mat[i], u, v)

    if scene.plane_point.shape[0] > 0:
        i = torch.clamp(idx, max=scene.plane_point.shape[0] - 1)
        sel(hit.ptype == PT_PLANE, scene.plane_normal[i], scene.plane_mat[i])

    if scene.cube_min.shape[0] > 0:
        i = torch.clamp(idx, max=scene.cube_min.shape[0] - 1)
        lo = scene.cube_min[i]
        hi = scene.cube_max[i]
        if scene.cube_xform:
            inv = scene.cube_inv[i]
            p_obj = _xform_point(inv, pos)
            n = _xform_normal(inv, primitives.cube_normal(p_obj, lo, hi))
            u, v = primitives.cube_uv(p_obj, lo, hi)
        else:
            n = primitives.cube_normal(pos, lo, hi)
            u, v = primitives.cube_uv(pos, lo, hi)
        sel(hit.ptype == PT_CUBE, n, scene.cube_mat[i], u, v)

    if scene.cyl_radius.shape[0] > 0:
        i = torch.clamp(idx, max=scene.cyl_radius.shape[0] - 1)
        z0 = scene.cyl_z0[i]
        z1 = scene.cyl_z1[i]
        if scene.cyl_xform:
            inv = scene.cyl_inv[i]
            p_obj = _xform_point(inv, pos)
            n = _xform_normal(inv, primitives.cylinder_normal(p_obj, z0, z1))
        else:
            n = primitives.cylinder_normal(pos, z0, z1)
        sel(hit.ptype == PT_CYLINDER, n, scene.cyl_mat[i])

    if scene.has_meshes:
        i = torch.clamp(idx, max=scene.tri_n0.shape[0] - 1)
        n_obj = vec.normalize(primitives.triangle_interpolate(
            scene.tri_n0[i], scene.tri_n1[i], scene.tri_n2[i], hit.u, hit.v))
        uv = primitives.triangle_interpolate(
            scene.tri_uv0[i], scene.tri_uv1[i], scene.tri_uv2[i], hit.u, hit.v)
        inst = torch.clamp(hit.inst, min=0).long()
        over = scene.inst_mat[inst]
        tm = torch.where(over >= 0, over, scene.tri_mat[i])
        if scene.has_surface_maps:
            n_obj = _surface_maps(scene, i, tm, n_obj, uv)
        n = _xform_normal(scene.inst_inv[inst], n_obj)
        sel(hit.ptype == PT_TRIANGLE, n, tm, uv[..., 0], uv[..., 1])

    # the marched shapes' normals and materials, on their hit lanes only
    def on_hits(ptype, i, shade):
        nonlocal normal, mat_id
        lane = torch.nonzero((hit.ptype == ptype)
                             & (hit.pindex == i)).squeeze(1)
        if lane.numel():
            n, m = shade(pos[lane])
            normal = normal.index_put((lane,), n)
            mat_id = mat_id.index_put(
                (lane,), torch.as_tensor(m, dtype=torch.int32,
                                         device=dev).expand(lane.shape))

    for i, (sdf_obj, mid, _lo, _hi) in enumerate(scene.sdf_objects):
        on_hits(PT_SDF, i, lambda p: (sdf_mod.sdf_normal(sdf_obj, p), mid))
    for i, vol in enumerate(scene.volumes):
        data = scene.volume_data[i]
        on_hits(PT_VOLUME, i, lambda p: (vol_mod.normal_at(data, vol, p),
                                         vol_mod.material_at(data, vol, p)))
    for i, (hf, mid) in enumerate(scene.functions):
        on_hits(PT_FUNCTION, i, lambda p: (fn_mod.normal_at(hf, p), mid))

    # flip toward the ray + inside flag (Hit.cs:36-47); SDF and volume
    # hits never report inside (ptsharp_tpu/intersect.py:954-958)
    facing = vec.dot(normal, dirn) > 0.0
    normal = torch.where(facing[:, None], -normal, normal)
    no_inside = (hit.ptype == PT_SDF) | (hit.ptype == PT_VOLUME)
    inside = facing & ~no_inside & (hit.ptype != PT_NONE)
    return HitInfo(position=pos, normal=normal, inside=inside, mat_id=mat_id,
                   tex_u=tex_u, tex_v=tex_v)
