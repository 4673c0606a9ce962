"""Scene-level queries of the port against the JAX package on a mixed
scene: plane, spheres (one a light), a transformed cube and cylinder, and
two meshes (one instanced with a transform) in one flat Pallas table.
The scene is built by the JAX package and carried over with
convert.scene_from_reference, so both sides read the same tables; the
JAX side runs its Pallas kernels in interpret mode.

Tolerances: t allclose at rtol 1e-5, atol 1e-5; hit type equal on every
lane; primitive slot equal except ties (t already agrees, so a different
slot is a tie), at most 0.5% of lanes; shading data within 1e-4 where the
slot agrees; occlusion equal except where the nearest hit lies within
1e-5 * t_cut of t_cut; camera rays within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptsharp_tpu import intersect as jint
from ptsharp_tpu.camera import Camera as JCamera
from ptsharp_tpu.core import transform
from ptsharp_tpu.geometry.mesh import cube_mesh, sphere_mesh
from ptsharp_tpu.materials import (
    Material, diffuse_material, light_material, metallic_material,
)
from ptsharp_tpu.scene import SceneBuilder

from ptsharp_tpu_torch import convert
from ptsharp_tpu_torch import intersect as tint
from ptsharp_tpu_torch.camera import Camera as TCamera

N = 1024


def _scene():
    b = SceneBuilder()
    tid = b.add_texture(np.random.default_rng(0).random((8, 8, 3))
                        .astype(np.float32))
    b.add_plane([0, -1, 0], [0, 1, 0], diffuse_material([0.7, 0.7, 0.7]))
    b.add_sphere([-1.5, 0.2, 0.5], 0.6, Material(color=(0.8, 0.3, 0.2),
                                                  texture=tid))
    b.add_sphere([0.5, 4.0, -1.0], 0.8, light_material([1, 1, 1], 10.0))
    rot = np.asarray(transform.rotate([0, 1, 0], 0.6), np.float32)
    b.add_cube([-0.4, -0.4, -0.4], [0.4, 0.4, 0.4],
               metallic_material([0.9, 0.9, 0.9], 0.1, 0.5),
               transform=rot @ np.asarray(transform.translate([1.0, 0.0, 1.5]),
                                          np.float32))
    b.add_cylinder(0.3, -0.5, 0.5, diffuse_material([0.2, 0.6, 0.3]),
                   transform=np.asarray(transform.translate([-1.0, 0.0, -1.5]),
                                        np.float32))
    b.add_mesh(sphere_mesh([0, 0.4, 0], 1.0, subdivisions=2),
               diffuse_material([0.5, 0.5, 0.5]))
    cube = b.add_mesh(cube_mesh([1.6, -0.3, -0.3], [2.2, 0.3, 0.3]),
                      diffuse_material([0.9, 0.6, 0.2]))
    b.add_mesh_instance(
        cube, transform=np.asarray(transform.translate([-3.4, 0.5, 0.2]),
                                   np.float32) @ np.diag([1.0, 2.0, 1.0, 1.0])
        .astype(np.float32))
    return b.build(leaf_size=8, intersector="pallas", wide_k=8)


@jax.jit
def _reference_queries(sj, org, dirn, t_cut, lidx):
    """All four JAX queries in one program (one compile of the
    interpret-mode kernels instead of one per eager op)."""
    hit = jint.closest_hit(sj, org, dirn)
    return (hit, jint.hit_info(sj, org, dirn, hit),
            jint.occlusion_query(sj, org, dirn, t_cut),
            jint.light_hit_t(sj, org, dirn, lidx))


@pytest.fixture(scope="module")
def ref():
    sj = _scene()
    st = convert.scene_from_reference(*convert.reference_arrays(sj),
                                       device="cpu")
    rng = np.random.default_rng(5)
    org = (rng.uniform(-3, 3, (N, 3)) + [0, 1.0, 0]).astype(np.float32)
    tgt = rng.uniform(-1.5, 1.5, (N, 3)).astype(np.float32)
    d = np.where(rng.random((N, 1)) < 0.7, tgt - org,
                 rng.normal(size=(N, 3))).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_cut = np.where(rng.random(N) < 0.1, -1.0,
                     rng.uniform(0.2, 6.0, N)).astype(np.float32)
    lidx = np.zeros(N, np.int32)
    hit, info, occ, t_light = _reference_queries(
        sj, jnp.asarray(org), jnp.asarray(d), jnp.asarray(t_cut),
        jnp.asarray(lidx))
    return dict(
        st=st, org=torch.from_numpy(org), dirn=torch.from_numpy(d),
        t_cut=torch.from_numpy(t_cut), lidx=torch.from_numpy(lidx).long(),
        hit=[np.asarray(x) for x in hit], info=[np.asarray(x) for x in info],
        occ=np.asarray(occ), t_light=np.asarray(t_light))


def test_closest_hit_matches(ref):
    hit = tint.closest_hit(ref["st"], ref["org"], ref["dirn"])
    t, ptype, pindex, inst, u, v = (x.numpy() for x in hit)
    t_r, ptype_r, pindex_r, inst_r, u_r, v_r = ref["hit"]
    np.testing.assert_allclose(t, t_r, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ptype, ptype_r)
    assert len(set(ptype_r.tolist())) >= 5  # every primitive type is hit
    same = (pindex == pindex_r) & (inst == inst_r)
    assert (~same).mean() <= 0.005
    np.testing.assert_allclose(u[same], u_r[same], atol=1e-4)
    np.testing.assert_allclose(v[same], v_r[same], atol=1e-4)


def test_closest_hit_respects_t_max(ref):
    t_max = torch.full((N,), 2.0)
    hit = tint.closest_hit(ref["st"], ref["org"], ref["dirn"], t_max=t_max)
    t_r = ref["hit"][0]
    expect = np.where(t_r < 2.0, t_r, 1e9)
    np.testing.assert_allclose(hit.t.numpy(), expect, rtol=1e-5, atol=1e-5)


def test_hit_info_matches(ref):
    hit = tint.closest_hit(ref["st"], ref["org"], ref["dirn"])
    info = tint.hit_info(ref["st"], ref["org"], ref["dirn"], hit)
    pos, nrm, inside, mat, tu, tv = (x.numpy() for x in info)
    pos_r, nrm_r, inside_r, mat_r, tu_r, tv_r = ref["info"]
    same = ((hit.pindex.numpy() == ref["hit"][2])
            & (ref["hit"][1] != 0))
    np.testing.assert_allclose(pos[same], pos_r[same], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(nrm[same], nrm_r[same], atol=1e-4)
    np.testing.assert_array_equal(inside[same], inside_r[same])
    np.testing.assert_array_equal(mat[same], mat_r[same])
    np.testing.assert_allclose(tu[same], tu_r[same], atol=1e-4)
    np.testing.assert_allclose(tv[same], tv_r[same], atol=1e-4)


def test_occlusion_query_matches(ref):
    occ = tint.occlusion_query(ref["st"], ref["org"], ref["dirn"],
                               ref["t_cut"]).numpy()
    tc = ref["t_cut"].numpy()
    edge = np.abs(ref["hit"][0] - tc) <= 1e-5 * np.abs(tc)
    assert 0.1 < ref["occ"].mean() < 0.9
    np.testing.assert_array_equal(occ[~edge], ref["occ"][~edge])


def test_light_hit_t_matches(ref):
    t = tint.light_hit_t(ref["st"], ref["org"], ref["dirn"], ref["lidx"])
    np.testing.assert_allclose(t.numpy(), ref["t_light"], rtol=1e-5,
                               atol=1e-5)


def test_camera_rays_match():
    args = ([0, 1.8, -4.2], [0, 0.9, 0], [0, 1, 0], 38.0)
    cj, ct = JCamera.look_at(*args), TCamera.look_at(*args, device="cpu")
    for f in ct._fields:
        np.testing.assert_allclose(getattr(ct, f).numpy(),
                                   np.asarray(getattr(cj, f)), atol=1e-7)
    rng = np.random.default_rng(1)
    xs = rng.integers(0, 64, 256)
    ys = rng.integers(0, 48, 256)
    ju, jv = rng.random((2, 256)).astype(np.float32)
    oj, dj = cj.cast_rays(jnp.asarray(xs), jnp.asarray(ys), 64, 48,
                          jnp.asarray(ju), jnp.asarray(jv))
    ot, dt = ct.cast_rays(torch.from_numpy(xs), torch.from_numpy(ys), 64, 48,
                          torch.from_numpy(ju), torch.from_numpy(jv))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-6)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-6)
