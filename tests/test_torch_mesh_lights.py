"""Mesh lights in the port against the JAX package: emissive meshes
registered as PT_TRIANGLE lights, their emissive triangles sampled by
area in NEE, on four scenes built alike by both packages' SceneBuilder:

  quad         an emissive quad_mesh over a floor, a sphere between them
               ("pallas", flat, K=4, leaf 4);
  ke           a quad whose per-triangle materials make one triangle
               emissive (the OBJ Ke case) beside a sphere light ("wide");
  transformed  an emissive cube mesh under a rotation, a scale and a
               translation, and a second, diffuse instance of the same
               mesh ("pallas", flat: instance ids from the slot map);
  tlas         an emissive quad instance, two cube instances and a
               sphere light, walked through the TLAS ("wide", use_tlas).

Checked: the port's own build gives the JAX build's em_*, light_* and
pmf arrays (and tri_e1/tri_e2); sample_lights per lane in both shadow
modes (any-hit and the closest-hit that must land on an emissive
triangle of the light's instance) and with every light ("all"); trace
per lane in both shadow modes; the tape equal to autograd on the port,
and its gradients equal to the JAX tape's. The JAX scene is carried
over with convert.scene_from_reference for the per-lane checks; the JAX
side runs jitted, its mesh queries through its plain reference walk
(intersector "wide" over the same scene's XLA tables).

Tolerances (tests/test_torch_integrator.py's and test_torch_tape.py's):
per lane within rtol 1e-4, atol 1e-4 on at least 99.5% of lanes, means
within 1e-3 relative, rays within 0.5%; the build's arrays equal; the
tape against autograd at rtol 1e-3, against the JAX tape at rtol 1e-3,
atol 1e-3 * max |g_jax|.
"""

import dataclasses
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptsharp_tpu import integrator as jint
from ptsharp_tpu import materials as jmat
from ptsharp_tpu.camera import Camera as JCamera
from ptsharp_tpu.geometry import mesh as jmesh
from ptsharp_tpu.scene import SceneBuilder as JBuilder

from ptsharp_tpu_torch import convert, intersect
from ptsharp_tpu_torch import integrator as tint
from ptsharp_tpu_torch import materials as tmat
from ptsharp_tpu_torch import tape as ttape
from ptsharp_tpu_torch.core import rng
from ptsharp_tpu_torch.geometry import mesh as tmesh
from ptsharp_tpu_torch.scene import PT_TRIANGLE
from ptsharp_tpu_torch.scene import SceneBuilder as TBuilder

from tests.test_torch_integrator import (
    assert_radiance_parity, camera_rays, port_config,
)
from tests.test_torch_tape import jax_grads, port_grads

W, H = 24, 16
KEY = 5
JAX_PKG = types.SimpleNamespace(builder=JBuilder, mesh=jmesh, mat=jmat,
                                build={})
PORT_PKG = types.SimpleNamespace(builder=TBuilder, mesh=tmesh, mat=tmat,
                                 build={"device": "cpu"})
CFG = jint.IntegratorConfig(max_bounces=3)
LIGHT_FIELDS = ("light_ptype", "light_pindex", "light_center",
                "light_radius", "light_mat", "light_tri_start",
                "light_tri_end", "light_area", "light_cdf", "light_pmf",
                "em_v0", "em_e1", "em_e2", "em_nrm", "em_cdf", "em_mat",
                "tri_e1", "tri_e2")


def _xform(angle_deg, scale, offset):
    """Rotation about y, then a per-axis scale, then a translation."""
    a = math.radians(angle_deg)
    c, s = math.cos(a), math.sin(a)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]],
                         np.float32) @ np.diag(scale).astype(np.float32)
    m[:3, 3] = offset
    return m


def build_scene(pkg, name):
    """The named scene with one package's builder; returns the scene."""
    b = pkg.builder()
    m = pkg.mat
    b.add_plane([0, 0, 0], [0, 1, 0], m.diffuse_material([0.7, 0.7, 0.7]))
    b.set_environment(color=[0.02, 0.02, 0.03])
    quad = pkg.mesh.quad_mesh([-1, 2, -1], [1, 2, -1], [1, 2, 1], [-1, 2, 1])
    cube = pkg.mesh.cube_mesh([-0.5, -0.5, -0.5], [0.5, 0.5, 0.5])
    if name == "quad":
        b.add_sphere([0.3, 0.7, 0.2], 0.4, m.diffuse_material([0.6, 0.3, 0.2]))
        b.add_mesh(quad, m.light_material([1.0, 0.9, 0.8], 4.0))
        return b.build(leaf_size=4, intersector="pallas", wide_k=4,
                       **pkg.build)
    if name == "ke":
        dark = b.material_id(m.diffuse_material([0.1, 0.1, 0.1]))
        lit = b.material_id(m.light_material([1.0, 1.0, 1.0], 6.0))
        b.add_mesh(pkg.mesh.TriMesh(v=quad.v, uv=quad.uv,
                                    mat=np.array([lit, dark], np.int32)))
        b.add_sphere([2.5, 3.0, -1.0], 0.3, m.light_material([0.9, 0.8, 1.0],
                                                             12.0))
        return b.build(leaf_size=4, **pkg.build)
    if name == "transformed":
        mid = b.add_mesh(cube, m.light_material([1.0, 0.8, 0.6], 5.0),
                         transform=_xform(30.0, [1.6, 0.1, 0.9],
                                          [0.0, 2.2, 0.3]))
        b.add_mesh_instance(mid, transform=_xform(-20.0, [0.6, 0.6, 0.6],
                                                  [0.5, 0.3, -0.2]),
                            material=m.diffuse_material([0.3, 0.5, 0.7]))
        return b.build(leaf_size=4, intersector="pallas", wide_k=4,
                       **pkg.build)
    assert name == "tlas"
    b.add_mesh(quad, m.light_material([0.8, 0.9, 1.0], 3.0),
               transform=_xform(15.0, [0.8, 1.0, 0.8], [0.2, 0.3, 0.4]))
    mid = b.add_mesh(cube, m.diffuse_material([0.7, 0.4, 0.3]),
                     transform=_xform(0.0, [1.0, 1.0, 1.0], [-0.6, 0.5, 0.1]))
    b.add_mesh_instance(mid, transform=_xform(45.0, [0.5, 1.5, 0.5],
                                              [0.9, 0.75, -0.3]))
    b.add_sphere([-2.5, 4.0, -2.0], 0.5, m.light_material([1, 1, 1], 10.0))
    return b.build(leaf_size=4, **pkg.build)


SCENES = ("quad", "ke", "transformed", "tlas")


def jax_walk(sj):
    return dataclasses.replace(sj, intersector="wide")


@pytest.fixture(scope="module", params=SCENES)
def case(request):
    name = request.param
    sj = build_scene(JAX_PKG, name)
    cam = JCamera.look_at([0.5, 3.2, -4.5], [0, 0.6, 0], [0, 1, 0], 45.0)
    o, d = camera_rays(cam, W, H, seed=1)
    return dict(name=name, sj=sj, o=o, d=d,
                st=convert.scene_from_reference(*convert.reference_arrays(sj),
                                                device="cpu"))


def test_light_tables_match_the_jax_build(case):
    """The port's own build registers the same lights with the same area
    tables and power pmf (emissive area for a mesh light)."""
    sj = case["sj"]
    st = build_scene(PORT_PKG, case["name"])
    assert PT_TRIANGLE in st.light_types
    assert st.light_types == tuple(sj.light_types)
    assert st.use_tlas == bool(sj.use_tlas) == (case["name"] == "tlas")
    assert st.em_v0.shape[0] > 0
    for name in LIGHT_FIELDS:
        got = getattr(st, name).numpy()
        want = np.asarray(getattr(sj, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    if case["name"] == "ke":
        # only the emissive triangle is sampled, the sphere's power by r^2
        assert st.em_v0.shape[0] == 1
        np.testing.assert_allclose(float(st.light_area[0]), 2.0, rtol=1e-6)


def _surface_points(case):
    """Hit positions and shading normals of the case's camera rays (the
    port's, fed to both packages), and the hit mask."""
    org = torch.from_numpy(case["o"].copy())
    dirn = torch.from_numpy(case["d"].copy())
    hit = intersect.closest_hit(case["st"], org, dirn)
    info = intersect.hit_info(case["st"], org, dirn, hit)
    return (info.position.numpy(), info.normal.numpy(),
            (hit.ptype != 0).numpy())


@pytest.mark.parametrize("light_mode", ["random", "all"])
@pytest.mark.parametrize("anyhit", [True, False])
def test_sample_lights_matches(case, anyhit, light_mode):
    pos, nrm, act = _surface_points(case)
    assert act.mean() > 0.5
    jcfg = dataclasses.replace(CFG, anyhit_shadows=anyhit,
                               light_mode=light_mode)
    key = 9

    def jax_sl(scene, p, n, a):
        return jint.sample_lights(scene, jcfg, p, n, jax.random.PRNGKey(key),
                                  active=a, want_aux=True)

    cj, nj, auxj = jax.jit(jax_sl)(jax_walk(case["sj"]), jnp.asarray(pos),
                                   jnp.asarray(nrm), jnp.asarray(act))
    ct, nt, auxt = tint.sample_lights(
        case["st"], port_config(jcfg), torch.from_numpy(pos),
        torch.from_numpy(nrm), rng.PRNGKey(key),
        active=torch.from_numpy(act), want_aux=True)
    cj = np.where(act[:, None], np.asarray(cj), 0.0)
    ct = np.where(act[:, None], ct.numpy(), 0.0)
    assert_radiance_parity(ct, cj)
    assert int(nt) == int(nj)
    assert (ct > 0).any(axis=-1).mean() > 0.05  # the lights do reach it
    if light_mode == "all":
        assert auxt is None and auxj is None
        return
    lm_close = auxt[0].numpy() == np.asarray(auxj[0])
    assert lm_close[act].mean() >= 0.995
    kap_close = np.isclose(auxt[1].numpy(), np.asarray(auxj[1]), rtol=1e-4,
                           atol=1e-4)
    assert kap_close[act].mean() >= 0.995


@pytest.mark.parametrize("anyhit", [True, False])
def test_trace_matches(case, anyhit):
    jcfg = dataclasses.replace(CFG, anyhit_shadows=anyhit)
    rj = [np.asarray(x) for x in jax.jit(jint.trace, static_argnums=(1,))(
        jax_walk(case["sj"]), jcfg, jnp.asarray(case["o"]),
        jnp.asarray(case["d"]), jax.random.PRNGKey(KEY))]
    rt = tint.trace(case["st"], port_config(jcfg),
                    torch.from_numpy(case["o"].copy()),
                    torch.from_numpy(case["d"].copy()), rng.PRNGKey(KEY))
    assert_radiance_parity(rt.radiance.numpy(), rj[0], int(rt.rays_traced),
                           int(rj[3]))
    np.testing.assert_allclose(rt.normal.numpy(), rj[2], atol=1e-4)


@pytest.mark.parametrize("name", ["ke", "tlas"])
def test_tape_matches_autograd_and_the_jax_tape(name):
    """Mesh-light NEE in the tape: lm is the sampled triangle's material,
    not the light's. The tape's radiance equals trace's bit for bit, its
    gradients autograd's, and the JAX tape's."""
    sj = build_scene(JAX_PKG, name)
    cam = JCamera.look_at([0.5, 3.2, -4.5], [0, 0.6, 0], [0, 1, 0], 45.0)
    o, d = camera_rays(cam, W, H, seed=2)
    wts = np.random.default_rng(3).random((W * H, 3)).astype(np.float32)
    gj = jax_grads(jax_walk(sj), CFG, jnp.asarray(o), jnp.asarray(d),
                   jnp.asarray(wts))
    c = dict(st=convert.scene_from_reference(*convert.reference_arrays(sj),
                                             device="cpu"),
             icfg=port_config(CFG), org=torch.from_numpy(o.copy()),
             dirn=torch.from_numpy(d.copy()), wts=torch.from_numpy(wts))
    res_tape, g_tape = port_grads(c, ttape.trace_tape_radiance)
    res_ad, g_ad = port_grads(c, tint.trace)
    assert torch.equal(res_tape.radiance, res_ad.radiance)
    # a mesh light's emittance takes gradient through its triangle's row
    em_rows = np.unique(c["st"].em_mat.numpy())
    assert np.abs(g_tape["emittance"][em_rows]).max() > 0
    for leaf in ttape.DiffParams._fields:
        np.testing.assert_allclose(g_tape[leaf], g_ad[leaf], rtol=1e-3,
                                   atol=1e-7, err_msg=leaf)
        np.testing.assert_allclose(
            g_tape[leaf], gj[leaf], rtol=1e-3,
            atol=1e-3 * max(np.abs(gj[leaf]).max(), 1e-30), err_msg=leaf)


def test_mesh_light_visibility_uses_instance_ids():
    """Closest-hit shadow rays toward a mesh light count only when they
    land on the light's own instance: on the transformed scene, the flat
    pallas walk's instance ids (its slot map) make every shadow ray that
    reaches the emissive cube visible and none that reaches the diffuse
    instance of the same mesh."""
    st = build_scene(PORT_PKG, "transformed")
    assert st.p_flat and st.inst_inv.shape[0] == 2
    (li,) = np.nonzero(st.light_ptype.numpy() == PT_TRIANGLE)[0]
    assert int(st.light_pindex[li]) == 0
    tri = torch.arange(st.em_v0.shape[0])
    p = (st.em_v0[tri] + 0.3 * st.em_e1[tri] + 0.3 * st.em_e2[tri])
    org = p + st.em_nrm[tri] * 0.5
    dirn = -st.em_nrm[tri]
    hit = intersect.closest_hit(st, org, dirn.contiguous())
    assert (hit.ptype == PT_TRIANGLE).all()
    assert (hit.inst == 0).all()
    # from the side onto the diffuse instance: instance 1
    side = intersect.closest_hit(st, torch.tensor([[3.0, 0.3, -0.2]]),
                                 torch.tensor([[-1.0, 0.0, 0.0]]))
    assert int(side.ptype[0]) == PT_TRIANGLE and int(side.inst[0]) == 1
