"""Normal and bump maps in the port against the JAX package: the atlas's
normal_sample and bump_sample on the same texels, ids and uv; hit_info's
shading normals on the same hit records over a normal-mapped and a
bump-mapped mesh (a textured icosphere with spherical uv, its seam
included, and a cube whose uv are all zero, where the tangent frame
degenerates); and trace per lane on a small bunny carrying both maps.
Textures are made with numpy from a fixed seed; both packages' builders
take the same scene, and the per-lane checks carry the JAX scene over
with convert.scene_from_reference (the JAX side's mesh queries through
its plain reference walk, intersector "wide", as in
tests/test_torch_integrator.py).

Tolerances: texture samples within 1e-6; normals within 1e-5; trace
as tests/test_torch_integrator.py (rtol/atol 1e-4 on >= 99.5% of lanes,
mean within 1e-3 relative, rays within 0.5%).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptsharp_tpu import examples as jex
from ptsharp_tpu import integrator as jint
from ptsharp_tpu import intersect as jisect
from ptsharp_tpu import materials as jmat
from ptsharp_tpu.camera import Camera as JCamera
from ptsharp_tpu.geometry import mesh as jmesh
from ptsharp_tpu.scene import SceneBuilder as JBuilder
from ptsharp_tpu.textures import TextureAtlas as JAtlas

from ptsharp_tpu_torch import convert
from ptsharp_tpu_torch import examples as tex
from ptsharp_tpu_torch import integrator as tint
from ptsharp_tpu_torch import intersect as tisect
from ptsharp_tpu_torch import materials as tmat
from ptsharp_tpu_torch.core import rng
from ptsharp_tpu_torch.geometry import mesh as tmesh
from ptsharp_tpu_torch.scene import SceneBuilder as TBuilder
from ptsharp_tpu_torch.textures import TextureAtlas as TAtlas

from tests.test_torch_integrator import (
    assert_radiance_parity, camera_rays, port_config,
)

W, H = 32, 24
JAX_PKG = types.SimpleNamespace(builder=JBuilder, mesh=jmesh, mat=jmat,
                                bunny=jex._bunny_mesh, build={})
PORT_PKG = types.SimpleNamespace(builder=TBuilder, mesh=tmesh, mat=tmat,
                                 bunny=tex._bunny_mesh,
                                 build={"device": "cpu"})


def maps(seed=0, size=32):
    """(normal map, bump map) images: tangent-space normals near +z, and
    a smooth height field with noise."""
    g = np.random.default_rng(seed)
    n = np.stack([0.5 + 0.25 * g.standard_normal((size, size)),
                  0.5 + 0.25 * g.standard_normal((size, size)),
                  0.85 + 0.1 * g.random((size, size))], axis=-1)
    y, x = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    h = 0.5 + 0.3 * np.sin(x * 0.7) * np.cos(y * 0.45) \
        + 0.1 * g.random((size, size))
    return (np.clip(n, 0, 1).astype(np.float32),
            np.repeat(h[..., None], 3, axis=-1).astype(np.float32))


def build_scene(pkg, name):
    b = pkg.builder()
    m = pkg.mat
    nmap, bmap = maps()
    nid = b.add_texture(nmap)
    bid = b.add_texture(bmap)
    b.add_plane([0, 0, 0], [0, 1, 0], m.diffuse_material([0.7, 0.7, 0.7]))
    b.add_sphere([3, 5, -3], 1.2, m.light_material([1, 1, 1], 9.0))
    b.set_environment(color=[0.1, 0.11, 0.14])
    if name == "bunny":
        mat = m.Material(color=(0.7, 0.65, 0.55), normal_texture=nid,
                         bump_texture=bid, bump_multiplier=2.0)
        mesh = pkg.bunny(3).fit_inside([-1, 0, -1], [1, 2, 1], [0.5, 0, 0.5])
        b.add_mesh(mesh, mat)
        return b.build(leaf_size=14, intersector="pallas", wide_k=8,
                       **pkg.build)
    mapped = (m.Material(color=(0.6, 0.6, 0.6), normal_texture=nid)
              if name == "normal" else
              m.Material(color=(0.6, 0.6, 0.6), bump_texture=bid,
                         bump_multiplier=3.0))
    sph = pkg.mesh.sphere_mesh([0, 1, 0], 1.0, subdivisions=2)
    v = sph.v.reshape(-1, 3) - np.array([0, 1, 0], np.float32)
    uv = np.stack([0.5 + np.arctan2(v[:, 2], v[:, 0]) / (2 * np.pi),
                   0.5 + np.arcsin(np.clip(v[:, 1], -1, 1)) / np.pi], -1)
    b.add_mesh(pkg.mesh.TriMesh(v=sph.v, n=sph.n,
                                uv=uv.reshape(-1, 3, 2).astype(np.float32)),
               mapped)
    # all-zero uv: a degenerate tangent frame
    b.add_mesh(pkg.mesh.cube_mesh([1.4, 0, -0.4], [2.2, 0.8, 0.4]), mapped)
    return b.build(leaf_size=4, **pkg.build)


def test_normal_and_bump_samples_match():
    g = np.random.default_rng(1)
    imgs = [g.random((8, 12, 3)).astype(np.float32),
            g.random((16, 16, 3)).astype(np.float32)]
    data = np.zeros((2, 16, 16, 3), np.float32)
    data[0, :8, :12] = imgs[0]
    data[1] = imgs[1]
    sizes = np.array([[8, 12], [16, 16]], np.int32)
    ja = JAtlas(data=jnp.asarray(data), sizes=jnp.asarray(sizes))
    ta = TAtlas.from_arrays(data, sizes, "cpu")
    n = 4096
    tid = g.integers(-1, 2, n).astype(np.int32)
    u, v = (g.uniform(-2, 2, (2, n))).astype(np.float32)
    for name in ("normal_sample", "bump_sample"):
        want = np.asarray(getattr(ja, name)(jnp.asarray(tid), jnp.asarray(u),
                                            jnp.asarray(v)))
        got = getattr(ta, name)(torch.from_numpy(tid), torch.from_numpy(u),
                                torch.from_numpy(v)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=name)
    # texel gradients flow through both (built on the differentiable sample)
    d = ta.data.clone().requires_grad_()
    at = ta._replace(data=d)
    out = (at.normal_sample(torch.from_numpy(tid), torch.from_numpy(u),
                            torch.from_numpy(v)).sum()
           + at.bump_sample(torch.from_numpy(tid), torch.from_numpy(u),
                            torch.from_numpy(v)).square().sum())
    (gd,) = torch.autograd.grad(out, d)
    assert torch.isfinite(gd).all() and gd.abs().sum() > 0


@pytest.mark.parametrize("name", ["normal", "bump"])
def test_hit_info_normals_match(name):
    """The same hit records through both packages' hit_info: shading
    normals within 1e-5 on every lane, on the mapped sphere (its uv seam
    included), the zero-uv cube and the unmapped floor."""
    sj = build_scene(JAX_PKG, name)
    st = convert.scene_from_reference(*convert.reference_arrays(sj),
                                      device="cpu")
    assert st.has_surface_maps and sj.has_surface_maps
    np.testing.assert_array_equal(st.tri_e1.numpy(), np.asarray(sj.tri_e1))
    cam = JCamera.look_at([0.4, 1.6, -4.0], [0.5, 0.8, 0], [0, 1, 0], 50.0)
    o, d = camera_rays(cam, 64, 48)
    hj = jisect.closest_hit(sj, jnp.asarray(o), jnp.asarray(d))
    ij = jisect.hit_info(sj, jnp.asarray(o), jnp.asarray(d), hj)
    ht = tisect.Hit(*(torch.from_numpy(np.array(x)) for x in hj))
    it = tisect.hit_info(st, torch.from_numpy(o.copy()),
                         torch.from_numpy(d.copy()), ht)
    tri = np.asarray(hj.ptype) == 5
    assert tri.mean() > 0.2
    # both meshes are hit
    assert len(np.unique(np.asarray(hj.inst)[tri])) == 2
    nt, nj = it.normal.numpy(), np.asarray(ij.normal)
    np.testing.assert_allclose(nt, nj, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(it.inside.numpy(), np.asarray(ij.inside))
    np.testing.assert_array_equal(it.mat_id.numpy(), np.asarray(ij.mat_id))
    # the maps move the normal away from the interpolated one
    plain = dataclasses.replace(st, has_surface_maps=False)
    n0 = tisect.hit_info(plain, torch.from_numpy(o.copy()),
                         torch.from_numpy(d.copy()), ht).normal.numpy()
    assert np.abs(n0 - nt)[tri].max() > 1e-2


def test_port_build_matches_the_jax_build():
    """The port's own build of the mapped bunny: the same slot-ordered
    edges, maps flag, atlas and material table as the JAX build."""
    sj = build_scene(JAX_PKG, "bunny")
    st = build_scene(PORT_PKG, "bunny")
    assert st.has_surface_maps
    for name in ("tri_e1", "tri_e2", "tri_uv0", "tri_uv1", "tri_uv2"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(sj, name)))
    for name in ("normal_texture", "bump_texture", "bump_multiplier"):
        np.testing.assert_array_equal(getattr(st.materials, name).numpy(),
                                      np.asarray(getattr(sj.materials, name)))
    np.testing.assert_array_equal(st.textures.data.numpy(),
                                  np.asarray(sj.textures.data))


def test_trace_matches_on_a_mapped_bunny():
    sj = build_scene(JAX_PKG, "bunny")
    st = convert.scene_from_reference(*convert.reference_arrays(sj),
                                      device="cpu")
    cam = JCamera.look_at([0, 1.8, -4.2], [0, 0.9, 0], [0, 1, 0], 38.0)
    o, d = camera_rays(cam, W, H)
    icfg = jint.IntegratorConfig(max_bounces=3)
    rj = [np.asarray(x) for x in jax.jit(jint.trace, static_argnums=(1,))(
        dataclasses.replace(sj, intersector="wide"), icfg, jnp.asarray(o),
        jnp.asarray(d), jax.random.PRNGKey(4))]
    rt = tint.trace(st, port_config(icfg), torch.from_numpy(o.copy()),
                    torch.from_numpy(d.copy()), rng.PRNGKey(4))
    assert_radiance_parity(rt.radiance.numpy(), rj[0], int(rt.rays_traced),
                           int(rj[3]))
    np.testing.assert_allclose(rt.normal.numpy(), rj[2], atol=1e-4)
