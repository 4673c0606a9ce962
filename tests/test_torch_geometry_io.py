"""The port's host geometry and I/O against the JAX package's, on the same
inputs (files written here, arrays made with numpy from a seed): OBJ/MTL
loading (fan triangulation, negative and omitted indices, Ke emittance,
Kd, map_Kd and map_bump textures, per-triangle material ids through the
builder) and saving, the Ke group of an OBJ as a mesh light, STL binary
and ASCII reading and writing, molfile parsing and the ball-and-stick
build, Poisson-disc sampling, the spherical-harmonics basis and lobe
meshes, marching tetrahedra over numpy and over SDF trees, the mesh
helpers (num_triangles, smooth_normals_threshold, move_to), the texture
helpers, vec.length_n and Camera.set_focus.

Host outputs are equal bit for bit (files byte for byte). The one
exception is marching tetrahedra over an SDF tree, whose grid the JAX
package evaluates with jnp and the port with torch: the triangle count is
equal and the vertices within 1e-5 (the port's float32 distances equal the
eager jnp ones on every grid point but the few where XLA's pow rounds
otherwise, which the test counts).
"""

import math
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptsharp_tpu import examples as jex
from ptsharp_tpu.camera import Camera as JCamera
from ptsharp_tpu.core import poisson as jpoisson
from ptsharp_tpu.core import vec as jvec
from ptsharp_tpu.geometry import mc as jmc
from ptsharp_tpu.geometry import mesh as jmesh
from ptsharp_tpu.geometry import sh_shape as jsh
from ptsharp_tpu.io import mol as jmol
from ptsharp_tpu.io import obj as jobj
from ptsharp_tpu.io import stl as jstl
from ptsharp_tpu.scene import SceneBuilder as JSceneBuilder
from ptsharp_tpu import textures as jtextures

from ptsharp_tpu_torch import convert
from ptsharp_tpu_torch import examples as tex
from ptsharp_tpu_torch import textures as ttextures
from ptsharp_tpu_torch.camera import Camera
from ptsharp_tpu_torch.core import poisson, vec
from ptsharp_tpu_torch.geometry import mc, sh_shape
from ptsharp_tpu_torch.geometry import mesh as tmesh
from ptsharp_tpu_torch.io import mol, obj, stl
from ptsharp_tpu_torch.scene import PT_TRIANGLE, SceneBuilder


def assert_mesh_equal(got, want):
    np.testing.assert_array_equal(got.v, want.v)
    np.testing.assert_array_equal(got.n, want.n)
    np.testing.assert_array_equal(got.uv, want.uv)
    if want.mat is None:
        assert got.mat is None
    else:
        np.testing.assert_array_equal(got.mat, want.mat)


def _materials(builder):
    return [tuple(getattr(m, f) for f in ("color", "emittance", "texture",
                                          "bump_texture"))
            for m in builder._materials]


OBJ_TEXT = """# faces of every form
mtllib scene.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 1.5 0.25
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
vn 0 0.6 0.8
f 1 2 3
usemtl red
f 1/1/1 2/2/1 3/3/2 4/4/2
f 1//1 3//2 4//1
usemtl lamp
f 3/3 4/4 5/1 2/2 1/1
f -5 -4 -3
usemtl textured
f -3/-2/-1 -2/-1/-2 -1/-4/-1
usemtl missing
f 2 3 5
"""
MTL_TEXT = """newmtl red
Kd 0.8 0.1 0.1
newmtl lamp
Kd 0.2 0.2 0.2
Ke 4.0 2.0 2.0
newmtl textured
Kd 0.5 0.5 0.5
map_Kd tex.png
map_bump bump.png
"""


def _write_obj(tmp_path):
    from PIL import Image

    (tmp_path / "scene.mtl").write_text(MTL_TEXT)
    (tmp_path / "scene.obj").write_text(OBJ_TEXT)
    g = np.random.default_rng(0)
    for name in ("tex.png", "bump.png"):
        Image.fromarray(g.integers(0, 256, (6, 5, 3), dtype=np.uint8)).save(
            tmp_path / name)
    return str(tmp_path / "scene.obj")


def test_obj_with_materials_matches(tmp_path):
    path = _write_obj(tmp_path)
    jb, tb = JSceneBuilder(), SceneBuilder()
    want = jobj.load_obj(path, builder=jb)
    got = obj.load_obj(path, builder=tb)
    assert_mesh_equal(got, want)
    # 1 + 2 (fan) + 1 + 3 (fan of five) + 1 + 1 + 1 triangles
    assert got.num_triangles == 10
    assert _materials(tb) == _materials(jb)
    assert len(set(got.mat.tolist())) == 4  # default, red, lamp, textured
    assert len(tb._textures) == len(jb._textures) == 2
    for a, b in zip(tb._textures, jb._textures):
        np.testing.assert_array_equal(a, b)
    # geometry only, no builder
    assert_mesh_equal(obj.load_obj(path), jobj.load_obj(path))
    mats = obj.load_mtl(str(tmp_path / "scene.mtl"))
    assert mats["lamp"].emittance == 4.0
    assert mats["lamp"].color == (1.0, 0.5, 0.5)
    assert mats["red"].color == (0.8, 0.1, 0.1)


def test_obj_ke_group_is_a_mesh_light(tmp_path):
    """An OBJ whose Ke group emits, added with per-triangle materials,
    becomes a PT_TRIANGLE light over its emissive triangles, as in the
    JAX package (the same light and em_* tables)."""
    path = _write_obj(tmp_path)
    jb, tb = JSceneBuilder(), SceneBuilder()
    jb.add_mesh(jobj.load_obj(path, builder=jb))
    tb.add_mesh(obj.load_obj(path, builder=tb))
    sj = jb.build()
    st = tb.build(device="cpu")
    assert st.light_ptype.tolist() == [PT_TRIANGLE]
    assert st.em_v0.shape[0] == 4  # the lamp group's four triangles
    for name in ("light_ptype", "light_pindex", "light_center",
                 "light_radius", "light_mat", "light_tri_start",
                 "light_tri_end", "light_area", "em_v0", "em_e1", "em_e2",
                 "em_nrm", "em_cdf", "em_mat", "tri_mat"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(sj, name)), name)


def test_save_obj_bytes_match(tmp_path):
    m = tex._bunny_mesh(2)
    obj.save_obj(m, str(tmp_path / "t.obj"))
    jobj.save_obj(jmesh.TriMesh(m.v, m.n, m.uv), str(tmp_path / "j.obj"))
    assert (tmp_path / "t.obj").read_bytes() == \
        (tmp_path / "j.obj").read_bytes()
    flat = tmesh.cube_mesh([0, 0, 0], [1, 2, 3])
    obj.save_obj(flat, str(tmp_path / "c.obj"))
    back = obj.load_obj(str(tmp_path / "c.obj"))
    np.testing.assert_array_equal(back.v, flat.v)


def test_load_texture_needs_pil(tmp_path, monkeypatch):
    path = _write_obj(tmp_path)
    np.testing.assert_array_equal(
        ttextures.load_texture(str(tmp_path / "tex.png")),
        jtextures.load_texture(str(tmp_path / "tex.png")))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        ttextures.load_texture(str(tmp_path / "tex.png"))
    # an MTL that names no map needs no PIL
    (tmp_path / "plain.mtl").write_text("newmtl a\nKd 0.1 0.2 0.3\n"
                                        "newmtl b\nKe 1 1 1\n")
    mats = obj.load_mtl(str(tmp_path / "plain.mtl"), SceneBuilder())
    assert mats["b"].emittance == 1.0
    with pytest.raises(ImportError):
        obj.load_obj(path, builder=SceneBuilder())


def test_texture_adjustments_match():
    img = np.random.default_rng(1).random((4, 3, 3)).astype(np.float32)
    np.testing.assert_array_equal(ttextures.pow_texture(img, 2.2),
                                  jtextures.pow_texture(img, 2.2))
    np.testing.assert_array_equal(ttextures.mul_texture(img, 0.7),
                                  jtextures.mul_texture(img, 0.7))


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
def test_stl_matches(tmp_path, binary):
    m = tex._bunny_mesh(2)
    stl.save_stl(m, str(tmp_path / "t.stl"), binary=binary)
    jstl.save_stl(jmesh.TriMesh(m.v, m.n, m.uv), str(tmp_path / "j.stl"),
                  binary=binary)
    assert (tmp_path / "t.stl").read_bytes() == \
        (tmp_path / "j.stl").read_bytes()
    got = stl.load_stl(str(tmp_path / "t.stl"))
    assert_mesh_equal(got, jstl.load_stl(str(tmp_path / "t.stl")))
    assert got.num_triangles == m.num_triangles
    if binary:
        np.testing.assert_array_equal(got.v, m.v)
        np.testing.assert_array_equal(got.n[:, 0], m.face_normals())
    else:
        np.testing.assert_allclose(got.v, m.v, rtol=1e-6)


def _molfile(m):
    lines = ["benzene", "  ptsharp", "",
             f"{len(m.elements):3d}{len(m.bonds):3d}  0  0  0  0  0  0  0  0"
             "999 V2000"]
    for p, el in zip(m.positions, m.elements):
        lines.append(f"{p[0]:10.4f}{p[1]:10.4f}{p[2]:10.4f} {el:<3s} 0  0  0"
                     "  0  0  0  0  0  0  0  0  0")
    for a, b in m.bonds:
        lines.append(f"{a + 1:3d}{b + 1:3d}  1  0  0  0  0")
    return "\n".join(lines)


@pytest.mark.parametrize("which", ["benzene", "caffeine_like"])
def test_molecule_matches(which):
    jm, tm = getattr(jmol, which)(), getattr(mol, which)()
    np.testing.assert_array_equal(tm.positions, jm.positions)
    assert tm.elements == jm.elements
    np.testing.assert_array_equal(tm.bonds, jm.bonds)
    text = _molfile(tm)
    got, want = mol.parse_molfile(text), jmol.parse_molfile(text)
    np.testing.assert_array_equal(got.positions, want.positions)
    assert got.elements == want.elements == tm.elements
    np.testing.assert_array_equal(got.bonds, want.bonds)
    a, b = tm.positions[0], tm.positions[tm.bonds[-1][1]]
    np.testing.assert_array_equal(mol.bond_transform(a, b, 0.18),
                                  jmol.bond_transform(a, b, 0.18))
    # the ball-and-stick build: the same spheres, cylinders and materials
    jb, tb = JSceneBuilder(), SceneBuilder()
    jmol.add_molecule(jb, jm)
    mol.add_molecule(tb, tm)
    sj, st = jb.build(), tb.build(device="cpu")
    for name in ("sphere_center", "sphere_radius", "sphere_mat", "cyl_radius",
                 "cyl_z0", "cyl_z1", "cyl_inv", "cyl_mat"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(sj, name)), name)
    assert _materials(tb) == _materials(jb)


@pytest.mark.parametrize("seed", [0, 1])
def test_poisson_disc_matches(seed):
    got = poisson.poisson_disc(6.0, 4.0, 0.7, seed=seed)
    np.testing.assert_array_equal(got, jpoisson.poisson_disc(6.0, 4.0, 0.7,
                                                             seed=seed))
    d = np.linalg.norm(got[:, None] - got[None, :], axis=-1)
    assert (d + np.eye(len(got)) * 1e9).min() >= 0.7 - 1e-5


def test_sh_basis_and_meshes_match():
    g = np.random.default_rng(2)
    p = g.normal(size=(500, 3))
    for l in range(5):
        for m in range(-l, l + 1):
            np.testing.assert_array_equal(sh_shape.real_sh(l, m, p),
                                          jsh.real_sh(l, m, p))
    np.testing.assert_array_equal(sh_shape.sh_implicit(3, 2, p),
                                  jsh.sh_implicit(3, 2, p))
    np.testing.assert_array_equal(sh_shape.sh_lobe_sign(3, 2, p),
                                  jsh.sh_lobe_sign(3, 2, p))
    for got, want in zip(sh_shape.sh_meshes(3, 2, step=0.05),
                         jsh.sh_meshes(3, 2, step=0.05)):
        assert got.num_triangles > 50
        assert_mesh_equal(got, want)


def test_sdf_mesh_over_numpy_matches():
    def f(p):
        return np.linalg.norm(p, axis=-1) - 1.0

    got = mc.sdf_mesh(f, [-1.3] * 3, [1.3] * 3, 0.1)
    assert_mesh_equal(got, jmc.sdf_mesh(f, [-1.3] * 3, [1.3] * 3, 0.1))
    assert got.num_triangles > 500


@pytest.mark.parametrize("tree", ["teapot", "love"])
def test_sdf_mesh_over_a_tree_matches(tree):
    """The grid evaluated by the port's tree on a CPU float32 tensor, the
    JAX package's with jnp: equal triangle counts, vertices within 1e-5."""
    if tree == "teapot":
        body = jex.sdf_mod.SdfSphere(radius=1.0, exponent=3.0)
        handle = jex.sdf_mod.SdfTransform(
            jex.sdf_mod.SdfTorus(major=0.45, minor=0.1),
            np.asarray(jex.transform.translate(np.array([-1.05, 0.1, 0.0]))))
        spout = jex.sdf_mod.SdfTransform(
            jex.sdf_mod.SdfCapsule(a=[0, 0, 0], b=[0.9, 0.55, 0.0],
                                   radius=0.14),
            np.asarray(jex.transform.translate(np.array([0.8, 0.0, 0.0]))))
        node = jex.sdf_mod.SdfUnion(body, handle, spout)
        box, step = ([-2.2, -1.4, -1.4], [2.2, 1.4, 1.4]), 0.06
    else:
        node = jex.love(8, 8)[0].sdf_objects[0][0]
        box, step = (node.bounds()[0] - 0.1, node.bounds()[1] + 0.1), 0.05
    tnode = convert.sdf_from_reference(node)
    want = jmc.sdf_mesh(node.evaluate, *box, step)
    got = mc.sdf_mesh(tnode.evaluate, *box, step)
    assert got.num_triangles == want.num_triangles > 1000
    np.testing.assert_allclose(got.v, want.v, rtol=0, atol=1e-5)
    # the tree itself is accepted as the evaluator
    np.testing.assert_array_equal(mc.sdf_mesh(tnode, *box, step).v, got.v)
    # grid points whose float32 distance differs between the packages
    g = np.random.default_rng(3)
    pts = g.uniform(box[0], box[1], (4096, 3)).astype(np.float32)
    diff = (tnode.evaluate(torch.from_numpy(pts)).numpy()
            != np.asarray(node.evaluate(jnp.asarray(pts))))
    assert diff.mean() <= 0.005, diff.mean()


def test_teapot_mesh_matches():
    """The teapot's mesh as examples.teapot makes it (marching tetrahedra
    over the tree, thresholded smooth normals, fitted) against the JAX
    package's: equal triangle counts, vertices within 1e-5, and vertex
    normals within 1e-5 but on the corners where a vertex 1e-7 away falls
    into another group of smooth_normals_threshold (its keys round
    positions to 1e-5) or to the other side of its angle threshold: at
    most 0.1% of them. (The two scenes' BVHs over such vertices may order
    a few triangles otherwise, so slot tables are not compared; the
    renders are, in tests/test_torch_catalog.py.)"""
    body = jex.sdf_mod.SdfSphere(radius=1.0, exponent=3.0)
    handle = jex.sdf_mod.SdfTransform(
        jex.sdf_mod.SdfTorus(major=0.45, minor=0.1),
        np.asarray(jex.transform.translate(np.array([-1.05, 0.1, 0.0]))))
    spout = jex.sdf_mod.SdfTransform(
        jex.sdf_mod.SdfCapsule(a=[0, 0, 0], b=[0.9, 0.55, 0.0], radius=0.14),
        np.asarray(jex.transform.translate(np.array([0.8, 0.0, 0.0]))))
    node = jex.sdf_mod.SdfUnion(body, handle, spout)
    meshes = []
    for evaluate, sdf_mesh in ((node.evaluate, jmc.sdf_mesh),
                               (convert.sdf_from_reference(node),
                                mc.sdf_mesh)):
        m = sdf_mesh(evaluate, [-2.2, -1.4, -1.4], [2.2, 1.4, 1.4], 0.06)
        m = m.smooth_normals_threshold(math.radians(40))
        meshes.append(m.fit_inside([-1, 0, -1], [1, 1.4, 1], [0.5, 0, 0.5]))
    want, got = meshes
    assert got.num_triangles == want.num_triangles
    np.testing.assert_allclose(got.v, want.v, rtol=0, atol=1e-5)
    far = np.abs(got.n - want.n).max(axis=-1) > 1e-5
    assert far.mean() <= 1e-3, far.sum()
    st = tex.teapot(8, 8, device="cpu")[0]
    assert st.intersector == "wide" and st.max_leaf == 8
    assert int((st.leaf_rows.reshape(-1, 9).abs().sum(1) > 0).sum()) \
        == got.num_triangles


def test_mesh_helpers_match():
    m = tex._bunny_mesh(1)
    jm = jmesh.TriMesh(m.v, m.n, m.uv)
    assert m.num_triangles == jm.num_triangles == 80
    assert_mesh_equal(m.smooth_normals_threshold(math.radians(30)),
                      jm.smooth_normals_threshold(math.radians(30)))
    assert_mesh_equal(m.move_to([1, 2, 3], [0.5, 0, 0.5]),
                      jm.move_to([1, 2, 3], [0.5, 0, 0.5]))


def test_length_n_and_set_focus_match():
    g = np.random.default_rng(4)
    a = g.normal(size=(1000, 3)).astype(np.float32)
    for n in (2.0, 3.0, 4.0, 2.5):
        got = vec.length_n(torch.from_numpy(a), n).numpy()
        want = np.asarray(jvec.length_n(jnp.asarray(a), n))
        assert (got == want).mean() >= 0.995
        np.testing.assert_allclose(got, want, rtol=1e-6)
    cj = JCamera.look_at([2.8, 2.8, -4.5], [0, 1, 0], [0, 1, 0], 35.0)
    cj = cj.set_focus([0.0, 1.0, 0.0], 0.06)
    ct = Camera.look_at([2.8, 2.8, -4.5], [0, 1, 0], [0, 1, 0], 35.0,
                        device="cpu").set_focus([0.0, 1.0, 0.0], 0.06)
    for name in Camera._fields:
        np.testing.assert_allclose(getattr(ct, name).numpy(),
                                   np.asarray(getattr(cj, name)),
                                   rtol=1e-6, err_msg=name)
    assert float(ct.aperture_radius) == np.float32(0.06)
