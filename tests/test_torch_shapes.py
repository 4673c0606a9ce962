"""The port's marched shapes against the JAX package's, lane by lane, on
rays made with numpy from a seed: sphere_trace over each SDF primitive and
operator and over the trees of examples sdf and love (each tree carried
over node by node with convert.sdf_from_reference), sdf_normal; the
heightfield's and the volume's intersect, normal_at, sample, band_sign and
material_at; closest_hit, occlusion_query and hit_info on mixed scenes
(analytic primitives, a mesh, an SDF, a volume and a heightfield; the
same with two mesh instances, so the TLAS); the NEE of an emissive SDF
(closest-hit shadows, as the JAX package takes them) and the inside flag
of SDF and volume hits; and geometry/march.py's check interval: every
march equal bit for bit at CHECK_EVERY=1 and at the default.

The JAX side runs as its own tests run it: eagerly (sdf_normal, normal_at,
the samplers, closest_hit, hit_info and occlusion_query op by op), its
while_loops compiled, as lax runs them. Under jax.jit XLA fuses the
distance evaluations (next paragraph), which the central-difference
normals amplify; tests/test_torch_catalog.py holds the jitted renders.

Tolerances (XLA contracts a*b+c into FMA, torch does not: ROADMAP Queue
3): hit/miss equal on >= 99.5% of lanes; where both hit, t within 1e-4
(SDF), MARCH_STEP / 64 (volume) or 1e-5 (heightfield). Normals where t
agrees (hit_info: bit for bit): within 1e-4 on >= 99.5% of lanes, and
within NORMAL_ATOL on all. The normals are central differences,
(d(p + e) - d(p - e)) / 2e, over distances of O(1) magnitude: one
float32 ulp of d (1.2e-7 at 1, 2.4e-7 at 2) over 2e = 2e-4 (SDF) moves a
component by up to 2.4e-3, so NORMAL_ATOL = 2.5e-3 bounds any pair of
evaluations an ulp apart. The port takes the SDF's central difference in
float64 (geometry/sdf.py sdf_normal), so its SDF normals are held to the
JAX package's sdf_normal on float64 points (jax.enable_x64) within 1e-4,
and to its float32 one within NORMAL_ATOL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptsharp_tpu import examples as jex
from ptsharp_tpu import integrator as jint
from ptsharp_tpu import intersect as jisect
from ptsharp_tpu.geometry import function as jfn
from ptsharp_tpu.geometry import primitives as jprim
from ptsharp_tpu.geometry import sdf as jsdf
from ptsharp_tpu.geometry import volume as jvol
from ptsharp_tpu.geometry.mesh import sphere_mesh as jsphere_mesh
from ptsharp_tpu.materials import diffuse_material as jdiffuse
from ptsharp_tpu.materials import light_material as jlight
from ptsharp_tpu.scene import SceneBuilder as JSceneBuilder

from ptsharp_tpu_torch import convert
from ptsharp_tpu_torch import examples as tex
from ptsharp_tpu_torch import integrator as tint
from ptsharp_tpu_torch import intersect as tisect
from ptsharp_tpu_torch.core import rng
from ptsharp_tpu_torch.geometry import function as tfn
from ptsharp_tpu_torch.geometry import march
from ptsharp_tpu_torch.geometry import sdf as tsdf
from ptsharp_tpu_torch.geometry import volume as tvol
from ptsharp_tpu_torch.scene import PT_SDF, PT_SPHERE, PT_VOLUME

from tests.test_torch_integrator import port_config

N_RAYS = 2048
HIT_FRAC = 0.995
NORMAL_FRAC = 0.995
NORMAL_ATOL = 2.5e-3


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def rays_at_box(lo, hi, n=N_RAYS, seed=0):
    """Origins on a sphere around the box, aimed at points inside it
    (and a margin around it, so some rays miss)."""
    g = np.random.default_rng(seed)
    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    c, ext = (lo + hi) / 2, (hi - lo) / 2
    rad = 2.5 * float(np.linalg.norm(ext)) + 0.5
    u = g.normal(size=(n, 3))
    org = c + rad * u / np.linalg.norm(u, axis=1, keepdims=True)
    target = c + ext * g.uniform(-1.2, 1.2, (n, 3))
    d = target - org
    return (org.astype(np.float32),
            (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32))


def box_clip(org, dirn, lo, hi):
    te, tx = jprim.box_entry_exit(jnp.asarray(org), jnp.asarray(dirn),
                                  jnp.asarray(lo, jnp.float32),
                                  jnp.asarray(hi, jnp.float32))
    return np.asarray(te), np.asarray(tx)


def assert_hits_match(tj, tt, t_tol, what):
    """Prints the shares it holds (run with -s to read them)."""
    hj, ht = tj < 1e8, tt < 1e8
    agree = (hj == ht).mean()
    both = hj & ht
    dt = np.abs(tj - tt)[both]
    print(f"{what}: hit/miss equal on {agree:.4%} of {hj.size} lanes, "
          f"{both.sum()} both hit, t within {dt.max():.3e}, bit-equal t on "
          f"{(dt == 0).mean():.4%}")
    assert agree >= HIT_FRAC, (what, agree)
    assert both.any(), what
    assert dt.max() <= t_tol, (what, dt.max())
    return both


def assert_normals_match(nj, nt, what):
    dn = np.abs(nj - nt).max(axis=-1)
    print(f"{what}: normals within 1e-4 on {(dn <= 1e-4).mean():.4%} of "
          f"{dn.size}, at most {dn.max():.3e} apart")
    assert np.isfinite(nt).all(), what
    assert (dn <= 1e-4).mean() >= NORMAL_FRAC, (what, (dn <= 1e-4).mean())
    assert dn.max() <= NORMAL_ATOL, (what, dn.max())


def jax_normal64(node, p):
    """The JAX package's sdf_normal on float64 points (jax x64)."""
    with jax.enable_x64():
        return np.asarray(jsdf.sdf_normal(node, jnp.asarray(
            np.asarray(p, np.float32).astype(np.float64)))).astype(np.float32)


def _rot(axis, ang):
    return np.asarray(jex.transform.rotate(np.asarray(axis, np.float32), ang))


# each case: a JAX SDF tree; the port's copy is convert.sdf_from_reference's
SDF_CASES = {
    "sphere": lambda: jsdf.SdfSphere(0.9),
    "supersphere": lambda: jsdf.SdfSphere(0.9, exponent=3.0),
    "cube": lambda: jsdf.SdfCube((1.2, 0.8, 1.0)),
    "cylinder": lambda: jsdf.SdfCylinder(0.5, 1.4),
    "capsule": lambda: jsdf.SdfCapsule(a=(0, -0.4, 0.1), b=(0.3, 0.5, 0),
                                       radius=0.3),
    "capsule_n": lambda: jsdf.SdfCapsule(radius=0.3, exponent=4.0),
    "torus": lambda: jsdf.SdfTorus(0.8, 0.25),
    "torus_exponents": lambda: jsdf.SdfTorus(0.8, 0.25, major_exponent=3.0,
                                             minor_exponent=4.0),
    "union": lambda: jsdf.SdfSphere(0.6) | jsdf.SdfCube((1.4, 0.3, 0.3)),
    "difference": lambda: jsdf.SdfCube((1.2, 1.2, 1.2)) - jsdf.SdfSphere(0.75),
    "intersection": lambda: jsdf.SdfCube((1.2, 1.2, 1.2)) & jsdf.SdfSphere(
        0.8),
    "transform": lambda: jsdf.SdfTransform(
        jsdf.SdfCylinder(0.3, 1.5), _rot([1.0, 0.5, 0.0], 0.7)
        @ np.diag([1.0, 1.0, 1.0, 1.0]).astype(np.float32)),
    "scale": lambda: jsdf.SdfScale(jsdf.SdfTorus(0.6, 0.2), 1.5),
    "repeat": lambda: jsdf.SdfRepeat(jsdf.SdfSphere(0.2), (0.6, 0.6, 0.6),
                                     (-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)),
    "sdf_scene": lambda: jex.sdf_scene(8, 8)[0].sdf_objects[0][0],
    "love": lambda: jex.love(8, 8)[0].sdf_objects[0][0],
}


@pytest.mark.parametrize("case", sorted(SDF_CASES))
def test_sphere_trace_matches(case):
    node = SDF_CASES[case]()
    tnode = convert.sdf_from_reference(node)
    lo, hi = node.bounds()
    np.testing.assert_array_equal(tnode.bounds()[0], lo)
    np.testing.assert_array_equal(tnode.bounds()[1], hi)
    org, dirn = rays_at_box(lo, hi, seed=len(case))
    te, tx = box_clip(org, dirn, lo, hi)
    tj = np.asarray(jsdf.sphere_trace(node, jnp.asarray(org),
                                      jnp.asarray(dirn), jnp.asarray(te),
                                      jnp.asarray(tx)))
    tt = tsdf.sphere_trace(tnode, _t(org), _t(dirn), _t(te), _t(tx)).numpy()
    both = assert_hits_match(tj, tt, 1e-4, case)
    # the normals at the JAX hit points, where t agrees: the port's
    # float64 central difference against the JAX package's on float64
    # points, and within its float32 noise of its float32 one
    p = (org + dirn * tj[:, None])[both]
    nt = tsdf.sdf_normal(tnode, _t(p)).numpy()
    assert_normals_match(jax_normal64(node, p), nt, case)
    nj = np.asarray(jsdf.sdf_normal(node, jnp.asarray(p)))
    assert np.abs(nj - nt).max() <= NORMAL_ATOL
    # the distance itself, at the same points, eagerly on both sides
    np.testing.assert_allclose(tnode.evaluate(_t(p)).numpy(),
                               np.asarray(node.evaluate(jnp.asarray(p))),
                               rtol=0, atol=1e-6)


def terrain_jax(x, y):
    return 0.6 * jnp.sin(x) * jnp.cos(y) + 0.2 * jnp.sin(3 * x) * jnp.sin(
        2 * y)


def _heightfields():
    lo = np.array([-4, -4, -2], np.float32)
    hi = np.array([4, 4, 2], np.float32)
    return (jfn.Heightfield(f=terrain_jax, bmin=lo, bmax=hi),
            tfn.Heightfield(f=tex.terrain, bmin=lo, bmax=hi))


def test_heightfield_matches():
    hj, ht = _heightfields()
    org, dirn = rays_at_box(hj.bmin, hj.bmax, seed=3)
    te, tx = box_clip(org, dirn, hj.bmin, hj.bmax)
    tj = np.asarray(jfn.intersect(hj, jnp.asarray(org), jnp.asarray(dirn),
                                  jnp.asarray(te), jnp.asarray(tx)))
    tt = tfn.intersect(ht, _t(org), _t(dirn), _t(te), _t(tx)).numpy()
    both = assert_hits_match(tj, tt, 1e-5, "heightfield")
    p = (org + dirn * tj[:, None])[both]
    nj = np.asarray(jfn.normal_at(hj, jnp.asarray(p)))
    nt = tfn.normal_at(ht, _t(p)).numpy()
    np.testing.assert_allclose(nt, nj, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(ht.inside(_t(p)).numpy(),
                                  np.asarray(hj.inside(jnp.asarray(p))))


def _volumes():
    """volume's grid and windows, and a small random grid of 3 windows."""
    sj = jex.volume_scene(8, 8)[0]
    g = np.random.default_rng(5)
    small = jvol.VolumeGrid(
        data=g.random((9, 7, 5)).astype(np.float32),
        windows=[jvol.VolumeWindow(0.2, 0.35, 1), jvol.VolumeWindow(
            0.5, 0.6, 2), jvol.VolumeWindow(0.55, 0.9, 3)],
        bmin=np.array([-1.0, -0.5, -0.7], np.float32),
        bmax=np.array([0.8, 0.9, 0.6], np.float32))
    return {"volume": sj.volumes[0], "small": small}


@pytest.mark.parametrize("which", ["volume", "small"])
def test_volume_matches(which):
    vj = _volumes()[which]
    vt = convert.volume_from_reference(vj)
    data_j, data_t = jnp.asarray(vj.data), _t(vj.data)
    org, dirn = rays_at_box(vj.bmin, vj.bmax, n=1024, seed=7)
    te, tx = box_clip(org, dirn, vj.bmin, vj.bmax)
    tj = np.asarray(jvol.intersect(data_j, vj, jnp.asarray(org),
                                   jnp.asarray(dirn), jnp.asarray(te),
                                   jnp.asarray(tx)))
    tt = tvol.intersect(data_t, vt, _t(org), _t(dirn), _t(te),
                        _t(tx)).numpy()
    both = assert_hits_match(tj, tt, tvol.MARCH_STEP / tvol.REFINE, which)
    p = (org + dirn * tj[:, None])[both]
    # samplers at the hit points and at random points in and around the box
    g = np.random.default_rng(8)
    q = np.concatenate([p, g.uniform(vj.bmin - 0.2, vj.bmax + 0.2,
                                     (512, 3)).astype(np.float32)])
    sj = np.asarray(jvol.sample(data_j, vj, jnp.asarray(q)))
    st = tvol.sample(data_t, vt, _t(q)).numpy()
    np.testing.assert_allclose(st, sj, rtol=0, atol=1e-6)
    bj = np.asarray(jvol.band_sign(data_j, vj, jnp.asarray(q)))
    bt = tvol.band_sign(data_t, vt, _t(q)).numpy()
    assert (bj == bt).mean() >= HIT_FRAC
    mj = np.asarray(jvol.material_at(data_j, vj, jnp.asarray(q)))
    mt = tvol.material_at(data_t, vt, _t(q)).numpy()
    assert (mj == mt).mean() >= HIT_FRAC
    nj = np.asarray(jvol.normal_at(data_j, vj, jnp.asarray(p)))
    nt = tvol.normal_at(data_t, vt, _t(p)).numpy()
    assert_normals_match(nj, nt, which)


def test_from_slices_matches():
    g = np.random.default_rng(9)
    slices = g.random((4, 5, 6)).astype(np.float32)
    win = [jvol.VolumeWindow(0.3, 0.6, 0)]
    vj = jvol.VolumeGrid.from_slices(slices, win, [0, 0, 0], [1, 1, 1])
    vt = tvol.VolumeGrid.from_slices(slices, [tvol.VolumeWindow(0.3, 0.6, 0)],
                                     [0, 0, 0], [1, 1, 1])
    np.testing.assert_array_equal(vt.data, vj.data)
    assert vt.data.shape == (6, 5, 4) and vt.data.flags.c_contiguous


@pytest.mark.parametrize("case", ["sdf_scene", "love", "volume",
                                  "heightfield"])
def test_march_check_interval_is_bit_equal(case, monkeypatch):
    """Every march with a check after each step (CHECK_EVERY=1, the JAX
    loop's cond) and at the default interval gives the same bits on every
    lane."""
    if case == "heightfield":
        _hj, shape = _heightfields()
        lo, hi = shape.bmin, shape.bmax

        def run():
            return tfn.intersect(shape, o, d, te, tx)
    elif case == "volume":
        shape = convert.volume_from_reference(_volumes()["volume"])
        lo, hi = shape.bmin, shape.bmax
        data = _t(shape.data)

        def run():
            return tvol.intersect(data, shape, o, d, te, tx)
    else:
        shape = convert.sdf_from_reference(SDF_CASES[case]())
        lo, hi = shape.bounds()

        def run():
            return tsdf.sphere_trace(shape, o, d, te, tx)
    org, dirn = rays_at_box(lo, hi, n=1024, seed=11)
    o, d = _t(org), _t(dirn)
    te, tx = (_t(x) for x in box_clip(org, dirn, lo, hi))
    assert march.CHECK_EVERY > 1
    default = run()
    monkeypatch.setattr(march, "CHECK_EVERY", 1)
    assert torch.equal(run(), default)
    assert bool((default < 1e8).any())


def test_march_counts_steps():
    march.reset_counts()
    shape = convert.sdf_from_reference(SDF_CASES["love"]())
    lo, hi = shape.bounds()
    org, dirn = rays_at_box(lo, hi, n=256, seed=12)
    te, tx = (_t(x) for x in box_clip(org, dirn, lo, hi))
    tsdf.sphere_trace(shape, _t(org), _t(dirn), te, tx, tag="closest")
    marches, steps, lane_steps = march.COUNTS["closest"]
    assert marches == 1 and 0 < steps <= tsdf.TRACE_MAX_STEPS
    assert steps <= lane_steps <= 256 * steps
    march.reset_counts()
    assert not march.COUNTS


def low_terrain_jax(x, y):
    return terrain_jax(x, y) - 2.3


def low_terrain(x, y):
    return tex.terrain(x, y) - 2.3


LIGHT = [2.5, -2.0, 4.5]


def mixed_builder(tlas: bool, emissive_sdf: bool = False):
    """A JAX scene of every shape kind, seen from +z: a floor plane, a
    sphere light, a transformed cube, a mesh (two instances when `tlas`),
    love's SDF tree, a small volume and a heightfield."""
    b = JSceneBuilder()
    b.add_plane([0, 0, -3.5], [0, 0, 1], jdiffuse([0.7, 0.7, 0.7]))
    b.add_sphere(LIGHT, 0.8, jlight([1, 1, 1], 6.0))
    b.add_cube([-0.3, -0.3, -0.3], [0.3, 0.3, 0.3], jdiffuse([0.2, 0.6, 0.3]),
               transform=np.asarray(jex.transform.translate(
                   np.array([2.0, -0.8, 1.0], np.float32))))
    mesh = jsphere_mesh([-2.0, 0.0, 1.5], 0.6, subdivisions=2)
    mid = b.add_mesh(mesh, jdiffuse([0.8, 0.5, 0.2]))
    if tlas:
        b.add_mesh_instance(mid, transform=np.asarray(jex.transform.translate(
            np.array([0.0, 1.4, 0.0], np.float32))))
    sdf_mat = jlight([1, 0.9, 0.8], 3.0) if emissive_sdf else jdiffuse(
        [0.6, 0.2, 0.2])
    b.add_sdf(jex.love(8, 8)[0].sdf_objects[0][0], sdf_mat)
    v = _volumes()["small"]
    for w in v.windows:
        w.material_id = b.material_id(jdiffuse([0.1 * w.material_id, 0.4,
                                                0.5]))
    shift = np.array([0.8, -2.2, 0.0], np.float32)
    v.bmin, v.bmax = v.bmin + shift, v.bmax + shift
    b.add_volume(v)
    b.add_function(jfn.Heightfield(
        f=low_terrain_jax, bmin=np.array([-4, -4, -3.2], np.float32),
        bmax=np.array([-1.2, 4, -1.4], np.float32)), jdiffuse([0.3, 0.5, 0.3]))
    return b


def mixed_scene(tlas: bool, emissive_sdf: bool = False):
    sj = mixed_builder(tlas, emissive_sdf).build(use_tlas=tlas)
    st = convert.scene_from_reference(*convert.reference_arrays(sj),
                                       device="cpu", functions=[low_terrain])
    assert st.use_tlas == tlas == bool(sj.use_tlas)
    return sj, st


def scene_rays(n=N_RAYS, seed=13):
    """From above the scene (z in [5, 6]) down toward it."""
    g = np.random.default_rng(seed)
    org = g.uniform([-3, -3, 5], [3, 3, 6], (n, 3)).astype(np.float32)
    target = g.uniform([-3.5, -3, -3], [3.5, 3, 2], (n, 3))
    d = target - org
    return org, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(
        np.float32)


@pytest.mark.parametrize("tlas", [False, True], ids=["flat", "tlas"])
def test_mixed_scene_queries_match(tlas):
    sj, st = mixed_scene(tlas)
    org, dirn = scene_rays()
    jo, jd = jnp.asarray(org), jnp.asarray(dirn)
    hj = jisect.closest_hit(sj, jo, jd)
    ht = tisect.closest_hit(st, _t(org), _t(dirn))
    kj, kt = np.asarray(hj.ptype), ht.ptype.numpy()
    assert (kj == kt).mean() >= HIT_FRAC
    kinds = set(np.unique(kj).tolist())
    assert {PT_SDF, PT_VOLUME, 8, 5}.issubset(kinds), kinds
    same = kj == kt
    tj, tt = np.asarray(hj.t), ht.t.numpy()
    assert np.abs(tj - tt)[same & (tj < 1e8)].max() <= 1e-4
    assert (np.asarray(hj.pindex) == ht.pindex.numpy())[same].all()
    ij = jisect.hit_info(sj, jo, jd, hj)
    it = tisect.hit_info(st, _t(org), _t(dirn), ht)
    nj, nt = np.asarray(ij.normal), it.normal.numpy()
    assert (np.asarray(ij.mat_id) == it.mat_id.numpy())[same].mean() \
        >= HIT_FRAC
    assert (np.asarray(ij.inside) == it.inside.numpy())[same].mean() \
        >= HIT_FRAC
    # normals where t agrees bit for bit; where it differs (within its
    # tolerance) the point differs, so only NORMAL_ATOL holds there. The
    # SDF lanes' against the JAX package's float64 central difference at
    # the same points (sdf_normal's docstring)
    agree = same & (tj == tt)
    assert agree.mean() >= 0.85
    sdf = kj == PT_SDF
    assert_normals_match(nj[agree & ~sdf], nt[agree & ~sdf], "hit_info")
    pos = np.asarray(ij.position)[agree & sdf]
    assert_normals_match(jax_normal64(sj.sdf_objects[0][0], pos),
                         nt[agree & sdf], "hit_info sdf")
    assert np.abs(nj - nt)[same].max() <= NORMAL_ATOL
    # shadow queries toward the light, cut short of it, and lanes cut at 0
    pos = org + dirn * np.minimum(tt, 20.0)[:, None] * 0.5
    to = np.array(LIGHT, np.float32) - pos
    dist = np.linalg.norm(to, axis=1)
    sd = (to / dist[:, None]).astype(np.float32)
    cut = (dist - 0.9).astype(np.float32)
    cut[::7] = 0.0
    oj = np.asarray(jisect.occlusion_query(sj, jnp.asarray(pos),
                                           jnp.asarray(sd), jnp.asarray(cut)))
    ot = tisect.occlusion_query(st, _t(pos), _t(sd), _t(cut)).numpy()
    assert (oj == ot).mean() >= HIT_FRAC
    assert oj.any() and (~oj).any() and not ot[::7].any()


def test_inside_flag_never_set_for_sdf_and_volume_hits():
    """Rays leaving an SDF sphere, a volume and an analytic sphere from
    within: the analytic hit reports inside, the SDF and volume hits
    never do (ptsharp_tpu/intersect.py:954-958)."""
    jb = JSceneBuilder()
    jb.add_sdf(jsdf.SdfTransform(jsdf.SdfSphere(1.0), np.asarray(
        jex.transform.translate(np.array([-3.0, 0, 0], np.float32)))),
        jdiffuse([0.5, 0.5, 0.5]))
    jb.add_sphere([3.0, 0, 0], 1.0, jdiffuse([0.5, 0.5, 0.5]))
    v = _volumes()["volume"]
    jb.add_volume(jvol.VolumeGrid(v.data, v.windows, v.bmin + np.array(
        [0, 3.0, 0], np.float32), v.bmax + np.array([0, 3.0, 0], np.float32)))
    sj = jb.build()
    st = convert.scene_from_reference(*convert.reference_arrays(sj),
                                       device="cpu")
    g = np.random.default_rng(14)
    u = g.normal(size=(96, 3))
    dirn = (u / np.linalg.norm(u, axis=1, keepdims=True)).astype(np.float32)
    org = np.repeat(np.array([[-3.0, 0, 0], [3.0, 0, 0], [0, 4.0, 0]],
                             np.float32), 32, axis=0)
    ht = tisect.closest_hit(st, _t(org), _t(dirn))
    it = tisect.hit_info(st, _t(org), _t(dirn), ht)
    hj = jax.jit(jisect.closest_hit)(sj, jnp.asarray(org), jnp.asarray(dirn))
    ij = jax.jit(jisect.hit_info)(sj, jnp.asarray(org), jnp.asarray(dirn), hj)
    kind = ht.ptype.numpy()
    np.testing.assert_array_equal(kind[:64], np.asarray(hj.ptype)[:64])
    assert (kind[:32] == PT_SDF).all() and (kind[32:64] == PT_SPHERE).all()
    inside = it.inside.numpy()
    np.testing.assert_array_equal(inside, np.asarray(ij.inside))
    assert not inside[:32].any() and inside[32:64].all()
    assert not inside[kind == PT_VOLUME].any() and (kind == PT_VOLUME).any()


def test_emissive_sdf_takes_closest_hit_shadows():
    """An emissive SDF is a PT_SDF light whose own hit distance
    light_hit_t cannot give, so NEE takes closest-hit shadows (any-hit
    would read every such shadow ray invisible); the port's sample_lights
    equals the JAX package's per lane on the mixed scene."""
    sj, st = mixed_scene(False, emissive_sdf=True)
    icfg = jint.IntegratorConfig()
    assert PT_SDF in st.light_types and icfg.anyhit_shadows
    assert not tint.uses_anyhit_shadows(st, port_config(icfg))
    plain = tex.cornell(8, 8, device="cpu")[0]
    assert tint.uses_anyhit_shadows(plain, port_config(icfg))
    org, dirn = scene_rays(seed=15)
    hj = jax.jit(jisect.closest_hit)(sj, jnp.asarray(org), jnp.asarray(dirn))
    ij = jax.jit(jisect.hit_info)(sj, jnp.asarray(org), jnp.asarray(dirn), hj)
    keep = np.asarray(hj.ptype) != 0
    pos = np.asarray(ij.position)[keep]
    nrm = np.asarray(ij.normal)[keep]
    key = jax.random.PRNGKey(3)
    cj, _n = jax.jit(jint.sample_lights, static_argnums=(1,))(
        sj, icfg, jnp.asarray(pos), jnp.asarray(nrm), key)
    ct, _n = tint.sample_lights(st, port_config(icfg), _t(pos), _t(nrm),
                                rng.PRNGKey(3))
    cj, ct = np.asarray(cj), ct.numpy()
    close = np.all(np.isclose(ct, cj, rtol=1e-4, atol=1e-4), axis=-1)
    assert close.mean() >= HIT_FRAC, close.mean()
    # the emissive SDF lights some lanes: its shadow rays land on it
    lit_by_sdf = (st.light_ptype.numpy() == PT_SDF).any()
    assert lit_by_sdf and (ct.sum(-1) > 0).mean() > 0.2


def test_device_independent_numerics():
    """core/vec.py's scalar functions and products, which give the card
    the CPU's bits: on the CPU each equals the float32 result it stands
    for (the correctly rounded root and transcendentals, torch's CPU
    rsqrt, cross and 3-term sum, and the JAX package's eager einsum, an
    fma chain), so swapping them in changed no CPU bit but sqrt's."""
    from ptsharp_tpu_torch.core import vec

    g = np.random.default_rng(16)
    x = g.uniform(0.01, 9.0, 4096).astype(np.float32)
    a = g.normal(size=(4096, 3)).astype(np.float32)
    b = g.normal(size=(4096, 3)).astype(np.float32)
    m = g.normal(size=(4096, 3, 4)).astype(np.float32)
    tx, ta, tb, tm = (torch.from_numpy(v) for v in (x, a, b, m))
    x64 = x.astype(np.float64)
    np.testing.assert_array_equal(vec.sqrt(tx).numpy(), np.sqrt(x))
    np.testing.assert_array_equal(vec.rsqrt(tx).numpy(),
                                  np.float32(1) / np.sqrt(x))
    for fn, ref in ((vec.sin, np.sin), (vec.cos, np.cos)):
        np.testing.assert_array_equal(fn(tx).numpy(),
                                      ref(x64).astype(np.float32))
    np.testing.assert_array_equal(vec.dot(ta, tb).numpy(),
                                  torch.sum(ta * tb, dim=-1).numpy())
    np.testing.assert_array_equal(vec.cross(ta, tb).numpy(),
                                  np.asarray(jnp.cross(a, b)))
    np.testing.assert_array_equal(
        vec.affine(tm, ta).numpy(),
        np.asarray(jnp.einsum("...ij,...j->...i", m[..., :3], a)
                   + m[..., 3]))
