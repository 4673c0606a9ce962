"""The TLAS of the port against the JAX package's, on a mixed use_tlas
scene: transformed spheres (one a light), cubes and cylinders, three
instances of two meshes (one with a material override, the last mesh's
BLAS ending on the last node row) and a plane; and on toybrick and
cube_field. The same scene is built by both packages (the port's own
build, held byte-equal to the JAX build's tables) and the same seeded
numpy rays go through both.

Tolerances (tests/test_torch_intersect.py's): t allclose at rtol 1e-5,
atol 1e-5; hit kind equal on every lane; index and instance equal except
ties (t agrees, so a different primitive is a tie) on at most 0.5% of
lanes; u, v and shading data within 1e-4 where the primitive agrees;
occlusion equal except where the nearest hit lies within 1e-5 * t_cut of
t_cut. Renders at 32x24 (no compaction there): tests/test_torch_render.py's
per-pixel rtol/atol 1e-4 on at least 99.5% of pixels, mean within 1e-3,
rays traced within 0.5%. The plain any-hit walk equals the bounded
closest-hit's kind != PT_NONE on every lane (the JAX package's shadow
query); the wrappers on CPU tensors equal their plain versions bit for
bit. The launcher's choice of csrc/tlas_walk.cu instance (traverse.
tlas_instance) is pinned for every instance's tables, and the card case
holds each instance against the plain versions, steps included.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ptsharp_tpu as jpt
from ptsharp_tpu import examples as jex
from ptsharp_tpu import intersect as jint
from ptsharp_tpu.core import transform as jt
from ptsharp_tpu.geometry import mesh as jmesh
from ptsharp_tpu.renderer import RenderConfig as JRenderConfig
from ptsharp_tpu.renderer import Renderer as JRenderer

import ptsharp_tpu_torch as tpt
from ptsharp_tpu_torch import convert
from ptsharp_tpu_torch import examples as tex
from ptsharp_tpu_torch import intersect as tint
from ptsharp_tpu_torch.accel import traverse as walks
from ptsharp_tpu_torch.core import rng
from ptsharp_tpu_torch.geometry import mesh as tmesh
from ptsharp_tpu_torch.kernels import traverse
from ptsharp_tpu_torch.renderer import RenderConfig, Renderer
from ptsharp_tpu_torch.scene import PT_NONE

from tests.test_torch_integrator import assert_radiance_parity, port_config

N = 2048
TOL = dict(rtol=1e-5, atol=1e-5)
TABLES = ("u_rows", "w_rows", "leaf_rows")
RANGES = ("u_inst_base", "u_inst_end", "w_inst_base", "w_inst_end")


def _np(a):
    return np.asarray(a, np.float32)


def _mixed(pkg, meshes, **build):
    """The mixed scene in package `pkg` (the JAX or the port's top-level
    module) with its mesh module `meshes`."""
    b = pkg.SceneBuilder()
    grey = pkg.diffuse_material([0.7, 0.7, 0.7])
    b.add_plane([0, -1, 0], [0, 1, 0], grey)
    b.add_sphere([0.5, 4.0, -1.0], 0.8, pkg.light_material([1, 1, 1], 10.0))
    b.add_sphere([0, 0, 0], 0.5, pkg.diffuse_material([0.8, 0.3, 0.2]),
                 transform=_np(jt.translate([-1.5, 0.2, 0.5]))
                 @ np.diag([1.0, 1.4, 1.0, 1.0]).astype(np.float32))
    rot = _np(jt.rotate([0, 1, 0], 0.6))
    b.add_cube([-0.4, -0.4, -0.4], [0.4, 0.4, 0.4],
               pkg.diffuse_material([0.9, 0.9, 0.2]),
               transform=rot @ _np(jt.translate([1.0, 0.0, 1.5])))
    b.add_cube([-0.3, -0.3, -0.3], [0.3, 0.3, 0.3], grey,
               transform=_np(jt.translate([2.2, 1.2, -0.4])))
    b.add_cylinder(0.3, -0.5, 0.5, pkg.diffuse_material([0.2, 0.6, 0.3]),
                   transform=_np(jt.translate([-1.0, 0.0, -1.5]))
                   @ _np(jt.rotate([1, 0, 0], 1.1)))
    sph = b.add_mesh(meshes.sphere_mesh([0, 0.4, 0], 1.0, subdivisions=2),
                     pkg.diffuse_material([0.5, 0.5, 0.5]))
    b.add_mesh_instance(sph, transform=_np(jt.translate([0.3, 0.0, 3.0]))
                        @ np.diag([1.5, 0.8, 1.0, 1.0]).astype(np.float32),
                        material=pkg.diffuse_material([0.1, 0.2, 0.9]))
    b.add_mesh(meshes.cube_mesh([1.6, -0.3, -0.3], [2.2, 0.3, 0.3]),
               pkg.diffuse_material([0.9, 0.6, 0.2]),
               transform=_np(jt.translate([-3.4, 0.5, 0.2])))
    return b.build(use_tlas=True, **build)


def _lone_instance(pkg, meshes, **build):
    """One instance and nothing else: the TLAS is a single instance leaf,
    and the instance's BLAS (one leaf) ends on the last node row."""
    b = pkg.SceneBuilder()
    b.add_mesh(meshes.cube_mesh([-0.5, -0.5, -0.5], [0.5, 0.5, 0.5]),
               pkg.diffuse_material([0.9, 0.6, 0.2]),
               transform=_np(jt.rotate([1, 1, 0], 0.7)))
    return b.build(use_tlas=True, **build)


def _rays(seed=5, n=N):
    g = np.random.default_rng(seed)
    org = (g.uniform(-3, 3, (n, 3)) + [0, 1.0, -1.0]).astype(np.float32)
    tgt = g.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    d = np.where(g.random((n, 1)) < 0.8, tgt - org,
                 g.normal(size=(n, 3))).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_cut = np.where(g.random(n) < 0.1, -1.0,
                     g.uniform(0.2, 6.0, n)).astype(np.float32)
    lidx = np.zeros(n, np.int32)
    return org, d, t_cut, lidx


def _builds(make, **build):
    """(JAX scene, the port's own build) of one scene."""
    return (make(jpt, jmesh, **build),
            make(tpt, tmesh, device="cpu", **build))


@jax.jit
def _reference_queries(sj, org, dirn, t_cut, lidx):
    """The JAX queries in one program; light_hit_t where the scene has a
    light."""
    hit = jint.closest_hit(sj, org, dirn)
    return (hit, jint.hit_info(sj, org, dirn, hit),
            jint.occlusion_query(sj, org, dirn, t_cut),
            jint.light_hit_t(sj, org, dirn, lidx)
            if sj.light_mat.shape[0] else None)


def _assert_hits(got, want, ties=0.005):
    """(t, kind, index, inst, u, v) against the reference's."""
    t, kind, index, inst, u, v = (np.asarray(x) for x in got)
    t_r, kind_r, index_r, inst_r, u_r, v_r = (np.asarray(x) for x in want)
    np.testing.assert_allclose(t, t_r, **TOL)
    np.testing.assert_array_equal(kind, kind_r)
    same = (index == index_r) & (inst == inst_r)
    assert (~same).mean() <= ties
    np.testing.assert_allclose(u[same], u_r[same], atol=1e-4)
    np.testing.assert_allclose(v[same], v_r[same], atol=1e-4)


@pytest.mark.parametrize("k", [4, 8])
def test_tables_match_the_reference_build(k):
    """The port's build lays out the JAX build's tables byte for byte, and
    the reference carried over by convert equals the port's own build."""
    sj, st = _builds(_mixed, wide_k=k)
    sc = convert.scene_from_reference(*convert.reference_arrays(sj),
                                       device="cpu")
    assert sj.use_tlas and st.use_tlas and sc.use_tlas
    for name in TABLES:
        ref = np.asarray(getattr(sj, name))
        for s in (st, sc):
            assert getattr(s, name).numpy().tobytes() == ref.tobytes(), name
    assert (st.tlas_end, st.w_tlas_end) == (sj.tlas_end, sj.w_tlas_end)
    for name in RANGES:
        assert getattr(st, name) == tuple(int(x) for x in
                                          np.asarray(getattr(sj, name)))
    for s in (st, sc):
        for w in ("u", "w"):
            np.testing.assert_array_equal(
                getattr(s, f"{w}_inst_range").numpy(),
                np.stack([np.asarray(getattr(sj, f"{w}_inst_base")),
                          np.asarray(getattr(sj, f"{w}_inst_end"))], 1))
    # the last mesh's BLAS ends on the last row, and instances re-enter it
    assert st.w_inst_range[-1, 1] == st.w_rows.shape[0]
    assert st.u_inst_range[-1, 1] == st.u_rows.shape[0]


@pytest.mark.parametrize("walk", ["wide4", "wide8", "walk"])
@pytest.mark.parametrize("make", [_mixed, _lone_instance])
def test_traverse_scene_matches(make, walk):
    k = 8 if walk == "wide8" else 4
    sj, st = _builds(make, wide_k=k)
    if walk == "walk":
        st = dataclasses.replace(st, intersector="walk")
    org, d, _tc, _l = _rays()
    t_max = np.where(np.arange(N) % 3 == 0, 2.5, 1e9).astype(np.float32)
    want = jax.jit(jint.traverse_scene, static_argnames="wide")(
        sj, jnp.asarray(org), jnp.asarray(d), jnp.asarray(t_max),
        wide=walk != "walk")
    got = tint.traverse_scene(st, torch.from_numpy(org), torch.from_numpy(d),
                              torch.from_numpy(t_max))
    _assert_hits(got, want)
    kind = got[1].numpy()
    if make is _mixed:
        assert set(kind.tolist()) >= {0, 1, 3, 4, 5}
        # hits inside the instance whose BLAS ends on the last row
        assert (got[3].numpy() == st.inst_inv.shape[0] - 1).sum() > 10
    else:
        assert st.tlas_end == st.w_tlas_end == 1
        assert (kind == 5).sum() > 100


@pytest.mark.parametrize("make", [_mixed, _lone_instance])
def test_scene_queries_match(make):
    """closest_hit, hit_info, occlusion_query and light_hit_t through the
    TLAS against the JAX package's (tests/test_torch_intersect.py)."""
    sj, st = _builds(make)
    org, d, t_cut, lidx = _rays()
    hit_r, info_r, occ_r, tl_r = _reference_queries(
        sj, jnp.asarray(org), jnp.asarray(d), jnp.asarray(t_cut),
        jnp.asarray(lidx))
    o, dd = torch.from_numpy(org), torch.from_numpy(d)
    hit = tint.closest_hit(st, o, dd)
    _assert_hits(hit, hit_r)
    info = tint.hit_info(st, o, dd, hit)
    same = ((hit.pindex.numpy() == np.asarray(hit_r.pindex))
            & (hit.inst.numpy() == np.asarray(hit_r.inst))
            & (np.asarray(hit_r.ptype) != 0))
    pos, nrm, inside, mat, tu, tv = (x.numpy() for x in info)
    np.testing.assert_allclose(pos[same], np.asarray(info_r.position)[same],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(nrm[same], np.asarray(info_r.normal)[same],
                               atol=1e-4)
    np.testing.assert_array_equal(inside[same],
                                  np.asarray(info_r.inside)[same])
    np.testing.assert_array_equal(mat[same], np.asarray(info_r.mat_id)[same])
    np.testing.assert_allclose(tu[same], np.asarray(info_r.tex_u)[same],
                               atol=1e-4)
    np.testing.assert_allclose(tv[same], np.asarray(info_r.tex_v)[same],
                               atol=1e-4)
    occ = tint.occlusion_query(st, o, dd, torch.from_numpy(t_cut)).numpy()
    edge = np.abs(np.asarray(hit_r.t) - t_cut) <= 1e-5 * np.abs(t_cut)
    assert np.asarray(occ_r).mean() > 0.02
    np.testing.assert_array_equal(occ[~edge], np.asarray(occ_r)[~edge])
    if make is _mixed:
        # the override material and the transformed primitives are shaded
        over = np.asarray(hit_r.inst) == 1
        assert over.sum() > 10
        assert (mat[over & same] == int(st.inst_mat[1])).all()
        np.testing.assert_allclose(
            tint.light_hit_t(st, o, dd, torch.from_numpy(lidx).long())
            .numpy(), np.asarray(tl_r), **TOL)


@pytest.mark.parametrize("walk", ["wide", "walk"])
def test_any_hit_equals_bounded_closest_hit(walk):
    """The any-hit walk's occlusion is the bounded closest-hit's kind !=
    PT_NONE on every lane (ptsharp_tpu/intersect.py:624-626), its steps
    those of a walk that ends on the first accepted hit; a lane with
    t_cut <= 0 takes no step."""
    _sj, st = _builds(_mixed)
    st = dataclasses.replace(st, intersector=walk)
    tabs = tint.scene_tlas(st)
    org, d, t_cut, _l = _rays(seed=9)
    o, dd, tc = (torch.from_numpy(x) for x in (org, d, t_cut))
    occ, steps = walks.any_hit_tlas_plain(tabs, o, dd, tc,
                                          return_iters=True)
    bounded = walks.closest_hit_tlas_plain(tabs, o, dd, tc,
                                           return_iters=True)
    assert torch.equal(occ, bounded[1] != PT_NONE)
    assert 0.1 < float(occ.float().mean()) < 0.9
    assert bool((steps[tc <= 0] == 0).all())
    assert bool((steps <= bounded[6]).all())
    assert bool((steps[~occ & (tc > 0)] == bounded[6][~occ & (tc > 0)]).all())


def test_wrappers_take_the_plain_versions_on_the_cpu():
    _sj, st = _builds(_mixed)
    tabs = tint.scene_tlas(st)
    org, d, t_cut, _l = _rays(seed=3, n=512)
    o, dd, tc = (torch.from_numpy(x) for x in (org, d, t_cut))
    tm = torch.full((512,), 1e9)
    got = traverse.closest_hit_tlas(tabs, o, dd, tm)
    want = walks.closest_hit_tlas_plain(tabs, o, dd, tm)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(traverse.any_hit_tlas(tabs, o, dd, tc),
                       walks.any_hit_tlas_plain(tabs, o, dd, tc))
    with pytest.raises(ValueError, match="counts"):
        traverse.closest_hit_tlas(tabs, o, dd, tm,
                                  counts=torch.zeros(2, dtype=torch.int64))


@pytest.mark.parametrize("bad", ["contiguous", "dtype", "range", "head",
                                 "k", "grad", "shape"])
def test_wrappers_reject_bad_inputs(bad):
    _sj, st = _builds(_mixed)
    tabs = tint.scene_tlas(st)
    org, d, _tc, _l = _rays(seed=3, n=64)
    o, dd = torch.from_numpy(org), torch.from_numpy(d)
    t = torch.full((64,), 1e9)
    if bad == "contiguous":
        o = torch.from_numpy(np.asfortranarray(org))
    elif bad == "dtype":
        tabs = tabs._replace(inst_range=tabs.inst_range.long())
    elif bad == "range":
        tabs = tabs._replace(inst_range=tabs.inst_range + 1000)
    elif bad == "head":
        tabs = tabs._replace(tlas_end=tabs.rows.shape[0] + 1)
    elif bad == "k":
        tabs = tabs._replace(k=1)
    elif bad == "grad":
        o = o.clone().requires_grad_()
    else:
        tabs = tabs._replace(cube_inv=tabs.cube_inv[:1])
    for fn in (traverse.closest_hit_tlas, traverse.any_hit_tlas):
        with pytest.raises(ValueError):
            fn(tabs, o, dd, t)


@pytest.mark.parametrize("what", ["64 spheres", "63 spheres",
                                  "two instances", "one instance",
                                  "pallas"])
def test_use_tlas_heuristic(what):
    """None picks the TLAS as the JAX package does: more than one
    instance, or 64 analytic primitives; never for "pallas"."""
    def make(pkg, meshes, **build):
        b = pkg.SceneBuilder()
        m = pkg.diffuse_material([0.5, 0.5, 0.5])
        n = {"64 spheres": 64, "63 spheres": 63}.get(what, 2)
        for i in range(n):
            b.add_sphere([i, 1, 0], 0.4, m)
        if what in ("two instances", "one instance", "pallas"):
            mid = b.add_mesh(meshes.cube_mesh([0, 0, 0], [1, 1, 1]), m)
            if what != "one instance":
                b.add_mesh_instance(mid, transform=_np(jt.translate([3, 0, 0])))
        if what == "pallas":
            return b.build(intersector="pallas", wide_k=8, **build)
        return b.build(**build)

    sj, st = _builds(make)
    assert st.use_tlas == sj.use_tlas
    assert st.use_tlas == (what in ("64 spheres", "two instances"))


@pytest.mark.parametrize("name", ["toybrick", "cube_field"])
def test_render_film_matches(name):
    """Renderer.render() at 32x24, 1 spp, of the port's own build against
    the JAX package's render of its build, from the same key."""
    w, h = 32, 24
    sj, cam, _rc, icfg = jex.build(name, width=w, height=h)
    st, ct, _rc2, _ic2 = tex.build(name, width=w, height=h, device="cpu")
    assert sj.use_tlas and st.use_tlas
    rj = JRenderer(sj, cam, JRenderConfig(width=w, height=h, spp=1), icfg)
    ref = rj.render(key=jax.random.PRNGKey(1))
    rt = Renderer(st, ct, RenderConfig(width=w, height=h, spp=1),
                  port_config(icfg))
    film = rt.render(key=rng.PRNGKey(1))
    assert_radiance_parity(film.mean.numpy().reshape(-1, 3),
                           np.asarray(ref.mean).reshape(-1, 3),
                           rt.rays_traced, rj.rays_traced)
    np.testing.assert_array_equal(film.n.numpy(), np.asarray(ref.n))


def _offset(x, nbytes=4):
    """A copy of x whose base lies `nbytes` past a 16-byte boundary."""
    step = x.element_size()
    buf = torch.empty(x.numel() + 16 // step, dtype=x.dtype, device=x.device)
    off = next(i for i in range(16 // step)
               if (buf.data_ptr() + step * i) % 16 == nbytes)
    view = buf[off:off + x.numel()].view(x.shape)
    view.copy_(x)
    return view


# (build fields, intersector, rows off a 16-byte boundary) -> the
# tlas_walk.cu instance the launcher picks
INSTANCES = {
    "wide": (dict(), "wide", False, (4, "float4", "float4")),
    "walk": (dict(), "walk", False, (0, "float2", "float4")),
    "wide8": (dict(wide_k=8), "wide", False, (8, "float4", "float4")),
    "wide leaf6": (dict(leaf_size=6), "wide", False, (4, "float4", "scalar")),
    "wide8 leaf6": (dict(wide_k=8, leaf_size=6), "wide", False,
                    (8, "float4", "scalar")),
    "walk leaf6": (dict(leaf_size=6), "walk", False, (0, "float2", "scalar")),
    "wide3": (dict(wide_k=3), "wide", False, (-1, "scalar", "scalar")),
    "misaligned": (dict(), "wide", True, (-1, "scalar", "scalar")),
}


def _instance_tables(name, device):
    fields, walk, offset, _want = INSTANCES[name]
    st = _mixed(tpt, tmesh, device=device, **fields)
    tabs = tint.scene_tlas(dataclasses.replace(st, intersector=walk))
    return tabs._replace(rows=_offset(tabs.rows)) if offset else tabs


@pytest.mark.parametrize("name", list(INSTANCES))
def test_launcher_picks_the_instance(name):
    """tlas_instance maps the tables to the tlas_walk.cu instance the
    wrappers launch: K = 4 and 8 over w_rows with float4 rows, binary
    u_rows with float2 rows, leaves in float4 loads at leaf 8 and scalar
    loads at leaf 6 (54 floats, not a 16-byte stride), the run-time-K
    instance (scalar loads) for another K or rows off a 16-byte boundary;
    the wrappers on those tables still equal the plain versions."""
    tabs = _instance_tables(name, "cpu")
    want = INSTANCES[name][3]
    assert tuple(traverse.tlas_instance(tabs)) == want
    assert tabs.leaf_size == INSTANCES[name][0].get("leaf_size", 8)
    org, d, t_cut, _l = _rays(seed=13, n=256)
    o, dd, tc = (torch.from_numpy(x) for x in (org, d, t_cut))
    tm = torch.full((256,), 1e9)
    got = traverse.closest_hit_tlas(tabs, o, dd, tm)
    want_hits = walks.closest_hit_tlas_plain(tabs, o, dd, tm)
    assert all(torch.equal(a, b) for a, b in zip(got, want_hits))
    assert torch.equal(traverse.any_hit_tlas(tabs, o, dd, tc),
                       walks.any_hit_tlas_plain(tabs, o, dd, tc))


@pytest.mark.parametrize("table", ["inst_inv", "sphere_inv", "cube_inv",
                                   "cyl_inv", "inst_range"])
def test_wrappers_reject_misaligned_tables(table):
    """The kernel reads each world->object affine with three float4 loads
    and each BLAS range as an int2: an affine table off a 16-byte boundary
    or a range table off an 8-byte one raises ValueError."""
    _sj, st = _builds(_mixed)
    tabs = tint.scene_tlas(st)
    tabs = tabs._replace(**{table: _offset(getattr(tabs, table))})
    org, d, t_cut, _l = _rays(seed=3, n=64)
    o, dd, tc = (torch.from_numpy(x) for x in (org, d, t_cut))
    for fn, t in ((traverse.closest_hit_tlas, torch.full((64,), 1e9)),
                  (traverse.any_hit_tlas, tc)):
        with pytest.raises(ValueError, match="byte boundary"):
            fn(tabs, o, dd, t)


@pytest.mark.cuda
@pytest.mark.parametrize("walk", list(INSTANCES))
def test_cuda_kernels_match_plain_versions(walk):
    """csrc/tlas_walk.cu against its plain versions on the card, for every
    compiled instance (INSTANCES): every output on every lane, the steps
    the kernel counts equal to the plain versions', the instance launched
    and the launch counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    dev = torch.device("cuda")
    tabs = _instance_tables(walk, dev)
    org, d, t_cut, _l = _rays(seed=11)
    o, dd, tc = (torch.from_numpy(x).to(dev) for x in (org, d, t_cut))
    tm = torch.full((N,), 1e9, device=dev)
    counts = [torch.zeros(2, dtype=torch.int64, device=dev)
              for _ in range(2)]
    traverse.reset_launch_counts()
    got = traverse.closest_hit_tlas(tabs, o, dd, tm, counts=counts[0])
    occ = traverse.any_hit_tlas(tabs, o, dd, tc, counts=counts[1])
    torch.cuda.synchronize()
    assert traverse.closest_hit_tlas.launches == 1
    assert traverse.any_hit_tlas.launches == 1
    for fn in (traverse.closest_hit_tlas, traverse.any_hit_tlas):
        assert tuple(fn.instance) == INSTANCES[walk][3]
    *want, steps = walks.closest_hit_tlas_plain(tabs, o, dd, tm,
                                                return_iters=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(counts[0][0]) == int(steps.sum())
    want_occ, steps = walks.any_hit_tlas_plain(tabs, o, dd, tc,
                                               return_iters=True)
    assert torch.equal(occ, want_occ)
    assert int(counts[1][0]) == int(steps.sum())
