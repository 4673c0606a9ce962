"""The XLA walks of the port (intersector "wide", "walk", "cluster")
against the JAX package's, on the CPU, where the kernel wrappers run
their plain versions.

  tables   SceneBuilder.build's u_rows, leaf_rows, w_rows, cluster
           tables, instance ranges and TLAS head sizes, byte-equal to the
           JAX build, for examples.bunny(subdivisions=3), a two-mesh
           scene with analytic objects and a transformed instance, and
           the cornell box (a TLAS head and no mesh), each intersector;
  walks    accel.traverse.traverse_packed and traverse_wide (K = 2, 4, 8)
           against the JAX functions on 1,000 rays, finite and scalar
           t_max, and their step helpers (unpack_bits, unpack_wide_bits,
           wide_child_step, leaf_intersect); traverse_packed's step
           counts against a per-ray loop; the MeshArrays walk;
           kernels.traverse.closest_hit_binary (plain) against
           pallas_traverse in interpret mode, with the tiles and the
           300-ray padding of tests/test_pallas_kernel.py;
  cluster  accel.cluster.intersect_clustered against the JAX function,
           with origins inside cluster boxes (tied scores), with k_cand
           small enough that the fallback walk resolves most rays, and on
           the one-cluster cube of tests/test_bvh.py;
  render   examples.bunny(32, 24, subdivisions=3) at 1 spp through both
           packages, each intersector (768 rays: no compaction engages);
  shadows  the K-wide any-hit over w_rows (any_hit_wide_rows_plain, the
           XLA intersectors' shadow walk) against traverse_wide bounded by
           t_cut, t < INF, on every lane of the bunny and dragon_hd
           (subdivision 3) and the two-mesh scene at K 4 and 8, on shadow
           rays formed as chip_smoke.py forms them (from the hit points of
           scattered rays toward the lights); occlusion_query on a "wide"
           scene against the JAX package's on the converted scene, on
           every lane; the leaf blocks' padding slots hold zero triangles
           in leaf_rows, the fat table and the split tables (the kernels
           test only a leaf's `count` slots); and the load width the row
           kernels take from the tables' geometry.

Tolerances: t within rtol 1e-5, atol 1e-5 on every lane and within 1e-6
on at least 99.5% of lanes (XLA contracts multiply-adds on the CPU; torch
rounds each operation, ROADMAP.md Queue 3); slots equal on every lane
except where two triangles tie within the t tolerance or the hit triangle
is grazing (|det| below 1e-3), where that rounding decides. Renders: the
tolerances of tests/test_torch_render.py. Shadows: equal on every lane.
The card-marked tests hold the three CUDA kernels against their plain
versions, the binary walk also at 17, 1,024 and 2^19 rays and on a
cluster-pattern chunk; they skip without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptsharp_tpu import examples as jex
from ptsharp_tpu.core import transform as jtransform
from ptsharp_tpu.accel import cluster as jcluster
from ptsharp_tpu.accel import traverse as jtraverse
from ptsharp_tpu import intersect as jintersect
from ptsharp_tpu.geometry import mesh as jmesh
from ptsharp_tpu.materials import diffuse_material as jdiffuse
from ptsharp_tpu.materials import light_material as jlight
from ptsharp_tpu.pallas.traverse_kernel import pallas_traverse
from ptsharp_tpu.renderer import RenderConfig as JRenderConfig
from ptsharp_tpu.renderer import Renderer as JRenderer
from ptsharp_tpu.scene import SceneBuilder as JBuilder

from ptsharp_tpu_torch import convert
from ptsharp_tpu_torch import examples as tex
from ptsharp_tpu_torch import intersect as tintersect
from ptsharp_tpu_torch.accel import cluster as tcluster
from ptsharp_tpu_torch.accel import traverse as ttraverse
from ptsharp_tpu_torch.accel.tables import split_fat
from ptsharp_tpu_torch.core import rng
from ptsharp_tpu_torch.geometry import mesh as tmesh
from ptsharp_tpu_torch.kernels import traverse
from ptsharp_tpu_torch.materials import diffuse_material as tdiffuse
from ptsharp_tpu_torch.materials import light_material as tlight
from ptsharp_tpu_torch.renderer import RenderConfig, Renderer
from ptsharp_tpu_torch.scene import SceneBuilder as TBuilder

from tests.test_torch_integrator import assert_radiance_parity, port_config
from tests.test_torch_kernels import CUDA_RAYS
from tests.torch_walk_cases import bounce_rays, shadow_cut

INTERSECTORS = ("wide", "walk", "cluster")
N = 1000
RTOL = ATOL = 1e-5
INF = 1e9


def _two_mesh(builder, mesh, diffuse, light, intersector, k=4, **kw):
    """Two meshes, a transformed instance of the second, a sphere light,
    a transformed cube and a cylinder: a TLAS head of six objects."""
    b = builder()
    b.add_mesh(mesh.sphere_mesh([0, 0.4, 0], 1.0, subdivisions=3),
               diffuse([0.5, 0.5, 0.5]))
    cube = b.add_mesh(mesh.cube_mesh([1.6, -0.3, -0.3], [2.2, 0.3, 0.3]),
                      diffuse([0.9, 0.6, 0.2]))
    xf = np.asarray(jtransform.translate([-3.4, 0.5, 0.2]), np.float32) \
        @ np.diag([1.0, 2.0, 1.0, 1.0]).astype(np.float32)
    b.add_mesh_instance(cube, transform=xf)
    b.add_sphere([0.5, 4.0, -1.0], 0.8, light([1, 1, 1], 10.0))
    b.add_cube([-0.4, -0.4, -0.4], [0.4, 0.4, 0.4], diffuse([0.3, 0.3, 0.3]),
               transform=np.asarray(jtransform.rotate([0, 1, 0], 0.6),
                                    np.float32))
    b.add_cylinder(0.3, -0.5, 0.5, diffuse([0.2, 0.6, 0.3]),
                   transform=np.asarray(jtransform.translate([-1.0, 0, -1.5]),
                                        np.float32))
    return b.build(leaf_size=8, intersector=intersector, wide_k=k,
                   use_tlas=False, **kw)


SCENES = {
    "bunny3": (lambda i: jex.bunny(32, 24, subdivisions=3, intersector=i)[0],
               lambda i: tex.bunny(32, 24, subdivisions=3, intersector=i,
                                   device="cpu")[0]),
    "two_mesh": (lambda i: _two_mesh(JBuilder, jmesh, jdiffuse, jlight, i),
                 lambda i: _two_mesh(TBuilder, tmesh, tdiffuse, tlight, i,
                                     device="cpu")),
    "cornell": (lambda i: _cornell(JBuilder, jdiffuse, jlight, i),
                lambda i: _cornell(TBuilder, tdiffuse, tlight, i,
                                   device="cpu")),
}


def _cornell(builder, diffuse, light, intersector, **kw):
    b = builder()
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse([0.7, 0.7, 0.7]))
    b.add_sphere([0, 4.85, 0], 1.0, light([1, 1, 1], 14.0))
    b.add_sphere([-0.9, 0.75, 0.6], 0.75, diffuse([0.9, 0.9, 0.9]))
    return b.build(intersector=intersector, **kw)


TABLES = ("u_rows", "leaf_rows", "w_rows", "cluster_bmin", "cluster_bmax",
          "cluster_rows")
RANGES = ("u_inst_base", "u_inst_end", "w_inst_base", "w_inst_end",
          "inst_cluster_base", "inst_cluster_end")


@pytest.mark.parametrize("intersector", INTERSECTORS)
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_xla_tables_byte_equal(scene, intersector):
    make_ref, make_port = SCENES[scene]
    sj, st = make_ref(intersector), make_port(intersector)
    for name in TABLES:
        a = getattr(st, name).numpy()
        b = np.asarray(getattr(sj, name))
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                      err_msg=name)
    for name in RANGES:
        assert getattr(st, name) == tuple(
            int(x) for x in np.asarray(getattr(sj, name))), name
    assert (st.tlas_end, st.w_tlas_end) == (sj.tlas_end, sj.w_tlas_end)
    assert st.tlas_end > 0
    if st.has_meshes:
        assert st.u_rows.shape[0] > st.tlas_end
        assert st.p_fat.shape[0] == 0 and st.intersector == intersector
    if intersector == "cluster" and st.has_meshes:
        assert st.cluster_rows.shape[0] > 0
    else:
        assert st.cluster_rows.shape[0] == 0


# ---- the walks -------------------------------------------------------------


def _rays(n, seed, center=(0.5, 0.3, 0.0)):
    g = np.random.default_rng(seed)
    org = g.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    tgt = g.uniform(-0.8, 0.8, (n, 3)).astype(np.float32) + center
    d = np.where(g.random((n, 1)) < 0.7, tgt - org,
                 g.normal(size=(n, 3))).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, d


@pytest.fixture(scope="module", params=[2, 4, 8])
def walk_case(request):
    k = request.param
    sj = _two_mesh(JBuilder, jmesh, jdiffuse, jlight, "walk", k=k)
    org, d = _rays(N, seed=k)
    g = np.random.default_rng(10 + k)
    t_max = np.where(g.random(N) < 0.1, -INF,
                     np.where(g.random(N) < 0.5, INF,
                              g.uniform(0.5, 4.0, N))).astype(np.float32)
    ranges = {name: tuple(int(x) for x in np.asarray(getattr(sj, name)))
              for name in RANGES}
    return dict(sj=sj, k=k, org=org, d=d, t_max=t_max, ranges=ranges,
                u_rows=torch.from_numpy(np.array(sj.u_rows)),
                w_rows=torch.from_numpy(np.array(sj.w_rows)),
                leaf=torch.from_numpy(np.array(sj.leaf_rows)))


def _assert_hits_match(got, ref, org, d, leaf, t_max, min_hit=0.2):
    """The module docstring's tolerance for (t, slot, u, v); at least
    `min_hit` of the lanes hit."""
    t, s, u, v = (x.numpy() for x in got)
    t_ref, s_ref, u_ref, v_ref = (np.asarray(x) for x in ref)
    np.testing.assert_allclose(t, t_ref, rtol=RTOL, atol=ATOL)
    assert np.isclose(t, t_ref, rtol=1e-6, atol=1e-6).mean() >= 0.995
    hit = t_ref < 1e8
    assert np.array_equal(s >= 0, s_ref >= 0)
    tri = leaf.reshape(-1, 9)
    diff = np.nonzero(s != s_ref)[0]
    if diff.size:
        o, dd = torch.from_numpy(org[diff]), torch.from_numpy(d[diff])
        all_tri = tri[None].expand(diff.size, -1, -1)
        ok, tt, _u, _v = ttraverse.mt(all_tri, o, dd)
        tm = torch.as_tensor(t_max, dtype=torch.float32).expand(N)[diff]
        tt = torch.where(ok & (tt < tm[:, None]), tt, 1e30)
        two = torch.topk(tt, 2, dim=1, largest=False).values.numpy()
        tie = two[:, 1] - two[:, 0] <= ATOL + RTOL * np.abs(two[:, 0])
        e1, e2 = tri[s[diff], 3:6], tri[s[diff], 6:9]
        det = torch.sum(e1 * torch.cross(dd, e2, dim=1), dim=1).abs()
        graze = det.numpy() < 1e-3
        assert (tie | graze).all(), diff[~(tie | graze)]
    same = hit & (s == s_ref)
    np.testing.assert_allclose(u[same], u_ref[same], atol=1e-4)
    np.testing.assert_allclose(v[same], v_ref[same], atol=1e-4)
    assert (s[~hit] == -1).all() and (t[~hit] == INF).all()
    assert hit.mean() > min_hit


@pytest.mark.parametrize("bound", ["finite", "scalar"])
def test_traverse_packed_matches_jax(walk_case, bound):
    c = walk_case
    tm = c["t_max"] if bound == "finite" else 3.0
    for i in range(c["sj"].inst_inv.shape[0]):
        base, end = c["ranges"]["u_inst_base"][i], c["ranges"]["u_inst_end"][i]
        ref = jtraverse.traverse_packed(
            c["sj"].u_rows, c["sj"].leaf_rows, jnp.asarray(c["org"]),
            jnp.asarray(c["d"]), jnp.asarray(tm), base, end, 8)
        got = ttraverse.traverse_packed(
            c["u_rows"], c["leaf"], torch.from_numpy(c["org"]),
            torch.from_numpy(c["d"]), torch.as_tensor(tm), base, end, 8)
        _assert_hits_match(got, ref, c["org"], c["d"], c["leaf"], tm,
                           0.2 if i == 0 else 0.005)


@pytest.mark.parametrize("bound", ["finite", "scalar"])
def test_traverse_wide_matches_jax(walk_case, bound):
    c = walk_case
    tm = c["t_max"] if bound == "finite" else 3.0
    for i in range(c["sj"].inst_inv.shape[0]):
        base, end = c["ranges"]["w_inst_base"][i], c["ranges"]["w_inst_end"][i]
        ref = jtraverse.traverse_wide_chunked(
            c["sj"].w_rows, c["sj"].leaf_rows, jnp.asarray(c["org"]),
            jnp.asarray(c["d"]), jnp.asarray(tm), base, end, 8, c["k"],
            chunk=256)
        got = ttraverse.traverse_wide_chunked(
            c["w_rows"], c["leaf"], torch.from_numpy(c["org"]),
            torch.from_numpy(c["d"]), tm, base, end, 8, c["k"], chunk=256)
        _assert_hits_match(got, ref, c["org"], c["d"], c["leaf"], tm,
                           0.2 if i == 0 else 0.005)


@pytest.mark.parametrize("helper", ["unpack_bits", "unpack_wide_bits",
                                    "wide_child_step", "leaf_intersect"])
def test_row_helpers_match_jax(walk_case, helper):
    """The ported step helpers of accel/traverse.py, on the scene's rows
    and the rays of the walk tests."""
    c = walk_case
    sj, k = c["sj"], c["k"]
    if helper == "unpack_bits":
        got, ref = (ttraverse.unpack_bits(c["u_rows"]),
                    jtraverse.unpack_bits(sj.u_rows))
    elif helper == "unpack_wide_bits":
        got, ref = (ttraverse.unpack_wide_bits(c["w_rows"], k),
                    jtraverse.unpack_wide_bits(sj.w_rows, k))
    if helper.startswith("unpack"):
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        return
    g = np.random.default_rng(k)
    org, d = c["org"], c["d"]
    bt = np.where(c["t_max"] < 0, INF, c["t_max"]).astype(np.float32)
    if helper == "wide_child_step":
        # internal rows of the first mesh's tree
        first, _kind, count, skip, cidx = jtraverse.unpack_wide_bits(
            sj.w_rows, k)
        inner = np.nonzero(np.asarray(count) == 0)[0]
        rows = g.choice(inner, N)
        nrow = np.asarray(sj.w_rows)[rows]
        inv = 1.0 / np.where(np.abs(d) < 1e-30,
                             np.where(d < 0, -1e-30, 1e-30), d)
        inv = inv.astype(np.float32)
        ref = jtraverse.wide_child_step(
            jnp.asarray(nrow), k, jnp.asarray(org), jnp.asarray(inv),
            jnp.asarray(bt), jnp.asarray(np.asarray(cidx)[rows]),
            jnp.asarray(np.asarray(skip)[rows]))
        got = ttraverse.wide_child_step(
            torch.from_numpy(nrow), k, torch.from_numpy(org),
            torch.from_numpy(inv), torch.from_numpy(bt),
            torch.from_numpy(np.asarray(cidx)[rows]),
            torch.from_numpy(np.asarray(skip)[rows]))
        assert np.asarray(ref[1]).mean() > 0.05
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        return
    blk = g.integers(0, c["leaf"].shape[0], N)
    active = g.random(N) < 0.9
    # each ray from in front of its block's first triangle toward a point
    # inside it (padding blocks keep the walk tests' origins)
    tri = np.asarray(sj.leaf_rows)[blk, :9]
    tgt = tri[:, 0:3] + 0.3 * tri[:, 3:6] + 0.3 * tri[:, 6:9]
    nrm = np.cross(tri[:, 3:6], tri[:, 6:9])
    size = np.linalg.norm(nrm, axis=1, keepdims=True)
    org = np.where(size > 0, tgt + nrm / np.maximum(size, 1e-30)
                   * g.uniform(0.5, 2.0, (N, 1)) + g.normal(0, 0.05, (N, 3)),
                   org).astype(np.float32)
    d = tgt - org
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    ref = jtraverse.leaf_intersect(sj.leaf_rows, jnp.asarray(blk),
                                   jnp.asarray(org), jnp.asarray(d),
                                   jnp.asarray(bt), 8, jnp.asarray(active))
    got = ttraverse.leaf_intersect(c["leaf"], torch.from_numpy(blk),
                                   torch.from_numpy(org), torch.from_numpy(d),
                                   torch.from_numpy(bt), 8,
                                   torch.from_numpy(active))

    def as_hits(t, lane, u, v):
        t = torch.as_tensor(np.array(t))
        slot = np.where(np.asarray(t) < INF, blk * 8 + np.asarray(lane), -1)
        return (t, torch.as_tensor(slot), torch.as_tensor(np.array(u)),
                torch.as_tensor(np.array(v)))

    _assert_hits_match(as_hits(*got), as_hits(*ref), org, d, c["leaf"], bt)


def test_wrappers_take_their_plain_versions_on_the_cpu(walk_case):
    """On CPU tensors each wrapper returns its plain version's result,
    bit for bit, and launches nothing."""
    c = walk_case
    org, d = torch.from_numpy(c["org"]), torch.from_numpy(c["d"])
    tm = torch.from_numpy(c["t_max"])
    r = c["ranges"]
    traverse.reset_launch_counts()
    got = traverse.closest_hit_binary(c["u_rows"], c["leaf"], org, d, tm,
                                      r["u_inst_base"][0], r["u_inst_end"][0],
                                      8)
    want = ttraverse.traverse_packed(c["u_rows"], c["leaf"], org, d, tm,
                                     r["u_inst_base"][0], r["u_inst_end"][0],
                                     8)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = traverse.closest_hit_wide_rows(
        c["w_rows"], c["leaf"], org, d, tm, r["w_inst_base"][0],
        r["w_inst_end"][0], 8, c["k"])
    want = ttraverse.traverse_wide(c["w_rows"], c["leaf"], org, d, tm,
                                   r["w_inst_base"][0], r["w_inst_end"][0],
                                   8, c["k"])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    t_cut = torch.where(tm > INF / 2, torch.full_like(tm, 3.0), tm)
    occ = traverse.any_hit_wide_rows(c["w_rows"], c["leaf"], org, d, t_cut,
                                     r["w_inst_base"][0], r["w_inst_end"][0],
                                     8, c["k"])
    want_occ = ttraverse.any_hit_wide_rows_plain(
        c["w_rows"], c["leaf"], org, d, t_cut, r["w_inst_base"][0],
        r["w_inst_end"][0], 8, c["k"])
    assert occ.dtype == torch.bool and torch.equal(occ, want_occ)
    assert 0 < int(occ.sum()) < occ.shape[0]
    assert traverse.closest_hit_binary.launches == 0
    assert traverse.closest_hit_wide_rows.launches == 0
    assert traverse.any_hit_wide_rows.launches == 0
    # the binary walk and the K-wide walk find the same hits
    tb = traverse.closest_hit_binary(c["u_rows"], c["leaf"], org, d, tm,
                                     r["u_inst_base"][0], r["u_inst_end"][0],
                                     8)[0]
    np.testing.assert_array_equal(tb.numpy(), got[0].numpy())


def test_row_wrappers_take_no_counts_on_the_cpu(walk_case):
    """`counts` is the kernels' own count: on CPU tensors the persistent
    row wrappers raise on it (the plain versions give each ray's steps,
    return_iters)."""
    c = walk_case
    org, d = torch.from_numpy(c["org"]), torch.from_numpy(c["d"])
    tm = torch.from_numpy(c["t_max"])
    r = c["ranges"]
    args = (r["w_inst_base"][0], r["w_inst_end"][0], 8, c["k"])
    counts = torch.zeros(2, dtype=torch.int64)
    for wrapper in (traverse.closest_hit_wide_rows,
                    traverse.any_hit_wide_rows):
        with pytest.raises(ValueError, match="counts"):
            wrapper(c["w_rows"], c["leaf"], org, d, tm, *args, counts=counts)
    t, _s, _u, _v, steps = ttraverse.traverse_wide(
        c["w_rows"], c["leaf"], org, d, tm, *args, return_iters=True)
    assert torch.equal(t, ttraverse.traverse_wide(c["w_rows"], c["leaf"], org,
                                                  d, tm, *args)[0])
    occ, any_steps = ttraverse.any_hit_wide_rows_plain(
        c["w_rows"], c["leaf"], org, d, tm, *args, return_iters=True)
    assert int(steps.min()) >= 1 and int(steps.max()) <= args[1] - args[0]
    assert (any_steps[tm <= 0] == 0).all() and (any_steps <= steps).all()


def _scalar_binary_steps(u_rows, leaf, org, d, t_max, base, end, ls):
    """Each ray's steps by a per-ray loop of the binary skip-link walk:
    own box against the best t, j + 1 at a hit internal node, MT over the
    leaf's slots (strict tt < best t) and the skip link at a hit leaf, the
    skip link where the box is missed."""
    bits = u_rows.view(torch.int32)
    inv = ttraverse.safe_inv(d)
    steps = []
    for i in range(org.shape[0]):
        o, iv, bt = org[i:i + 1], inv[i:i + 1], t_max[i:i + 1].clone()
        cur, n = base, 0
        while cur < end:
            n += 1
            tmin, tmax = ttraverse.slab(u_rows[cur:cur + 1, 0:6], o, iv)
            skip = int(bits[cur, 8])
            if not bool(ttraverse.box_hit(tmin, tmax, bt)):
                cur = skip
            elif int(bits[cur, 7]) & 0xFF == 0:
                cur += 1
            else:
                blk = leaf[int(bits[cur, 6]) // ls, :ls * 9].reshape(1, ls, 9)
                ok, tt, _u, _v = ttraverse.mt(blk, o, d[i:i + 1])
                tt = torch.where(ok & (tt < bt[:, None]), tt, bt[:, None])
                bt = tt.min(dim=1).values
                cur = skip
        steps.append(n)
    return torch.tensor(steps, dtype=torch.int32)


def test_traverse_packed_counts_its_steps(walk_case):
    """traverse_packed(return_iters=True) changes no output; its steps
    (the steps closest_hit_binary's kernel counts) are a per-ray loop's,
    and a ray at t_max = -INF takes one step, the root's box test."""
    c = walk_case
    org, d = torch.from_numpy(c["org"]), torch.from_numpy(c["d"])
    tm = torch.from_numpy(c["t_max"])
    r = c["ranges"]
    args = (r["u_inst_base"][0], r["u_inst_end"][0], 8)
    *out, steps = ttraverse.traverse_packed(c["u_rows"], c["leaf"], org, d, tm,
                                            *args, return_iters=True)
    want = ttraverse.traverse_packed(c["u_rows"], c["leaf"], org, d, tm, *args)
    assert all(torch.equal(a, b) for a, b in zip(out, want))
    assert steps.dtype == torch.int32
    np.testing.assert_array_equal(steps[tm == -INF].numpy(), 1)
    assert float(steps.float().mean()) > 5
    few = slice(0, 200)
    np.testing.assert_array_equal(
        steps[few].numpy(),
        _scalar_binary_steps(c["u_rows"], c["leaf"], org[few], d[few],
                             tm[few], *args).numpy())


def test_binary_walk_takes_no_counts_on_the_cpu(walk_case):
    """`counts` is the kernel's own count: on CPU tensors closest_hit_binary
    raises on it, as the persistent row wrappers do."""
    c = walk_case
    org, d = torch.from_numpy(c["org"]), torch.from_numpy(c["d"])
    tm = torch.from_numpy(c["t_max"])
    r = c["ranges"]
    with pytest.raises(ValueError, match="counts"):
        traverse.closest_hit_binary(c["u_rows"], c["leaf"], org, d, tm,
                                    r["u_inst_base"][0], r["u_inst_end"][0], 8,
                                    counts=torch.zeros(2, dtype=torch.int64))


def test_row_wrappers_check_their_tables(walk_case):
    c = walk_case
    org, d = torch.from_numpy(c["org"]), torch.from_numpy(c["d"])
    tm = torch.from_numpy(c["t_max"])
    with pytest.raises(ValueError, match="columns"):
        traverse.closest_hit_wide_rows(c["u_rows"], c["leaf"], org, d, tm, 0,
                                       1, 8, c["k"])
    with pytest.raises(ValueError, match="node range"):
        traverse.closest_hit_binary(c["u_rows"], c["leaf"], org, d, tm, 0,
                                    c["u_rows"].shape[0] + 1, 8)
    with pytest.raises(ValueError, match="no kernel"):
        traverse.closest_hit_binary(c["u_rows"].to("meta"),
                                    c["leaf"].to("meta"), org.to("meta"),
                                    d.to("meta"), tm.to("meta"), 0, 1, 8)


def test_mesh_arrays_traverse_matches_jax():
    """The MeshArrays walk (tests/test_bvh.py's), on a sphere mesh."""
    from ptsharp_tpu.accel import bvh as jbvh

    m = jmesh.sphere_mesh([0, 0.3, 0], 1.0, subdivisions=3)
    v = m.v
    lo = np.minimum(np.minimum(v[:, 0], v[:, 1]), v[:, 2])
    hi = np.maximum(np.maximum(v[:, 0], v[:, 1]), v[:, 2])
    flat = jbvh.build(lo, hi, leaf_size=4)
    sv = np.concatenate([v[flat.order], np.zeros((4, 3, 3), np.float32)])
    arrays = dict(node_bmin=flat.bmin, node_bmax=flat.bmax,
                  node_first=flat.first, node_count=flat.count,
                  node_skip=flat.skip, v0=sv[:, 0], e1=sv[:, 1] - sv[:, 0],
                  e2=sv[:, 2] - sv[:, 0])
    ja = jtraverse.MeshArrays(**{k: jnp.asarray(x) for k, x in arrays.items()},
                              max_leaf=4)
    ta = ttraverse.MeshArrays(**{k: torch.from_numpy(np.array(x))
                                 for k, x in arrays.items()}, max_leaf=4)
    org, d = _rays(512, seed=21, center=(0, 0.3, 0))
    n = flat.bmin.shape[0]
    ref = jtraverse.traverse(ja, jnp.asarray(org), jnp.asarray(d), INF, 0, n)
    got = ttraverse.traverse(ta, torch.from_numpy(org), torch.from_numpy(d),
                             INF, 0, n)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=RTOL,
                               atol=ATOL)
    hit = np.asarray(ref[0]) < 1e8
    assert hit.mean() > 0.2
    assert (got[1].numpy() == np.asarray(ref[1])).mean() >= 0.995


# ---- TPU kernel #14: pallas_traverse ----------------------------------------


def _sphere_walk_scene():
    b = JBuilder()
    b.add_mesh(jmesh.sphere_mesh([0, 0.4, 0], 1.0, subdivisions=2),
               jdiffuse([0.5, 0.5, 0.5]))
    return b.build(leaf_size=8, intersector="walk")


@pytest.mark.parametrize("n, tile, t_max", [(512, 256, INF), (300, 256, 2.0)],
                         ids=["tiles", "padded"])
def test_closest_hit_binary_matches_pallas_traverse(n, tile, t_max):
    """pallas_traverse (interpret mode) walks a tile with one cursor; the
    port's per-ray walk gives each lane its slot."""
    sj = _sphere_walk_scene()
    base, end = int(sj.u_inst_base[0]), int(sj.u_inst_end[0])
    g = np.random.default_rng(n)
    org = g.uniform(-2, 2, (n, 3)).astype(np.float32)
    tgt = g.uniform(-0.8, 0.8, (n, 3)).astype(np.float32) + [0, 0.4, 0]
    d = np.where(g.random((n, 1)) < 0.5, tgt - org,
                 g.normal(size=(n, 3))).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ref = pallas_traverse(sj.u_rows, sj.leaf_rows, jnp.asarray(org),
                          jnp.asarray(d), t_max, base, end, 8, tile=tile,
                          interpret=True)
    got = traverse.closest_hit_binary(
        torch.from_numpy(np.array(sj.u_rows)),
        torch.from_numpy(np.array(sj.leaf_rows)), torch.from_numpy(org),
        torch.from_numpy(d), torch.full((n,), t_max), base, end, 8)
    t_ref, s_ref = np.asarray(ref[0]), np.asarray(ref[1])
    np.testing.assert_allclose(got[0].numpy(), t_ref, rtol=RTOL, atol=ATOL)
    hit = t_ref < 1e8
    assert hit.sum() > 30
    np.testing.assert_array_equal(got[1].numpy()[hit], s_ref[hit])
    np.testing.assert_allclose(got[2].numpy()[hit], np.asarray(ref[2])[hit],
                               atol=1e-4)
    assert (got[1].numpy()[~hit] == -1).all()


# ---- the cluster intersector -----------------------------------------------


@pytest.fixture(scope="module")
def cluster_case():
    b = JBuilder()
    b.add_mesh(jex._bunny_mesh(4), jdiffuse([0.5, 0.5, 0.5]))
    sj = b.build(leaf_size=8, intersector="cluster")
    arrays = [sj.cluster_bmin, sj.cluster_bmax, sj.cluster_rows,
              sj.cluster_rows.shape[1] // 9, int(sj.inst_cluster_base[0]),
              int(sj.inst_cluster_end[0]), sj.u_rows, sj.leaf_rows,
              int(sj.u_inst_base[0]), int(sj.u_inst_end[0]), 8]
    port = [torch.from_numpy(np.array(a)) if hasattr(a, "shape") else a
            for a in arrays]
    # half the origins inside the mesh's box, where several cluster boxes
    # hold them and their scores tie at 0
    g = np.random.default_rng(7)
    lo = np.asarray(sj.cluster_bmin).min(0)
    hi = np.asarray(sj.cluster_bmax).max(0)
    inside = g.uniform(lo, hi, (N // 2, 3))
    outside = g.uniform(-3, 3, (N - N // 2, 3))
    org = np.concatenate([inside, outside]).astype(np.float32)
    d = g.normal(size=(N, 3)).astype(np.float32)
    aim = g.random(N) < 0.5
    d[aim] = (g.uniform(lo, hi, (int(aim.sum()), 3)) - org[aim])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return dict(sj=sj, arrays=arrays, port=port, org=org, d=d,
                leaf=torch.from_numpy(np.array(sj.leaf_rows)))


@pytest.mark.parametrize("k_cand, chunk", [(12, 8192), (2, 256)],
                         ids=["default", "fallback_chunked"])
def test_intersect_clustered_matches_jax(cluster_case, k_cand, chunk):
    c = cluster_case
    assert c["sj"].cluster_bmin.shape[0] > 12
    ref = jcluster.intersect_clustered(
        tuple(c["arrays"]), jnp.asarray(c["org"]), jnp.asarray(c["d"]), INF,
        k_cand=k_cand, chunk=chunk)
    traverse.reset_launch_counts()
    got = tcluster.intersect_clustered(
        tuple(c["port"]), torch.from_numpy(c["org"]),
        torch.from_numpy(c["d"]), INF, k_cand=k_cand, chunk=chunk)
    _assert_hits_match(got, ref, c["org"], c["d"], c["leaf"], INF)


def test_cluster_scores_tie(cluster_case):
    """The cull's candidates among tied scores: lower cluster index first,
    as lax.top_k orders them, on rays that tie."""
    c = cluster_case
    o, d = torch.from_numpy(c["org"]), torch.from_numpy(c["d"])
    bmin, bmax = c["port"][0], c["port"][1]
    inv = ttraverse.safe_inv(d)
    tmin, tmax = ttraverse.slab(torch.cat([bmin, bmax], 1)[None],
                                o[:, None, :], inv[:, None, :])
    zero_ties = ((tmin <= 0) & (tmax >= 0)).sum(1)
    assert (zero_ties >= 2).sum() > 50
    _t, cand = torch.sort(torch.where(tmax >= tmin.clamp(min=0),
                                      tmin.clamp(min=0), INF), dim=1,
                          stable=True)
    _v, jcand = jax.lax.top_k(-jnp.asarray(np.where(
        (tmax >= tmin.clamp(min=0)).numpy(), tmin.clamp(min=0).numpy(), INF)),
        12)
    np.testing.assert_array_equal(cand[:, :12].numpy(), np.asarray(jcand))


def test_cluster_one_cluster_scene():
    """tests/test_bvh.py's regression: one cluster, fewer than k_cand."""
    from ptsharp_tpu_torch.intersect import closest_hit

    b = TBuilder()
    b.add_mesh(tmesh.cube_mesh([-1, -1, -1], [1, 1, 1]),
               tdiffuse([1, 0, 0]))
    st = b.build(leaf_size=4, intersector="cluster", device="cpu")
    assert st.cluster_bmin.shape[0] == 1
    hit = closest_hit(st, torch.tensor([[0, 0, -5.0]]),
                      torch.tensor([[0, 0, 1.0]]))
    np.testing.assert_allclose(float(hit.t[0]), 4.0, rtol=1e-4)


# ---- renders -----------------------------------------------------------------


@pytest.mark.parametrize("intersector", INTERSECTORS)
def test_bunny_render_matches_jax(intersector):
    w, h = 32, 24
    sj, cam, _rc, icfg = jex.bunny(w, h, subdivisions=3,
                                   intersector=intersector)
    rj = JRenderer(sj, cam, JRenderConfig(width=w, height=h, spp=1), icfg)
    ref = rj.render(key=jax.random.PRNGKey(1))
    st, ct, _rc, icft = tex.bunny(w, h, subdivisions=3,
                                  intersector=intersector, device="cpu")
    assert st.intersector == intersector and st.max_leaf == 8
    rt = Renderer(st, ct, RenderConfig(width=w, height=h, spp=1),
                  port_config(icft))
    film = rt.render(key=rng.PRNGKey(1))
    assert_radiance_parity(film.mean.numpy().reshape(-1, 3),
                           np.asarray(ref.mean).reshape(-1, 3),
                           rt.rays_traced, rj.rays_traced)
    np.testing.assert_array_equal(film.n.numpy(), np.asarray(ref.n))


def test_default_bunny_is_the_wide_walk():
    """examples.bunny() with its defaults builds the "wide" scene at leaf 8
    (here on the CPU, at a small size)."""
    st = tex.bunny(8, 6, subdivisions=2, device="cpu")[0]
    assert (st.intersector, st.max_leaf, st.wide_k) == ("wide", 8, 4)
    assert st.w_rows.shape[1] == 40 and st.leaf_rows.shape[1] == 72


# ---- on the card -------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_row_kernels_match_plain_versions(walk_case):
    """Runs on a machine with a card: the three row-table kernels against
    their plain versions on the same inputs, every lane and the step
    counts equal, and their launch counts; K=2 has no kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    c = walk_case
    dev = torch.device("cuda")
    org, d = (torch.from_numpy(x).to(dev) for x in (c["org"], c["d"]))
    tm = torch.from_numpy(c["t_max"]).to(dev)
    u_rows, w_rows, leaf = (c[x].to(dev) for x in ("u_rows", "w_rows",
                                                   "leaf"))
    r = c["ranges"]
    ub, ue = r["u_inst_base"][0], r["u_inst_end"][0]
    wb, we = r["w_inst_base"][0], r["w_inst_end"][0]
    traverse.reset_launch_counts()
    got = traverse.closest_hit_binary(u_rows, leaf, org, d, tm, ub, ue, 8)
    want = ttraverse.traverse_packed(u_rows, leaf, org, d, tm, ub, ue, 8)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert traverse.closest_hit_binary.launches == 1
    if c["k"] not in traverse.KERNEL_K:
        with pytest.raises(ValueError):
            traverse.closest_hit_wide_rows(w_rows, leaf, org, d, tm, wb, we,
                                           8, c["k"])
        return
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    got = traverse.closest_hit_wide_rows(w_rows, leaf, org, d, tm, wb, we, 8,
                                         c["k"], counts=counts)
    *want, steps = ttraverse.traverse_wide(w_rows, leaf, org, d, tm, wb, we,
                                           8, c["k"], return_iters=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(counts[0]) == int(steps.sum())
    assert traverse.closest_hit_wide_rows.launches == 1
    counts.zero_()
    occ = traverse.any_hit_wide_rows(w_rows, leaf, org, d, tm, wb, we, 8,
                                     c["k"], counts=counts)
    want, steps = ttraverse.any_hit_wide_rows_plain(
        w_rows, leaf, org, d, tm, wb, we, 8, c["k"], return_iters=True)
    assert torch.equal(occ, want) and int(counts[0]) == int(steps.sum())
    assert traverse.any_hit_wide_rows.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("n", [*CUDA_RAYS, "chunk"])
def test_cuda_binary_walk_matches_plain_version(walk_case, n):
    """Runs on a machine with a card: the persistent binary walk (#14)
    against traverse_packed on the walk tests' rays repeated or cut to n
    (fewer than a warp; about a thousand; more than the persistent grid
    holds at once), and on a cluster-pattern chunk of 8,192 rays with all
    but about 5% at t_max = -INF, as intersect_clustered sends its
    resolved rays: every output on every lane, and the kernel's step count
    equal to the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    c = walk_case
    dev = torch.device("cuda")
    m = 8192 if n == "chunk" else n
    rep = -(-m // N)
    org, d, tm = (torch.from_numpy(x).repeat(rep, *([1] * (x.ndim - 1)))[:m]
                  .contiguous().to(dev)
                  for x in (c["org"], c["d"], c["t_max"]))
    if n == "chunk":
        g = np.random.default_rng(3)
        live = torch.from_numpy(g.random(m) < 0.05).to(dev)
        tm = torch.where(live, tm, torch.full_like(tm, -INF)).contiguous()
    u_rows, leaf = c["u_rows"].to(dev), c["leaf"].to(dev)
    r = c["ranges"]
    args = (r["u_inst_base"][0], r["u_inst_end"][0], 8)
    traverse.reset_launch_counts()
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    got = traverse.closest_hit_binary(u_rows, leaf, org, d, tm, *args,
                                      counts=counts)
    *want, steps = ttraverse.traverse_packed(u_rows, leaf, org, d, tm, *args,
                                             return_iters=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(counts[0]) == int(steps.sum()) <= int(counts[1])
    assert traverse.closest_hit_binary.launches == 1


# ---- the K-wide any-hit ------------------------------------------------------


SHADOW_SCENES = {
    "bunny3": lambda k: tex.bunny(32, 24, subdivisions=3, intersector="wide",
                                  wide_k=k, device="cpu")[0],
    "dragon_hd3": lambda k: tex.dragon_hd(30, 17, subdivisions=3,
                                          intersector="wide", wide_k=k,
                                          device="cpu")[0],
    "two_mesh": lambda k: _two_mesh(TBuilder, tmesh, tdiffuse, tlight,
                                    "wide", k=k, device="cpu"),
}


def _shadow_rays(st, seed):
    """N shadow rays as chip_smoke.py's kernel phases form them: from the
    hit points of scattered rays (bounce_rays) toward the scene's lights,
    t_cut as sample_lights forms it (shadow_cut; -INF where the light is
    missed), and every tenth lane's t_cut -INF, as occlusion_query bounds
    a lane that an earlier object already occludes."""
    org, d = _rays(N, seed)
    o, _d = bounce_rays(st, torch.from_numpy(org), torch.from_numpy(d), N,
                        seed)
    ds, t_cut = shadow_cut(st, o, seed)
    t_cut[::10] = -INF
    return o, ds, t_cut


@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("scene", sorted(SHADOW_SCENES))
def test_any_hit_wide_rows_equals_the_bounded_closest_hit(scene, k):
    """The route of the XLA intersectors' shadow rays: the any-hit over
    w_rows gives the boolean the JAX package takes from the closest-hit
    bounded by t_cut (t < INF), on every lane of every instance."""
    st = SHADOW_SCENES[scene](k)
    assert st.intersector == "wide" and st.wide_k == k
    o, d, t_cut = _shadow_rays(st, seed=k)
    assert (t_cut <= INF).all() and 0 < int((t_cut > 0).sum()) < N
    tab = (st.w_rows, st.leaf_rows)
    occluded = torch.zeros(N, dtype=torch.bool)
    for i in range(st.inst_inv.shape[0]):
        oi, di = tintersect._instance_rays(st, i, o, d)
        args = (st.w_inst_base[i], st.w_inst_end[i], st.max_leaf, k)
        occ = ttraverse.any_hit_wide_rows_plain(*tab, oi, di, t_cut, *args)
        t = ttraverse.traverse_wide(*tab, oi, di, t_cut, *args)[0]
        np.testing.assert_array_equal(occ.numpy(), (t < INF).numpy())
        occluded |= occ
    assert 0 < int(occluded.sum()) < int((t_cut > 0).sum())


@pytest.mark.parametrize("scene", ["bunny3", "two_mesh"])
def test_occlusion_query_wide_matches_jax(scene):
    """occlusion_query on a "wide" scene (the any-hit over w_rows per
    instance) against the JAX package's on the same scene (its bounded
    closest-hit), converted with convert.scene_from_reference."""
    sj = SCENES[scene][0]("wide")
    st = convert.scene_from_reference(*convert.reference_arrays(sj),
                                       device="cpu")
    assert st.intersector == "wide"
    o, d, t_cut = _shadow_rays(st, seed=5)
    ref = jax.jit(lambda a, b, c: jintersect.occlusion_query(sj, a, b, c))(
        *(jnp.asarray(x.numpy()) for x in (o, d, t_cut)))
    traverse.reset_launch_counts()
    occ = tintersect.occlusion_query(st, o, d, t_cut)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(ref))
    assert 0.02 < float(occ.float().mean()) < 0.98
    assert all(w.launches == 0 for w in traverse.WRAPPERS)


@pytest.mark.parametrize("tables", ["wide", "pallas", "split"])
def test_leaf_padding_slots_are_zero_triangles(tables):
    """The persistent kernels run Moller-Trumbore on a leaf's first
    `count` slots only; the plain walks on all of them. They agree because
    every slot past `count` holds a zero triangle, which MT rejects
    (det = 0): in leaf_rows (the binary and K-wide walks' leaf blocks), in
    the fat table's leaf rows and in the split tables' leaf rows."""
    intersector = "wide" if tables == "wide" else "pallas"
    st = tex.bunny(16, 12, subdivisions=3, intersector=intersector,
                   wide_k=4 if intersector == "wide" else 8, device="cpu")[0]
    ls = st.max_leaf
    if tables == "wide":
        # the mesh's rows: the TLAS head's leaves index objects, not slots
        bits = st.w_rows[st.w_inst_base[0]:st.w_inst_end[0]].view(torch.int32)
        leaf = (bits[:, 7] & 0xFF) > 0
        count = (bits[leaf, 7] & 0xFF).long()
        blocks = st.leaf_rows[bits[leaf, 6].long() // ls]
    elif tables == "split":
        rows, leaf_tab = map(torch.from_numpy, split_fat(st.p_fat.numpy(), ls))
        bits = rows.view(torch.int32)
        leaf = (bits[:, 7] & 0xFF) > 0
        count = (bits[leaf, 7] & 0xFF).long()
        blocks = leaf_tab[bits[leaf, 6].long() // ls]
    else:
        bits = st.p_fat[0::2].view(torch.int32)
        leaf = (bits[:, 7] & 0xFF) > 0
        count = (bits[leaf, 7] & 0xFF).long()
        blocks = st.p_fat[1::2][leaf]
    assert int(leaf.sum()) > 10 and int((count < ls).sum()) > 0
    tri = blocks[:, :ls * 9].reshape(-1, ls, 9)
    pad = torch.arange(ls)[None, :] >= count[:, None]
    assert (tri[pad] == 0).all() and (tri[~pad].abs().sum(1) > 0).all()
    ok, _t, _u, _v = ttraverse.mt(torch.zeros(1, 1, 9),
                                  torch.tensor([[0.1, 0.2, -1.0]]),
                                  torch.tensor([[0.0, 0.0, 1.0]]))
    assert not bool(ok.any())


def test_row_loads_follow_the_tables_geometry():
    """The row kernels take float4 loads where their tables are 16-byte
    strides from 16-byte aligned bases (the default "wide" build: w_rows
    of 40 floats, leaf_rows of 72), scalar loads otherwise; the binary
    walk asks of leaf_rows alone (it reads u_rows, 10 floats, with float2
    loads)."""
    st = tex.bunny(8, 6, subdivisions=2, device="cpu")[0]
    assert traverse.row_loads(st.w_rows, st.leaf_rows) == "float4"
    assert traverse.row_loads(st.u_rows, st.leaf_rows) == "scalar"
    assert traverse.row_loads(st.leaf_rows) == "float4"
    leaf6 = TBuilder()
    leaf6.add_mesh(tmesh.sphere_mesh([0, 0, 0], 1.0, subdivisions=2),
                   tdiffuse([0.5, 0.5, 0.5]))
    s6 = leaf6.build(leaf_size=6, intersector="wide", wide_k=4, device="cpu")
    assert s6.leaf_rows.shape[1] == 54
    assert traverse.row_loads(s6.w_rows, s6.leaf_rows) == "scalar"
    assert traverse.row_loads(s6.leaf_rows) == "scalar"
    shifted = torch.zeros(st.w_rows.numel() + 1)[1:].view(st.w_rows.shape)
    assert traverse.row_loads(shifted, st.leaf_rows) == "scalar"
