"""Per-instance ("non-flat") "pallas" tables of the port, the build a
scene takes beyond FLAT_TRI_CAP instanced triangle slots, in both walk
orders, with the cap monkeypatched low (the JAX package's cap is local to
its build, and its non-flat path needs over 4M triangles, too slow for
interpret mode here). The scene: two meshes, one with three instances (a
material override, scales, an instance of a one-leaf mesh at the end of
the table).

Held against:
  * the JAX package's own packers on the same meshes: each mesh's BVH
    (accel.bvh.build), K-wide collapse at its scene slots
    (accel.wide.collapse, pack_rows at its node offset, 128 columns) and
    pallas.hbm_kernel.pack_fat over them and the scene's leaf rows, byte
    for byte; the stack bound the largest of the meshes'
    (pallas.ordered_kernel.max_stack_bound per mesh range);
  * the JAX package's per-instance "wide" path (use_tlas=False, the same
    object-space semantics) and the port's own flat build of the scene:
    closest-hit t at rtol/atol 1e-5, type equal, slot and instance equal
    except ties (t agrees) on at most 0.5% of lanes; occlusion equal
    except where the nearest hit lies within 1e-5 * t_cut of t_cut.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ptsharp_tpu as jpt
from ptsharp_tpu import intersect as jint
from ptsharp_tpu.accel import bvh as jbvh
from ptsharp_tpu.accel import wide as jwide
from ptsharp_tpu.core import transform as jt
from ptsharp_tpu.geometry import mesh as jmesh
from ptsharp_tpu.pallas.hbm_kernel import pack_fat
from ptsharp_tpu.pallas.ordered_kernel import max_stack_bound

import ptsharp_tpu_torch as tpt
from ptsharp_tpu_torch import intersect as tint
from ptsharp_tpu_torch import scene as tscene
from ptsharp_tpu_torch.geometry import mesh as tmesh

LEAF, K = 14, 8
N = 4096
CLUSTER_GROUP = 16
PT_TRIANGLE = 5


def _np(a):
    return np.asarray(a, np.float32)


def _meshes(meshes):
    return (meshes.sphere_mesh([0, 0, 0], 1.0, subdivisions=3),
            meshes.cube_mesh([-0.5, -0.5, -0.5], [0.5, 0.5, 0.5]))


def _scene(pkg, meshes, **build):
    b = pkg.SceneBuilder()
    grey = pkg.diffuse_material([0.7, 0.7, 0.7])
    b.add_plane([0, -1.5, 0], [0, 1, 0], grey)
    sph, cube = _meshes(meshes)
    s = b.add_mesh(sph, pkg.diffuse_material([0.5, 0.5, 0.5]))
    for x, over in ((-2.5, True), (2.5, False)):
        b.add_mesh_instance(
            s, transform=_np(jt.translate([x, 0.3, 0.5]))
            @ np.diag([1.0, 0.7, 1.2, 1.0]).astype(np.float32),
            material=pkg.diffuse_material([0.9, 0.1, 0.1]) if over else None)
    b.add_mesh(cube, pkg.diffuse_material([0.2, 0.8, 0.2]),
               transform=_np(jt.translate([0, 2, 1]))
               @ _np(jt.rotate([1, 1, 0], 0.5)))
    return b.build(leaf_size=LEAF, wide_k=K, **build)


def _port(monkeypatch, ordered, flat=False):
    if not flat:
        monkeypatch.setattr(tscene, "FLAT_TRI_CAP", 100)
    return _scene(tpt, tmesh, intersector="pallas", pallas_ordered=ordered,
                  device="cpu")


def _reference_fat(leaf_rows):
    """The non-flat fat table as the JAX package's packers lay it out
    (ptsharp_tpu/scene.py:796-816 after its per-mesh steps :524-599), and
    each mesh's node range."""
    parts, ranges = [], []
    off = slot = 0
    for mesh in _meshes(jmesh):
        v = mesh.fix_normals().v
        lo = np.minimum(np.minimum(v[:, 0], v[:, 1]), v[:, 2])
        hi = np.maximum(np.maximum(v[:, 0], v[:, 1]), v[:, 2])
        flat = jbvh.build(lo, hi, leaf_size=LEAF)
        leaf_ids = np.where(flat.count > 0)[0]
        nl = leaf_ids.shape[0]
        first = flat.first.copy()
        first[leaf_ids] = np.arange(nl, dtype=np.int32) * LEAF + slot
        w = jwide.collapse(flat.bmin, flat.bmax, first, flat.count,
                           flat.skip, kind=np.where(
                               flat.count > 0, PT_TRIANGLE, 0)
                           .astype(np.int32), k=K)
        base = jwide.pack_rows(w, off)
        rows = np.zeros((base.shape[0], 128), np.float32)
        rows[:, :base.shape[1]] = base
        parts.append(rows)
        ranges.append((off, off + rows.shape[0]))
        off += rows.shape[0]
        slot += (nl + (-nl) % CLUSTER_GROUP) * LEAF
    leaf = np.zeros((leaf_rows.shape[0], 128), np.float32)
    leaf[:, :leaf_rows.shape[1]] = leaf_rows
    return pack_fat(np.concatenate(parts), leaf, LEAF), ranges


@pytest.mark.parametrize("ordered", [True, False])
def test_tables_match_the_reference_packers(monkeypatch, ordered):
    st = _port(monkeypatch, ordered)
    sj = _scene(jpt, jmesh, intersector="wide", use_tlas=False)
    assert not st.p_flat and st.use_tlas is False
    fat, ranges = _reference_fat(np.asarray(sj.leaf_rows))
    assert st.p_fat.numpy().tobytes() == fat.tobytes()
    # one table a mesh: the instances share their mesh's range
    mesh_of = [0, 0, 0, 1]
    assert st.p_inst_base == tuple(ranges[m][0] for m in mesh_of)
    assert st.p_inst_end == tuple(ranges[m][1] for m in mesh_of)
    assert st.p_inst_end[-1] == st.p_fat.shape[0] // 2
    bounds = [max_stack_bound(fat[0::2], K, b, e) for b, e in ranges]
    assert st.p_stack_bound == max(bounds) and bounds[0] != bounds[1]
    np.testing.assert_array_equal(st.p_slot_tri.numpy(),
                                  np.arange(st.tri_n0.shape[0]))


def _rays(seed=1):
    g = np.random.default_rng(seed)
    org = (g.uniform(-4, 4, (N, 3)) + [0, 0, -6]).astype(np.float32)
    tgt = g.uniform(-3, 3, (N, 3)).astype(np.float32)
    d = tgt - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_cut = np.where(g.random(N) < 0.1, -1.0,
                     g.uniform(0.5, 12.0, N)).astype(np.float32)
    return org, d.astype(np.float32), t_cut


def _hits_agree(got, want):
    t, ptype, pindex, inst = (np.asarray(x) for x in got[:4])
    np.testing.assert_allclose(t, np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ptype, np.asarray(want[1]))
    same = (pindex == np.asarray(want[2])) & (inst == np.asarray(want[3]))
    assert (~same).mean() <= 0.005
    assert (ptype == PT_TRIANGLE).mean() > 0.1


@pytest.mark.parametrize("ordered", [True, False])
def test_queries_match_the_reference_and_the_flat_build(monkeypatch,
                                                        ordered):
    flat = _port(monkeypatch, ordered, flat=True)
    st = _port(monkeypatch, ordered)
    assert flat.p_flat and not st.p_flat
    sj = _scene(jpt, jmesh, intersector="wide", use_tlas=False)
    org, d, t_cut = _rays()
    ref = jint.closest_hit(sj, jnp.asarray(org), jnp.asarray(d))
    occ_ref = np.asarray(jint.occlusion_query(sj, jnp.asarray(org),
                                              jnp.asarray(d),
                                              jnp.asarray(t_cut)))
    o, dd, tc = (torch.from_numpy(x) for x in (org, d, t_cut))
    hit = tint.closest_hit(st, o, dd)
    _hits_agree(hit, ref)
    _hits_agree(hit, tint.closest_hit(flat, o, dd))
    occ = tint.occlusion_query(st, o, dd, tc).numpy()
    edge = np.abs(np.asarray(ref.t) - t_cut) <= 1e-5 * np.abs(t_cut)
    np.testing.assert_array_equal(occ[~edge], occ_ref[~edge])
    assert 0.05 < occ.mean() < 0.95
    # the instance's override shades its hits
    info = tint.hit_info(st, o, dd, hit)
    over = hit.inst.numpy() == 0
    assert over.sum() > 10
    assert (info.mat_id.numpy()[over] == int(st.inst_mat[0])).all()
