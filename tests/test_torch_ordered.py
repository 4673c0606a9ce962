"""The ordered walk of kernels #1, #2, #5 and #8 (csrc/closest_hit.cu,
csrc/any_hit.cu) on the CPU: its push order against the JAX kernel at
exact ties, the table property its single box test per node needs, and
its plain versions over both table forms against the JAX kernels that
re-test every node's own box.

Push order. The JAX package calls pallas_traverse_ordered8_fat with
order_mode="near" (ptsharp_tpu/intersect.py). The first triangle found
wins a tie in t, so the push order can change the slot at an exact tie,
and the TPU kernel orders each 128-lane group's visits by consensus, which
no per-ray order follows at every tie. The tie scene holds 64 pairs of
triangles on small dyadic coordinates, each a triangle and its copy
scaled by 2 about its first vertex: a ray through the small one meets both
at the same t bit for bit (Moller-Trumbore commutes with scaling by a
power of two), and the two have different boxes, so they sit in leaves
that the two orders visit in different orders. There the per-ray "near"
order keeps the JAX kernel's slot on more lanes than "full" (AGREEMENT),
so #1 walks "near".
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptsharp_tpu.geometry.mesh import TriMesh, cube_mesh, sphere_mesh
from ptsharp_tpu.materials import diffuse_material
from ptsharp_tpu.pallas import ordered_kernel
from ptsharp_tpu.scene import SceneBuilder

from ptsharp_tpu_torch import examples
from ptsharp_tpu_torch.accel import tables
from ptsharp_tpu_torch.accel import traverse as walks
from ptsharp_tpu_torch.kernels import traverse

from tests.test_torch_kernels import _tied
from tests.test_torch_split import _assert_t

N = 2048


def _rays(n, seed, spread=2.0, aim=(0.5, 0.3, 0.0), width=0.8):
    rng = np.random.default_rng(seed)
    org = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    tgt = rng.uniform(-width, width, (n, 3)).astype(np.float32) + aim
    d = np.where(rng.random((n, 1)) < 0.6,
                 tgt - org, rng.normal(size=(n, 3))).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, d


def _t_max(n, seed=9, lo=0.5, hi=4.0):
    rng = np.random.default_rng(seed)
    return np.where(rng.random(n) < 0.5, 1e9,
                    rng.uniform(lo, hi, n)).astype(np.float32)


def _scaled_pairs(n, seed):
    """n triangles on coordinates in 1/16 steps and, after them, each one
    scaled by 2 about its first vertex (every value exact in float32)."""
    rng = np.random.default_rng(seed)
    v0, e1, e2 = (rng.integers(-m, m + 1, (n, 3)) / 16 for m in (16, 8, 8))
    small = np.stack([v0, v0 + e1, v0 + e2], 1)
    large = np.stack([v0, v0 + 2 * e1, v0 + 2 * e2], 1)
    return TriMesh(np.concatenate([small, large]))


def _scene(kind, leaf_size, k):
    """"tie": the scaled pairs; "two-mesh": a sphere and a cube
    (tests/test_torch_kernels.py)."""
    b = SceneBuilder()
    if kind == "tie":
        b.add_mesh(_scaled_pairs(64, 1), diffuse_material([0.5, 0.5, 0.5]))
    else:
        b.add_mesh(sphere_mesh([0, 0.4, 0], 1.0, subdivisions=3),
                   diffuse_material([0.5, 0.5, 0.5]))
        b.add_mesh(cube_mesh([1.6, -0.3, -0.3], [2.2, 0.3, 0.3]),
                   diffuse_material([0.9, 0.6, 0.2]))
    return b.build(leaf_size=leaf_size, intersector="pallas", wide_k=k)


def _tie_rays(kind):
    """N rays of seed 3 and their t_max: on the tie scene from [-3, 3]^3,
    60% of them towards [-1, 1]^3, with t_max 1e9 or in [2, 6]; on the
    two-mesh scene towards the sphere, with t_max 1e9 or in [0.5, 4]."""
    if kind == "tie":
        return (*_rays(N, 3, spread=3.0, aim=(0.0, 0.0, 0.0), width=1.0),
                _t_max(N, lo=2.0, hi=6.0))
    return (*_rays(N, 3), _t_max(N))


# scene, leaf size, K -> (hit lanes, of them the lanes whose slot the two
# orders give differently, and the slots equal to the JAX kernel's under
# "full" and under "near"), measured with _tie_rays
AGREEMENT = {("tie", 1, 8): (1121, 23, 1021, 1034),
             ("tie", 2, 4): (1121, 11, 1047, 1052),
             ("two-mesh", 8, 8): (1032, 0, 1032, 1032)}


@pytest.mark.parametrize("kind, leaf_size, k", list(AGREEMENT))
def test_push_order_against_the_jax_kernel(kind, leaf_size, k):
    sp = _scene(kind, leaf_size, k)
    org, d, tm = _tie_rays(kind)
    args = (sp.p_inst_base[0], sp.p_inst_end[0], sp.max_leaf, sp.wide_k)
    t_ref, s_ref, _u, _v = (np.asarray(x) for x in
                            ordered_kernel.pallas_traverse_ordered8_fat(
                                sp.p_fat, jnp.asarray(org), jnp.asarray(d),
                                jnp.asarray(tm), *args, order_mode="near",
                                pipelined=True, mt_gate=True))
    fat = torch.from_numpy(np.array(sp.p_fat))
    split = tables.split_fat(np.asarray(sp.p_fat), sp.max_leaf)
    tables.check_child_boxes(split[0], k)
    rows, leaf = map(torch.from_numpy, split)
    o, dd, t = map(torch.from_numpy, (org, d, tm))
    slots = {m: walks.closest_hit_split_plain(
        rows, leaf, o, dd, t, *args, order_mode=m)[1].numpy()
        for m in walks.ORDER_MODES}
    hit = t_ref < 1e8
    n_hit, n_differ, n_full, n_near = AGREEMENT[(kind, leaf_size, k)]
    assert int(hit.sum()) == n_hit
    differ = slots["full"] != slots["near"]
    assert int(differ.sum()) == int((differ & hit).sum()) == n_differ
    assert int((slots["full"][hit] == s_ref[hit]).sum()) == n_full
    assert int((slots["near"][hit] == s_ref[hit]).sum()) == n_near
    # #1's plain version walks the order that agrees on more lanes
    assert n_near >= n_full
    np.testing.assert_array_equal(
        walks.closest_hit_plain(fat, o, dd, t, *args)[1].numpy(),
        slots["near"])


def _tables():
    """Node rows of small tables: the bunny at subdivision 3 (K 4 and 8)
    and the two-mesh scene (K 8)."""
    out = {}
    for k in (4, 8):
        scene = examples.bunny(16, 12, subdivisions=3, intersector="pallas",
                               wide_k=k, device="cpu")[0]
        out[f"bunny K={k}"] = (scene.p_fat.numpy()[0::2], k)
    out["two-mesh K=8"] = (np.asarray(_scene("two-mesh", 8, 8).p_fat)[0::2],
                           8)
    return out


@pytest.mark.parametrize("name", ["bunny K=4", "bunny K=8", "two-mesh K=8"])
def test_child_boxes_equal_their_nodes_own_boxes(name):
    rows, k = _tables()[name]
    tables.check_child_boxes(rows, k)
    bits = rows.view(np.int32)
    internal = np.nonzero((bits[:, 7] & 0xFF) == 0)[0]
    assert internal.size > 1
    # one ulp off in one child box of one internal node raises
    bad = rows.copy()
    p = internal[len(internal) // 2]
    c = int(np.nonzero(bits[p, 9 + 6 * k:9 + 7 * k] > 0)[0][-1])
    col = 9 + 6 * c + 4
    bad[p, col] = np.nextafter(bad[p, col], np.float32(np.inf))
    with pytest.raises(ValueError, match="bit for bit"):
        tables.check_child_boxes(bad, k)


def test_ordered_builds_check_the_child_boxes(monkeypatch):
    seen = []
    monkeypatch.setattr(tables, "check_child_boxes",
                        lambda rows, k: seen.append((rows.shape, k)))
    for ordered in (True, False):
        examples.bunny(16, 12, subdivisions=2, intersector="pallas", wide_k=8,
                       pallas_ordered=ordered, device="cpu")
    assert len(seen) == 1 and seen[0][1] == 8


@pytest.mark.parametrize("k", [4, 8])
def test_entry_distance_cull_matches_the_own_box_retest(k):
    """The entry-distance walk (entries carry their entry distance, no
    own-box re-test) against the JAX package's ordered kernels over the
    split tables, which re-test each visited node's own box (interpret
    mode), on the two-mesh scene's rays with random t_max:
    closest_hit_plain and closest_hit_split_plain ("near", #1's push
    order) against pallas_traverse_ordered8(order_mode="near") with
    tests/test_torch_split.py's tolerance and tie rule, and any_hit_plain
    and any_hit_split_plain against pallas_occluded_ordered8, equal off
    the t_cut band."""
    sp = _scene("two-mesh", 8, k)
    org_np, d_np = _rays(N, 5)
    org, d = map(torch.from_numpy, (org_np, d_np))
    rng = np.random.default_rng(11)
    tm_np = np.where(rng.random(N) < 0.1, -1e9,
                     rng.uniform(0.2, 6.0, N)).astype(np.float32)
    tm = torch.from_numpy(tm_np)
    fat = torch.from_numpy(np.array(sp.p_fat))
    rows_np, leaf_np = tables.split_fat(np.asarray(sp.p_fat), sp.max_leaf)
    tables.check_child_boxes(rows_np, k)
    rows, leaf = map(torch.from_numpy, (rows_np, leaf_np))
    args = (sp.p_inst_base[0], sp.p_inst_end[0], sp.max_leaf, sp.wide_k)
    jo, jd, jt = map(jnp.asarray, (org_np, d_np, tm_np))
    t_ref, s_ref, u_ref, v_ref = (np.asarray(x) for x in
                                  ordered_kernel.pallas_traverse_ordered8(
                                      sp.p_rows, sp.p_leaf, jo, jd, jt, *args,
                                      order_mode="near"))
    hit = s_ref >= 0
    assert 0.2 < hit.mean() < 0.9
    same = hit & ~_tied(fat, org, d, tm, sp.max_leaf)
    for t, slot, u, v in (
            walks.closest_hit_plain(fat, org, d, tm, *args),
            walks.closest_hit_split_plain(rows, leaf, org, d, tm, *args,
                                          order_mode="near")):
        _assert_t(t.numpy(), t_ref)
        np.testing.assert_array_equal(slot.numpy() >= 0, hit)
        np.testing.assert_array_equal(slot.numpy()[same], s_ref[same])
        np.testing.assert_allclose(u.numpy()[same], u_ref[same], atol=1e-4)
        np.testing.assert_allclose(v.numpy()[same], v_ref[same], atol=1e-4)
    occ_ref = np.asarray(ordered_kernel.pallas_occluded_ordered8(
        sp.p_rows, sp.p_leaf, jo, jd, jt, *args))
    assert 0.1 < occ_ref.mean() < 0.9
    t_near = walks.closest_hit_plain(fat, org, d, torch.full((N,), 1e9),
                                     *args)[0].numpy()
    edge = np.abs(t_near - tm_np) <= 1e-5 * np.abs(tm_np)
    for occ in (walks.any_hit_plain(fat, org, d, tm, *args),
                walks.any_hit_split_plain(rows, leaf, org, d, tm, *args)):
        np.testing.assert_array_equal(occ.numpy()[~edge], occ_ref[~edge])


def test_counts_are_kept_by_the_kernels_only():
    sp = _scene("two-mesh", 8, 8)
    org, d = map(torch.from_numpy, _rays(64, 3))
    fat = torch.from_numpy(np.array(sp.p_fat))
    args = (sp.p_inst_base[0], sp.p_inst_end[0], sp.max_leaf, sp.wide_k)
    tm = torch.full((64,), 1e9)
    counts = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="counts"):
        traverse.closest_hit(fat, org, d, tm, *args, counts=counts)
    with pytest.raises(ValueError, match="counts"):
        traverse.any_hit(fat, org, d, tm, *args, counts=counts)
    traverse.reset_launch_counts()
    t, s, _u, _v = traverse.closest_hit(fat, org, d, tm, *args)
    assert torch.equal(s, walks.closest_hit_plain(fat, org, d, tm,
                                                  *args)[1])
    assert traverse.closest_hit.launches == 0
