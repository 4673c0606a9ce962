"""The preorder walk's plain versions against the JAX package's preorder
Pallas kernels (interpret mode, as the JAX package's own tests run them on
the CPU): closest-hit against pallas_traverse_wide8 over the node and leaf
tables and against pallas_traverse_hbm8_fat over their fat interleave,
any-hit against pallas_occluded_hbm8_fat. Two scenes at K=8: the
two-mesh scene of tests/test_tpu_compiled.py at leaf 8 and
_bunny_mesh(3) at leaf 14. 1,000 rays, not a multiple of the TPU
kernels' 1,024-ray tile, so their pad lanes are in play.

Tolerances:
  closest-hit: slots equal on every lane, ties included (the one-ray
    walk accepts the same triangles in the same order as the TPU
    kernels' shared-cursor walk). t within 1e-6 on at least 99.5% of
    lanes and within rtol 1e-5, atol 1e-5 (the reference's compiled-kernel
    tolerance) on every lane: on grazing triangles (|det| near 1e-4) XLA's
    fused multiply-adds and torch's separate roundings part by up to
    3.2e-5 in t, as they do for the ordered kernel (ROADMAP Queue 3).
    u, v within 1e-4 on hit lanes.
  any-hit: equal, except on lanes whose nearest hit lies within
    1e-5 * t_cut of t_cut.
  preorder against ordered (both plain): t equal; slots equal except
    where two triangles hit within rtol 1e-5, atol 1e-5 of each other
    (ties).

The plain versions' step counts (return_iters, the steps the persistent
CUDA kernels count) and the wrappers' `counts`, which only the kernels
keep, are checked on the CPU. The card-marked test runs the two preorder
CUDA kernels against their plain versions, every lane and the step counts
equal; it skips on a machine without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptsharp_tpu import examples as jex
from ptsharp_tpu.geometry.mesh import cube_mesh, sphere_mesh
from ptsharp_tpu.materials import diffuse_material
from ptsharp_tpu.pallas import hbm_kernel, wide_kernel
from ptsharp_tpu.scene import SceneBuilder

from ptsharp_tpu_torch.accel import traverse as walks
from ptsharp_tpu_torch.kernels import traverse

from tests.test_torch_kernels import _rays, _tied

N = 1000


def _two_mesh():
    b = SceneBuilder()
    b.add_mesh(sphere_mesh([0, 0.4, 0], 1.0, subdivisions=3),
               diffuse_material([0.5, 0.5, 0.5]))
    b.add_mesh(cube_mesh([1.6, -0.3, -0.3], [2.2, 0.3, 0.3]),
               diffuse_material([0.9, 0.6, 0.2]))
    return b.build(leaf_size=8, intersector="pallas", wide_k=8,
                   pallas_ordered=False)


def _bunny3():
    b = SceneBuilder()
    b.add_mesh(jex._bunny_mesh(3), diffuse_material([0.5, 0.5, 0.5]))
    return b.build(leaf_size=14, intersector="pallas", wide_k=8,
                   pallas_ordered=False)


SCENES = {"two_mesh_leaf8": _two_mesh, "bunny3_leaf14": _bunny3}


@pytest.fixture(scope="module", params=sorted(SCENES))
def ref(request):
    """A scene, its rays and the JAX preorder kernels' results."""
    sp = SCENES[request.param]()
    assert not sp.p_hbm and not sp.p_ordered
    org, d = _rays(N, seed=3)
    rng = np.random.default_rng(9)
    t_max = np.where(rng.random(N) < 0.1, -1e9,
                     np.where(rng.random(N) < 0.5, 1e9,
                              rng.uniform(0.5, 4.0, N))).astype(np.float32)
    t_cut = np.where(rng.random(N) < 0.1, -1.0,
                     rng.uniform(0.2, 6.0, N)).astype(np.float32)
    args = (sp.p_inst_base[0], sp.p_inst_end[0], sp.max_leaf, sp.wide_k)
    fat = hbm_kernel.pack_fat(sp.p_rows, sp.p_leaf, sp.max_leaf)
    jo, jd = jnp.asarray(org), jnp.asarray(d)
    closest = {
        "wide8": wide_kernel.pallas_traverse_wide8(
            sp.p_rows, sp.p_leaf, jo, jd, jnp.asarray(t_max), *args),
        "hbm8_fat": hbm_kernel.pallas_traverse_hbm8_fat(
            jnp.asarray(fat), jo, jd, jnp.asarray(t_max), *args),
    }
    occ = hbm_kernel.pallas_occluded_hbm8_fat(
        jnp.asarray(fat), jo, jd, jnp.asarray(t_cut), *args)
    return dict(
        fat=torch.from_numpy(fat), org=torch.from_numpy(org),
        dirn=torch.from_numpy(d), t_max=torch.from_numpy(t_max),
        t_cut=torch.from_numpy(t_cut), args=args,
        closest={k: [np.asarray(x) for x in v] for k, v in closest.items()},
        occ=np.asarray(occ))


def _edge(ref):
    """Lanes whose nearest hit lies within 1e-5 * t_cut of t_cut."""
    t_near, _s, _u, _v = walks.closest_hit_preorder_plain(
        ref["fat"], ref["org"], ref["dirn"], torch.full((N,), 1e9),
        *ref["args"])
    tc = ref["t_cut"].numpy()
    return np.abs(t_near.numpy() - tc) <= 1e-5 * np.abs(tc)


@pytest.mark.parametrize("kernel", ["wide8", "hbm8_fat"])
def test_closest_hit_preorder_plain_matches_kernel(ref, kernel):
    t, slot, u, v = walks.closest_hit_preorder_plain(
        ref["fat"], ref["org"], ref["dirn"], ref["t_max"], *ref["args"])
    t_ref, s_ref, u_ref, v_ref = ref["closest"][kernel]
    hit = s_ref >= 0
    assert 0.2 < hit.mean() < 0.9
    np.testing.assert_array_equal(slot.numpy(), s_ref)
    assert (np.abs(t.numpy() - t_ref) <= 1e-6).mean() >= 0.995
    np.testing.assert_allclose(t.numpy(), t_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(u.numpy()[hit], u_ref[hit], atol=1e-4)
    np.testing.assert_allclose(v.numpy()[hit], v_ref[hit], atol=1e-4)
    assert (t.numpy()[~hit] == 1e9).all()


def test_any_hit_preorder_plain_matches_kernel(ref):
    occ = walks.any_hit_preorder_plain(
        ref["fat"], ref["org"], ref["dirn"], ref["t_cut"],
        *ref["args"]).numpy()
    assert 0.1 < ref["occ"].mean() < 0.9
    edge = _edge(ref)
    np.testing.assert_array_equal(occ[~edge], ref["occ"][~edge])
    assert not occ[ref["t_cut"].numpy() <= 0].any()


def test_preorder_and_ordered_walks_agree(ref):
    """Both walk orders find the same t; slots differ only at ties; the
    two any-hits agree off the t_cut band."""
    fat, org, d = ref["fat"], ref["org"], ref["dirn"]
    tp, sp, _up, _vp = walks.closest_hit_preorder_plain(
        fat, org, d, ref["t_max"], *ref["args"])
    to, so, _uo, _vo = walks.closest_hit_plain(
        fat, org, d, ref["t_max"], *ref["args"])
    np.testing.assert_array_equal(tp.numpy(), to.numpy())
    differ = sp.numpy() != so.numpy()
    tie = _tied(fat, org, d, ref["t_max"], ref["args"][2])
    assert not (differ & ~tie).any()
    occ_p = walks.any_hit_preorder_plain(fat, org, d, ref["t_cut"],
                                         *ref["args"]).numpy()
    occ_o = walks.any_hit_plain(fat, org, d, ref["t_cut"],
                                *ref["args"]).numpy()
    edge = _edge(ref)
    np.testing.assert_array_equal(occ_p[~edge], occ_o[~edge])


def test_any_hit_preorder_agrees_with_bounded_closest_hit(ref):
    """occluded(t_cut) == (closest hit below t_cut), both preorder."""
    occ = walks.any_hit_preorder_plain(
        ref["fat"], ref["org"], ref["dirn"], ref["t_cut"],
        *ref["args"]).numpy()
    tc = ref["t_cut"]
    t, _s, _u, _v = walks.closest_hit_preorder_plain(
        ref["fat"], ref["org"], ref["dirn"], tc, *ref["args"])
    np.testing.assert_array_equal(occ, (t.numpy() < 1e8) & (tc.numpy() > 0))


def test_preorder_wrappers_take_the_plain_version_on_cpu(ref):
    traverse.reset_launch_counts()
    t, slot, _u, _v = traverse.closest_hit_preorder(
        ref["fat"], ref["org"], ref["dirn"], ref["t_max"], *ref["args"])
    np.testing.assert_array_equal(slot.numpy(), ref["closest"]["wide8"][1])
    occ = traverse.any_hit_preorder(ref["fat"], ref["org"], ref["dirn"],
                                    ref["t_cut"], *ref["args"])
    assert occ.dtype == torch.bool and occ.shape == (N,)
    assert all(w.launches == 0 for w in traverse.WRAPPERS)
    with pytest.raises(ValueError):
        traverse.closest_hit_preorder(ref["fat"], ref["org"].double(),
                                      ref["dirn"], ref["t_max"],
                                      *ref["args"])


def test_preorder_plain_versions_count_their_steps(ref):
    """return_iters adds each ray's steps and changes no result: every
    ray visits the root, at most end - base nodes; an any-hit lane with
    t_cut <= 0 takes none and no any-hit lane takes more than its
    closest-hit walk bounded by the same t_cut."""
    fat, org, d, args = ref["fat"], ref["org"], ref["dirn"], ref["args"]
    *got, steps = walks.closest_hit_preorder_plain(
        fat, org, d, ref["t_cut"], *args, return_iters=True)
    want = walks.closest_hit_preorder_plain(fat, org, d, ref["t_cut"],
                                            *args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(steps.min()) >= 1 and int(steps.max()) <= args[1] - args[0]
    occ, any_steps = walks.any_hit_preorder_plain(
        fat, org, d, ref["t_cut"], *args, return_iters=True)
    assert torch.equal(occ, walks.any_hit_preorder_plain(
        fat, org, d, ref["t_cut"], *args))
    inactive = ref["t_cut"] <= 0
    assert (any_steps[inactive] == 0).all()
    assert (any_steps[~inactive] <= steps[~inactive]).all()
    assert (any_steps[~inactive] >= 1).all()


def test_work_counts_a_leafs_triangles_not_its_padding(ref):
    """count_work (the kernels' bound) counts a leaf visit's `count`
    triangles and its count * 9 columns, not its leaf_size slots; with
    t_cut, each lane's triangles up to its first one accepted below the
    cut, as the any-hit kernels stop there."""
    fat, org, d, args = ref["fat"], ref["org"], ref["dirn"], ref["args"]
    leaf_size = args[2]
    bits = fat.view(torch.int32)
    count = (bits[0::2, 7] & 0xFF).to(torch.int64)
    first = bits[0::2, 6].to(torch.int64)
    leaves = torch.nonzero(count > 0).squeeze(1)
    assert int(count[leaves].min()) < leaf_size  # some padding to skip
    # each lane at the leaf of its nearest hit, a lane that hits nothing
    # at some leaf
    _t, slot, _u, _v = walks.closest_hit_preorder_plain(
        fat, org, d, torch.full((N,), 1e9), *args)
    lanes = torch.arange(N)
    at = leaves[lanes % leaves.numel()]
    own = (first[leaves][None, :] <= slot[:, None].long()) \
        & (slot[:, None].long() < (first + count)[leaves][None, :])
    at = torch.where(slot >= 0, leaves[own.long().argmax(dim=1)], at)
    node = 2 * at  # fat rows of the leaves
    walk = walks.SkipWalk(walks.Table(fat), org, d,
                          ref["t_cut"].clone(), args[0], args[1],
                          args[3], torch.ones(N, dtype=torch.bool))
    cnt = count[node // 2]
    with walks.count_work() as work:
        ok, tt, _u, _v = walk.leaf_block(lanes, node, leaf_size)
    assert work.triangles == int(cnt.sum())
    distinct = torch.unique(node)
    assert work.table_bytes == int(count[distinct // 2].sum()) * 9 * 4
    assert not (ok & (torch.arange(leaf_size) >= cnt[:, None])).any()

    t_cut = torch.full((N,), 1e9)
    with walks.count_work() as work:
        walk.leaf_block(lanes, node, leaf_size, t_cut)
    acc = ok & (tt < t_cut[:, None])
    want = sum(int(np.argmax(a)) + 1 if a.any() else int(c)
               for a, c in zip(acc.numpy(), cnt.numpy()))
    assert acc.any() and work.triangles == want < int(cnt.sum())


def test_preorder_wrappers_take_no_counts_on_the_cpu(ref):
    """`counts` is kept by the CUDA kernels; on CPU tensors both preorder
    wrappers raise on it."""
    counts = torch.zeros(2, dtype=torch.int64)
    for wrapper, t in ((traverse.closest_hit_preorder, ref["t_max"]),
                       (traverse.any_hit_preorder, ref["t_cut"])):
        with pytest.raises(ValueError, match="counts"):
            wrapper(ref["fat"], ref["org"], ref["dirn"], t, *ref["args"],
                    counts=counts)


@pytest.mark.cuda
def test_cuda_preorder_kernels_match_plain_versions(ref):
    """Runs on a machine with a card: both preorder CUDA kernels against
    their plain versions on the same inputs, and their launch counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda")
    fat = ref["fat"].to(dev)
    org, d = ref["org"].to(dev), ref["dirn"].to(dev)
    tm, tc = ref["t_max"].to(dev), ref["t_cut"].to(dev)
    traverse.reset_launch_counts()
    counts = torch.zeros((2, 2), dtype=torch.int64, device=dev)
    got = traverse.closest_hit_preorder(fat, org, d, tm, *ref["args"],
                                        counts=counts[0])
    occ = traverse.any_hit_preorder(fat, org, d, tc, *ref["args"],
                                    counts=counts[1])
    torch.cuda.synchronize()
    assert traverse.closest_hit_preorder.launches == 1
    assert traverse.any_hit_preorder.launches == 1
    assert traverse.closest_hit.launches == traverse.any_hit.launches == 0
    *want, steps = walks.closest_hit_preorder_plain(
        fat, org, d, tm, *ref["args"], return_iters=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    occ_p, any_steps = walks.any_hit_preorder_plain(
        fat, org, d, tc, *ref["args"], return_iters=True)
    assert torch.equal(occ, occ_p)
    assert counts[:, 0].tolist() == [int(steps.sum()), int(any_steps.sum())]
