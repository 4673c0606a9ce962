"""The traversal kernels' plain versions against the JAX package's Pallas
kernels (interpret mode, as the JAX package's own tests run them on the
CPU), on the two-mesh scene of tests/test_tpu_compiled.py.

Tolerances:
  closest-hit: t allclose at rtol 1e-5, atol 1e-5 (the reference's
    compiled-kernel tolerance); slots equal except where the reference's
    t is tied with another triangle's within that tolerance; u, v within
    1e-4 on hit lanes.
  any-hit: equal, except on lanes whose nearest hit lies within
    1e-5 * t_cut of t_cut (there the rounding of one t decides).

The card-marked test runs the CUDA kernels against the plain versions;
it skips on a machine without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptsharp_tpu.geometry.mesh import cube_mesh, sphere_mesh
from ptsharp_tpu.materials import diffuse_material
from ptsharp_tpu.pallas import ordered_kernel, wide_kernel
from ptsharp_tpu.scene import SceneBuilder

from ptsharp_tpu_torch.accel import traverse as walks
from ptsharp_tpu_torch.kernels import build, traverse

from tests.torch_walk_cases import STACK_CHAINS, stack_chain

N = 1024
RTOL = ATOL = 1e-5


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    org = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    tgt = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32) + [0.5, 0.3, 0]
    d = np.where(rng.random((n, 1)) < 0.6,
                 tgt - org, rng.normal(size=(n, 3))).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, d


@pytest.fixture(scope="module")
def ref():
    """The scene, the rays and the JAX kernels' results, computed once."""
    b = SceneBuilder()
    b.add_mesh(sphere_mesh([0, 0.4, 0], 1.0, subdivisions=3),
               diffuse_material([0.5, 0.5, 0.5]))
    b.add_mesh(cube_mesh([1.6, -0.3, -0.3], [2.2, 0.3, 0.3]),
               diffuse_material([0.9, 0.6, 0.2]))
    sp = b.build(leaf_size=8, intersector="pallas", wide_k=8)
    org, d = _rays(N, seed=3)
    rng = np.random.default_rng(9)
    t_max = np.where(rng.random(N) < 0.1, -1e9,
                     np.where(rng.random(N) < 0.5, 1e9,
                              rng.uniform(0.5, 4.0, N))).astype(np.float32)
    t_cut = np.where(rng.random(N) < 0.1, -1.0,
                     rng.uniform(0.2, 6.0, N)).astype(np.float32)
    args = (sp.p_inst_base[0], sp.p_inst_end[0], sp.max_leaf, sp.wide_k)
    jo, jd = jnp.asarray(org), jnp.asarray(d)
    closest = ordered_kernel.pallas_traverse_ordered8_fat(
        sp.p_fat, jo, jd, jnp.asarray(t_max), *args, order_mode="near",
        pipelined=True, mt_gate=True)
    occ_wide8 = wide_kernel.pallas_occluded_wide8(
        sp.p_rows, sp.p_leaf, jo, jd, jnp.asarray(t_cut), *args)
    occ_fat = ordered_kernel.pallas_occluded_fat_pipe(
        sp.p_fat, jo, jd, jnp.asarray(t_cut), *args, mt_gate=True)
    return dict(
        fat=torch.from_numpy(np.array(sp.p_fat)), org=torch.from_numpy(org),
        dirn=torch.from_numpy(d), t_max=torch.from_numpy(t_max),
        t_cut=torch.from_numpy(t_cut), args=args,
        closest=[np.asarray(x) for x in closest],
        occ={"wide8": np.asarray(occ_wide8), "fat_pipe": np.asarray(occ_fat)},
        slot_tri=np.asarray(sp.p_slot_tri))


def _tied(fat, org, dirn, t_max, leaf_size):
    """Lanes where two triangles hit within the tolerance of each other
    at the nearest t, by brute force over every leaf slot."""
    tri = torch.as_tensor(fat[1::2, :leaf_size * 9]).reshape(1, -1, 9)
    tri = tri.expand(org.shape[0], -1, -1)
    ok, tt, _u, _v = walks.mt(tri, org, dirn)
    tt = torch.where(ok & (tt < t_max[:, None]), tt, 1e30)
    two = torch.topk(tt, 2, dim=1, largest=False).values.numpy()
    return two[:, 1] - two[:, 0] <= ATOL + RTOL * np.abs(two[:, 0])


def test_closest_hit_plain_matches_ordered_fat_kernel(ref):
    t, slot, u, v = walks.closest_hit_plain(
        ref["fat"], ref["org"], ref["dirn"], ref["t_max"], *ref["args"])
    t_ref, s_ref, u_ref, v_ref = ref["closest"]
    np.testing.assert_allclose(t.numpy(), t_ref, rtol=RTOL, atol=ATOL)
    hit = t_ref < 1e8
    assert hit.mean() > 0.2
    assert np.array_equal(slot.numpy() >= 0, s_ref >= 0)
    tie = _tied(ref["fat"], ref["org"], ref["dirn"], ref["t_max"],
                ref["args"][2])
    same = hit & ~tie
    np.testing.assert_array_equal(slot.numpy()[same], s_ref[same])
    np.testing.assert_allclose(u.numpy()[same], u_ref[same], atol=1e-4)
    np.testing.assert_allclose(v.numpy()[same], v_ref[same], atol=1e-4)
    assert (slot.numpy()[~hit] == -1).all() and (t.numpy()[~hit] == 1e9).all()


@pytest.mark.parametrize("kernel", ["wide8", "fat_pipe"])
def test_any_hit_plain_matches_kernel(ref, kernel):
    occ = walks.any_hit_plain(ref["fat"], ref["org"], ref["dirn"],
                              ref["t_cut"], *ref["args"]).numpy()
    occ_ref = ref["occ"][kernel]
    assert 0.1 < occ_ref.mean() < 0.9
    t_near, _s, _u, _v = walks.closest_hit_plain(
        ref["fat"], ref["org"], ref["dirn"],
        torch.full((N,), 1e9), *ref["args"])
    tc = ref["t_cut"].numpy()
    edge = np.abs(t_near.numpy() - tc) <= 1e-5 * np.abs(tc)
    np.testing.assert_array_equal(occ[~edge], occ_ref[~edge])
    assert not occ[tc <= 0].any()


def test_any_hit_agrees_with_bounded_closest_hit(ref):
    """occluded(t_cut) == (closest hit below t_cut) on the plain versions."""
    occ = walks.any_hit_plain(ref["fat"], ref["org"], ref["dirn"],
                              ref["t_cut"], *ref["args"]).numpy()
    tc = ref["t_cut"]
    t, _s, _u, _v = walks.closest_hit_plain(
        ref["fat"], ref["org"], ref["dirn"], tc, *ref["args"])
    np.testing.assert_array_equal(occ, (t.numpy() < 1e8) & (tc.numpy() > 0))


def test_wrappers_take_the_plain_version_on_cpu(ref):
    traverse.reset_launch_counts()
    out = traverse.closest_hit(ref["fat"], ref["org"], ref["dirn"],
                               ref["t_max"], *ref["args"])
    np.testing.assert_allclose(out[0].numpy(), ref["closest"][0],
                               rtol=RTOL, atol=ATOL)
    occ = traverse.any_hit(ref["fat"], ref["org"], ref["dirn"], ref["t_cut"],
                           *ref["args"])
    assert occ.dtype == torch.bool and occ.shape == (N,)
    # the counts move only where a kernel launches
    assert traverse.closest_hit.launches == 0
    assert traverse.any_hit.launches == 0


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "range"])
def test_wrappers_reject_bad_inputs(ref, bad):
    fat, org, d, tm = ref["fat"], ref["org"], ref["dirn"], ref["t_max"]
    base, end, leaf, k = ref["args"]
    if bad == "dtype":
        org = org.double()
    elif bad == "shape":
        tm = tm[:-1]
    elif bad == "contiguous":
        d = torch.cat([d, d], dim=1)[:, ::2]
    else:
        end = fat.shape[0]  # past the node count (fat holds 2 rows/node)
    with pytest.raises(ValueError):
        traverse.closest_hit(fat, org, d, tm, base, end, leaf, k)


@pytest.mark.parametrize("k, depth", STACK_CHAINS)
def test_stack_capacity_holds_a_bound_past_64(monkeypatch, k, depth):
    """A tree whose max_stack_bound lies in (64, 128], the JAX ordered
    kernels' capacity: the ordered build check passes (and raised at the
    port's former capacity of 64), and both ordered walks, over the fat
    and the split tables, find what the stack-free preorder walk finds."""
    from ptsharp_tpu_torch import scene as tscene
    from ptsharp_tpu_torch.accel import tables

    fat = stack_chain(k, depth)
    bound = tables.max_stack_bound(fat[0::2], k)
    assert 64 < bound <= build.STACK_CAPACITY == walks.STACK_CAPACITY == 128
    tscene.check_stack_bound(bound)
    monkeypatch.setattr(tscene, "STACK_CAPACITY", 64)
    with pytest.raises(ValueError, match="stack"):
        tscene.check_stack_bound(bound)

    rng = np.random.default_rng(4)
    n = 16
    org = np.zeros((n, 3), np.float32)
    org[:, 1:] = rng.uniform(-0.3, 0.3, (n, 2))
    d = np.concatenate([np.ones((n, 1)), rng.uniform(-0.01, 0.01, (n, 2))],
                       axis=1).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    fat_t, org_t, d_t = map(torch.from_numpy, (fat, org, d))
    split = tables.split_fat(fat, 1)
    tables.check_child_boxes(split[0], k)
    rows, leaf = map(torch.from_numpy, split)
    args = (0, fat.shape[0] // 2, 1, k)
    tm = torch.full((n,), 1e9)
    t_pre, s_pre, _u, _v = walks.closest_hit_preorder_plain(
        fat_t, org_t, d_t, tm, *args)
    np.testing.assert_allclose(t_pre.numpy() * d[:, 0], 1.55, rtol=1e-5)
    for mode in walks.ORDER_MODES:
        for t, s, _u, _v in (
                walks.closest_hit_split_plain(rows, leaf, org_t, d_t, tm,
                                              *args, order_mode=mode),
                walks.closest_hit_plain(fat_t, org_t, d_t, tm, *args)):
            assert torch.equal(t, t_pre) and torch.equal(s, s_pre)
    t_cut = torch.full((n,), 3.0)
    assert walks.any_hit_plain(fat_t, org_t, d_t, t_cut, *args).all()
    for mode in walks.ORDER_MODES:
        assert walks.any_hit_split_plain(rows, leaf, org_t, d_t, t_cut,
                                         *args, order_mode=mode).all()


# rays of a launch: fewer than one warp; the test's rays; more than the
# persistent grid holds at once (132 SMs x 2,048 threads at most), so that
# warps refill their lanes
CUDA_RAYS = (17, N, 1 << 19)


@pytest.mark.cuda
@pytest.mark.parametrize("n", CUDA_RAYS)
def test_cuda_kernels_match_plain_versions(ref, n):
    """Runs on a machine with a card: both persistent CUDA kernels against
    their plain versions on the same inputs (the test's rays repeated or
    cut to n), their launch counts, and their step counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda")
    rep = -(-n // N)
    fat = ref["fat"].to(dev)
    org, d, tm, tc = (ref[x].repeat(rep, *([1] * (ref[x].dim() - 1)))[:n]
                      .contiguous().to(dev)
                      for x in ("org", "dirn", "t_max", "t_cut"))
    traverse.reset_launch_counts()
    counts = torch.zeros((2, 2), dtype=torch.int64, device=dev)
    t, s, u, v = traverse.closest_hit(fat, org, d, tm, *ref["args"],
                                      counts=counts[0])
    occ = traverse.any_hit(fat, org, d, tc, *ref["args"], counts=counts[1])
    torch.cuda.synchronize()
    assert traverse.closest_hit.launches == 1
    assert traverse.any_hit.launches == 1
    *want, steps = walks.closest_hit_plain(fat, org, d, tm, *ref["args"],
                                           return_iters=True)
    for got, exp in zip((t, s, u, v), want):
        assert torch.equal(got, exp)
    occ_p, steps_any = walks.any_hit_plain(fat, org, d, tc, *ref["args"],
                                           return_iters=True)
    assert torch.equal(occ, occ_p)
    # the kernels take the plain versions' steps; lane slots bound them
    assert counts[:, 0].tolist() == [int(steps.sum()), int(steps_any.sum())]
    assert bool((counts[:, 0] <= counts[:, 1]).all())
