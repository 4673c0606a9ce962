"""The split-table walks' plain versions against the JAX package's Pallas
kernels over `rows` + `leaf` (interpret mode, as the JAX package's own
tests run them on the CPU): ordered closest-hit against
pallas_traverse_ordered8 in both push orders and with its packet
schedules, ordered any-hit against pallas_occluded_ordered8, and the
shared-cursor packet walk against pallas_traverse_wide (whose plain
version, the preorder walk over the split tables, is what the port's
persistent kernel #13 computes). The sphere + cube
scene of tests/test_tpu_compiled.py at leaf 8, with the sphere at
subdivisions 2 (K=4) and 3 (K=8). The port's tables are split_fat of its
own fat table. 1,000 rays, not a multiple of the ordered kernels'
1,024-ray tile nor of pallas_traverse_wide's 256-ray tile here, so their
pad lanes are in play.

Tolerances:
  closest-hit: t within 1e-6 on at least 99.5% of lanes and within rtol
    1e-5, atol 1e-5 on every lane (on grazing triangles XLA's fused
    multiply-adds and torch's separate roundings part by up to 3.2e-5 in
    t; ROADMAP Queue 3). Slots: equal except ties for the ordered walk
    (the packet's consensus order differs from a ray's own near-to-far
    order), equal on every lane for the packet walk (a lane of a
    shared-cursor packet accepts the triangles its own preorder walk
    does, in the same order). u, v within 1e-4 on hit lanes off ties.
  any-hit: equal, except on lanes whose nearest hit lies within
    1e-5 * t_cut of t_cut.
  split against fat (both plain, on the same rays): bit-equal, and the
    ordered "near" walk also in each ray's steps; the two push orders'
    any-hits: equal.

The ordered walks test a node's box only as a child box of its parent
row, so the split tables are held to accel.tables.check_child_boxes
where they are made. The card-marked tests run the three split-table
CUDA kernels against their plain versions (every output on every lane,
and the kernels' step counts), and #13 also at 17, 1,024 and 2^19 rays
and on a chunk of rays most of which start at t_max = -INF; they skip on
a machine without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptsharp_tpu.geometry.mesh import cube_mesh, sphere_mesh
from ptsharp_tpu.materials import diffuse_material
from ptsharp_tpu.pallas import ordered_kernel, wide_kernel
from ptsharp_tpu.scene import SceneBuilder

from ptsharp_tpu_torch.accel import tables
from ptsharp_tpu_torch.accel import traverse as walks
from ptsharp_tpu_torch.kernels import traverse

from tests.test_torch_kernels import CUDA_RAYS, _rays, _tied

N = 1000
SCENES = {"sphere2_k4": (2, 4), "sphere3_k8": (3, 8)}
# JAX reference runs of pallas_traverse_ordered8 -> their keyword arguments
ORDERED = {
    "full": dict(order_mode="full"),
    "near": dict(order_mode="near"),
    "full_defer_leaf_desc_gate": dict(order_mode="full", defer_leaf=True,
                                      desc_gate=True),
}


def _scene(subdivisions, k):
    b = SceneBuilder()
    b.add_mesh(sphere_mesh([0, 0.4, 0], 1.0, subdivisions=subdivisions),
               diffuse_material([0.5, 0.5, 0.5]))
    b.add_mesh(cube_mesh([1.6, -0.3, -0.3], [2.2, 0.3, 0.3]),
               diffuse_material([0.9, 0.6, 0.2]))
    return b.build(leaf_size=8, intersector="pallas", wide_k=k)


@pytest.fixture(scope="module", params=sorted(SCENES))
def ref(request):
    """A scene, its split tables, the rays and the JAX kernels' results."""
    sp = _scene(*SCENES[request.param])
    assert not sp.p_hbm
    org, d = _rays(N, seed=5)
    rng = np.random.default_rng(11)
    t_max = np.where(rng.random(N) < 0.1, -1e9,
                     np.where(rng.random(N) < 0.5, 1e9,
                              rng.uniform(0.5, 4.0, N))).astype(np.float32)
    t_cut = np.where(rng.random(N) < 0.1, -1.0,
                     rng.uniform(0.2, 6.0, N)).astype(np.float32)
    args = (sp.p_inst_base[0], sp.p_inst_end[0], sp.max_leaf, sp.wide_k)
    jo, jd, jt = jnp.asarray(org), jnp.asarray(d), jnp.asarray(t_max)
    ordered = {name: ordered_kernel.pallas_traverse_ordered8(
        sp.p_rows, sp.p_leaf, jo, jd, jt, *args, **kw)
        for name, kw in ORDERED.items()}
    packet = wide_kernel.pallas_traverse_wide(sp.p_rows, sp.p_leaf, jo, jd,
                                              jt, *args, tile=256)
    occ = ordered_kernel.pallas_occluded_ordered8(
        sp.p_rows, sp.p_leaf, jo, jd, jnp.asarray(t_cut), *args)
    fat = np.array(sp.p_fat)
    rows, leaf = tables.split_fat(fat, sp.max_leaf)
    tables.check_child_boxes(rows, sp.wide_k)
    return dict(
        fat=torch.from_numpy(fat), rows=torch.from_numpy(rows),
        leaf=torch.from_numpy(leaf), org=torch.from_numpy(org),
        dirn=torch.from_numpy(d), t_max=torch.from_numpy(t_max),
        t_cut=torch.from_numpy(t_cut), args=args,
        ordered={n: [np.asarray(x) for x in v] for n, v in ordered.items()},
        packet=[np.asarray(x) for x in packet], occ=np.asarray(occ))


def _split(ref):
    return ref["rows"], ref["leaf"], ref["org"], ref["dirn"]


def _assert_t(t, t_ref):
    assert (np.abs(t - t_ref) <= 1e-6).mean() >= 0.995
    np.testing.assert_allclose(t, t_ref, rtol=1e-5, atol=1e-5)


def _edge(ref):
    """Lanes whose nearest hit lies within 1e-5 * t_cut of t_cut."""
    t_near, _s, _u, _v = walks.closest_hit_plain(
        ref["fat"], ref["org"], ref["dirn"], torch.full((N,), 1e9),
        *ref["args"])
    tc = ref["t_cut"].numpy()
    return np.abs(t_near.numpy() - tc) <= 1e-5 * np.abs(tc)


@pytest.mark.parametrize("run", sorted(ORDERED))
def test_closest_hit_split_plain_matches_ordered8(ref, run):
    mode = ORDERED[run]["order_mode"]
    t, slot, u, v = walks.closest_hit_split_plain(
        *_split(ref), ref["t_max"], *ref["args"], order_mode=mode)
    t_ref, s_ref, u_ref, v_ref = ref["ordered"][run]
    hit = s_ref >= 0
    assert 0.2 < hit.mean() < 0.9
    _assert_t(t.numpy(), t_ref)
    np.testing.assert_array_equal(slot.numpy() >= 0, hit)
    tie = _tied(ref["fat"], ref["org"], ref["dirn"], ref["t_max"],
                ref["args"][2])
    same = hit & ~tie
    np.testing.assert_array_equal(slot.numpy()[same], s_ref[same])
    np.testing.assert_allclose(u.numpy()[same], u_ref[same], atol=1e-4)
    np.testing.assert_allclose(v.numpy()[same], v_ref[same], atol=1e-4)
    assert (t.numpy()[~hit] == 1e9).all()


@pytest.mark.parametrize("mode", walks.ORDER_MODES)
def test_any_hit_split_plain_matches_occluded_ordered8(ref, mode):
    occ = walks.any_hit_split_plain(*_split(ref), ref["t_cut"],
                                    *ref["args"], order_mode=mode).numpy()
    assert 0.1 < ref["occ"].mean() < 0.9
    edge = _edge(ref)
    np.testing.assert_array_equal(occ[~edge], ref["occ"][~edge])
    assert not occ[ref["t_cut"].numpy() <= 0].any()


def test_closest_hit_packet_plain_matches_traverse_wide(ref):
    t, slot, u, v = walks.closest_hit_packet_plain(
        *_split(ref), ref["t_max"], *ref["args"])
    t_ref, s_ref, u_ref, v_ref = ref["packet"]
    hit = s_ref >= 0
    assert 0.2 < hit.mean() < 0.9
    np.testing.assert_array_equal(slot.numpy(), s_ref)
    _assert_t(t.numpy(), t_ref)
    np.testing.assert_allclose(u.numpy()[hit], u_ref[hit], atol=1e-4)
    np.testing.assert_allclose(v.numpy()[hit], v_ref[hit], atol=1e-4)


def test_split_walks_equal_the_fat_walks(ref):
    """The same walks over the two table forms are bit-equal: the packet
    walk's plain version with the preorder walk, the ordered "near" walk
    with the fat ordered walk (which pushes "near"), and the two ordered
    any-hits."""
    fat, org, d, tm = ref["fat"], ref["org"], ref["dirn"], ref["t_max"]
    pairs = [
        (walks.closest_hit_packet_plain(*_split(ref), tm, *ref["args"]),
         walks.closest_hit_preorder_plain(fat, org, d, tm, *ref["args"])),
        (walks.closest_hit_split_plain(*_split(ref), tm, *ref["args"],
                                       order_mode="near"),
         walks.closest_hit_plain(fat, org, d, tm, *ref["args"])),
    ]
    for split, whole in pairs:
        for a, b in zip(split, whole):
            assert torch.equal(a, b)
    occ = walks.any_hit_split_plain(*_split(ref), ref["t_cut"],
                                    *ref["args"])
    assert torch.equal(occ, walks.any_hit_plain(fat, org, d, ref["t_cut"],
                                                *ref["args"]))


def test_split_near_walk_equals_the_fat_walk_in_steps(ref):
    """closest_hit_split_plain in the "near" order is closest_hit_plain
    over the fat table the split tables come from: all five outputs
    bit-equal, each ray's step count included."""
    fat, org, d, tm = ref["fat"], ref["org"], ref["dirn"], ref["t_max"]
    split = walks.closest_hit_split_plain(*_split(ref), tm, *ref["args"],
                                          order_mode="near",
                                          return_iters=True)
    whole = walks.closest_hit_plain(fat, org, d, tm, *ref["args"],
                                    return_iters=True)
    assert len(split) == len(whole) == 5
    for a, b in zip(split, whole):
        assert torch.equal(a, b)


def test_any_hit_split_orders_agree(ref):
    """The ordered any-hit visits each node at most once, so its two push
    orders give the same occlusion on every lane (the kernel runs one)."""
    occ = {m: walks.any_hit_split_plain(*_split(ref), ref["t_cut"],
                                        *ref["args"], order_mode=m)
           for m in walks.ORDER_MODES}
    assert 0.1 < float(occ["full"].float().mean()) < 0.9
    assert torch.equal(occ["full"], occ["near"])


@pytest.mark.parametrize("mode", walks.ORDER_MODES)
def test_step_counts(ref, mode):
    """return_iters adds each ray's step count and changes nothing else;
    a ray with t_max <= 0 misses the root box where its walk starts and
    takes no step."""
    out = walks.closest_hit_split_plain(
        *_split(ref), ref["t_max"], *ref["args"], order_mode=mode,
        return_iters=True)
    base, end = ref["args"][:2]
    steps = out[4].numpy()
    assert out[4].dtype == torch.int32 and steps.shape == (N,)
    assert (steps >= 0).all() and (steps <= end - base + 2).all()
    np.testing.assert_array_equal(steps[ref["t_max"].numpy() <= 0], 0)
    assert steps.mean() > 2
    plain = walks.closest_hit_split_plain(
        *_split(ref), ref["t_max"], *ref["args"], order_mode=mode)
    for a, b in zip(out[:4], plain):
        assert torch.equal(a, b)


def test_packet_walk_counts_its_steps(ref):
    """closest_hit_packet_plain(return_iters=True) changes no output; its
    steps (the steps closest_hit_packet's kernel counts) are the preorder
    walk's over the fat table, one for a ray that misses the root at
    t_max <= 0; on CPU tensors the wrapper raises on `counts`, which only
    the kernel keeps."""
    fat, org, d, tm = ref["fat"], ref["org"], ref["dirn"], ref["t_max"]
    *out, steps = walks.closest_hit_packet_plain(
        *_split(ref), tm, *ref["args"], return_iters=True)
    plain = walks.closest_hit_packet_plain(*_split(ref), tm, *ref["args"])
    assert all(torch.equal(a, b) for a, b in zip(out, plain))
    fat_steps = walks.closest_hit_preorder_plain(
        fat, org, d, tm, *ref["args"], return_iters=True)[-1]
    assert torch.equal(steps, fat_steps)
    np.testing.assert_array_equal(steps.numpy()[tm.numpy() <= 0], 1)
    assert float(steps.float().mean()) > 2
    with pytest.raises(ValueError, match="counts"):
        traverse.closest_hit_packet(*_split(ref), tm, *ref["args"],
                                    counts=torch.zeros(2, dtype=torch.int64))


def test_split_wrappers_take_the_plain_version_on_cpu(ref):
    traverse.reset_launch_counts()
    rows, leaf, org, d = _split(ref)
    t, slot, _u, _v = traverse.closest_hit_packet(rows, leaf, org, d,
                                                  ref["t_max"], *ref["args"])
    np.testing.assert_array_equal(slot.numpy(), ref["packet"][1])
    *hit, steps = traverse.closest_hit_split(rows, leaf, org, d,
                                             ref["t_max"], *ref["args"],
                                             order_mode="near",
                                             return_iters=True)
    _assert_t(hit[0].numpy(), ref["ordered"]["near"][0])
    assert steps.shape == (N,)
    occ = traverse.any_hit_split(rows, leaf, org, d, ref["t_cut"],
                                 *ref["args"])
    assert occ.dtype == torch.bool and occ.shape == (N,)
    assert all(w.launches == 0 for w in traverse.WRAPPERS)


@pytest.mark.parametrize("bad", ["leaf_device", "ray_device", "leaf_shape",
                                 "range", "order_mode"])
def test_split_wrappers_reject_bad_inputs(ref, bad):
    rows, leaf, org, d = _split(ref)
    tm = ref["t_max"]
    base, end, leaf_size, k = ref["args"]
    kw = {}
    if bad == "leaf_device":
        leaf = torch.empty(leaf.shape, device="meta")
    elif bad == "ray_device":
        org = torch.empty(org.shape, device="meta")
    elif bad == "leaf_shape":
        leaf = leaf[:, :64].contiguous()
    elif bad == "range":
        end = rows.shape[0] + 1
    else:
        kw = dict(order_mode="far")
    with pytest.raises(ValueError):
        traverse.closest_hit_split(rows, leaf, org, d, tm, base, end,
                                   leaf_size, k, **kw)
    with pytest.raises(ValueError):
        traverse.any_hit_split(rows, leaf, org, d, ref["t_cut"], base, end,
                               leaf_size, k, **kw)
    if bad != "order_mode":
        with pytest.raises(ValueError):
            traverse.closest_hit_packet(rows, leaf, org, d, tm, base, end,
                                        leaf_size, k)


@pytest.mark.cuda
def test_cuda_split_kernels_match_plain_versions(ref):
    """Runs on a machine with a card: the three split-table CUDA kernels
    against their plain versions on the same inputs, both push orders:
    every output on every lane, each ray's step count, the steps the
    kernels count (lane slots bound them), and the launch counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda")
    rows, leaf = ref["rows"].to(dev), ref["leaf"].to(dev)
    org, d = ref["org"].to(dev), ref["dirn"].to(dev)
    tm, tc = ref["t_max"].to(dev), ref["t_cut"].to(dev)
    args = ref["args"]
    traverse.reset_launch_counts()
    for mode in walks.ORDER_MODES:
        counts = torch.zeros((2, 2), dtype=torch.int64, device=dev)
        got = traverse.closest_hit_split(rows, leaf, org, d, tm, *args,
                                         order_mode=mode, return_iters=True,
                                         counts=counts[0])
        want = walks.closest_hit_split_plain(rows, leaf, org, d, tm,
                                             *args, order_mode=mode,
                                             return_iters=True)
        assert len(got) == len(want) == 5
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        occ = traverse.any_hit_split(rows, leaf, org, d, tc, *args,
                                     order_mode=mode, counts=counts[1])
        occ_p, steps_any = walks.any_hit_split_plain(
            rows, leaf, org, d, tc, *args,
            order_mode=traverse.SPLIT_ANY_HIT_ORDER, return_iters=True)
        assert torch.equal(occ, occ_p)
        assert counts[:, 0].tolist() == [int(want[4].sum()),
                                          int(steps_any.sum())]
        assert bool((counts[:, 0] <= counts[:, 1]).all())
    got = traverse.closest_hit_packet(rows, leaf, org, d, tm, *args)
    want = walks.closest_hit_packet_plain(rows, leaf, org, d, tm, *args)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    torch.cuda.synchronize()
    assert traverse.closest_hit_split.launches == 2
    assert traverse.any_hit_split.launches == 2
    assert traverse.closest_hit_packet.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("n", [*CUDA_RAYS, "chunk"])
def test_cuda_packet_walk_matches_plain_version(ref, n):
    """Runs on a machine with a card: the persistent preorder walk over
    the split tables (#13) against its plain version and against its twin
    over the fat table (#4), on the test's rays repeated or cut to n, and
    on a chunk of 8,192 rays with all but about 5% at t_max = -INF: every
    output on every lane, and the kernel's step count equal to the plain
    version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda")
    m = 8192 if n == "chunk" else n
    rep = -(-m // N)
    org, d, tm = (ref[x].repeat(rep, *([1] * (ref[x].dim() - 1)))[:m]
                  .contiguous().to(dev) for x in ("org", "dirn", "t_max"))
    if n == "chunk":
        g = np.random.default_rng(3)
        live = torch.from_numpy(g.random(m) < 0.05).to(dev)
        tm = torch.where(live, tm, torch.full_like(tm, -1e9)).contiguous()
    rows, leaf, fat = (ref[x].to(dev) for x in ("rows", "leaf", "fat"))
    args = ref["args"]
    traverse.reset_launch_counts()
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    got = traverse.closest_hit_packet(rows, leaf, org, d, tm, *args,
                                      counts=counts)
    *want, steps = walks.closest_hit_packet_plain(rows, leaf, org, d, tm,
                                                  *args, return_iters=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    twin = traverse.closest_hit_preorder(fat, org, d, tm, *args)
    assert all(torch.equal(a, b) for a, b in zip(got, twin))
    assert int(counts[0]) == int(steps.sum()) <= int(counts[1])
    assert traverse.closest_hit_packet.launches == 1
