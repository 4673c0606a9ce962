"""The memory-schedule closest-hit walks' plain versions against the JAX
package's Pallas kernels (interpret mode, as the JAX package's own tests
run them on the CPU): the two-packet ordered walk
pallas_traverse_ordered8_fat_dual with and without its MT gate, and the
preorder packet walks pallas_traverse_hbm8_fat_cache (fat block cache),
pallas_traverse_hbm8 (two 64-row block caches, in all three of its leaf
modes on one scene) and pallas_traverse_hbm8_row (a row copy a step). The
scenes, rays and t_max mix of tests/test_torch_split.py: the sphere +
cube scene at leaf 8, sphere at subdivisions 2 (K=4) and 3 (K=8); 1,000
rays, not a multiple of the dual kernel's 2,048-ray tile nor of the
others' 1,024, so their pad lanes are in play.

pallas_traverse_hbm8 asserts that both split tables are multiples of 64
rows, and pallas_traverse_hbm8_row clamps each leaf row to the last full
64-row block of its leaf table, so both run here on tables padded with
zero rows (accel.tables.pad_rows). test_row_stage_reference_fault pins
why the second one needs it.

Tolerances, those of test_torch_split.py: t within 1e-6 on at least
99.5% of lanes and within rtol 1e-5, atol 1e-5 on every lane (XLA's
fused multiply-adds on grazing triangles; ROADMAP Queue 3). Slots: equal
except ties for the dual walk (the JAX packets' consensus order differs
from a ray's own near-to-far order), equal on every lane for the
preorder packet walks. u, v within 1e-4 on hit lanes off ties.

The dual walk's plain version is the ordered walk of closest_hit_plain
(stack entries with their entry distance): each ray takes its steps.

The plain model of the warp-packet schedule of #10, #11 and #12
(accel.traverse.warp_packet_plain: packets of W lanes with one cursor each, and
the copies of its two-buffer rings or, for #11, one-row stages without
prefetch) at W = 1 takes each ray's own steps (closest_hit_packet_plain's),
and at W = 32 and 128 gives every lane the per-lane walk's (t, slot, u, v)
bit for bit, so it holds against the JAX block-cache kernels as the
per-lane walk does; #11's stage model does so on the unpadded split
tables. Its ring and stage counts hold against a step-by-step simulation
of the ring or stage on random reads and on the packets' own reads, and
the leaf rows that a packet's cursor reaches never decrease in these
tables, padded or not (a leaf ring that prefetches copies the next leaf
block).

The card-marked test runs the four CUDA kernels against their plain
versions, and their counts against the plain walks (#9's steps) and the
plain model of their schedule (#10-#12); it skips on a machine without a
card.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptsharp_tpu.pallas import hbm_kernel, ordered_kernel, wide_kernel

from ptsharp_tpu_torch.accel import tables
from ptsharp_tpu_torch.accel import traverse as walks
from ptsharp_tpu_torch.kernels import traverse

from tests.test_torch_kernels import _rays, _tied
from tests.test_torch_split import SCENES, _assert_t, _scene

N = 1000
BLK = traverse.CACHE_BLOCK_ROWS
# the scene on which pallas_traverse_hbm8 runs in every leaf mode
ALL_LEAF_MODES = "sphere2_k4"


@pytest.fixture(scope="module", params=sorted(SCENES))
def ref(request):
    """A scene, its port tables (fat, split, split padded to 64 rows), the
    rays, and the JAX kernels' results, each computed on first use."""
    sp = _scene(*SCENES[request.param])
    org, d = _rays(N, seed=5)
    rng = np.random.default_rng(11)
    t_max = np.where(rng.random(N) < 0.1, -1e9,
                     np.where(rng.random(N) < 0.5, 1e9,
                              rng.uniform(0.5, 4.0, N))).astype(np.float32)
    args = (sp.p_inst_base[0], sp.p_inst_end[0], sp.max_leaf, sp.wide_k)
    fat = np.array(sp.p_fat)
    rows, leaf = tables.split_fat(fat, sp.max_leaf)
    padded = [tables.pad_rows(x, BLK) for x in (rows, leaf)]
    jr = (jnp.asarray(org), jnp.asarray(d), jnp.asarray(t_max), *args)

    @functools.cache
    def jax_run(kernel, **kw):
        if kernel == "dual":
            out = ordered_kernel.pallas_traverse_ordered8_fat_dual(
                sp.p_fat, *jr, **kw)
        elif kernel == "fat_cache":
            out = hbm_kernel.pallas_traverse_hbm8_fat_cache(sp.p_fat, *jr)
        elif kernel == "block_cache":
            out = hbm_kernel.pallas_traverse_hbm8(*padded, *jr, **kw)
        else:
            out = hbm_kernel.pallas_traverse_hbm8_row(*padded, *jr)
        return [np.asarray(x) for x in out]

    t = torch.from_numpy
    return dict(
        name=request.param, fat=t(fat), rows=t(rows), leaf=t(leaf),
        padded=[t(x) for x in padded], org=t(org), dirn=t(d),
        t_max=t(t_max), args=args, jax=jax_run)


def _rays_of(ref):
    return ref["org"], ref["dirn"], ref["t_max"], *ref["args"]


def _assert_preorder_packet(got, want):
    """A preorder packet walk against its JAX kernel: slots on every
    lane, t to the stated tolerance, u and v on hit lanes."""
    t, slot, u, v = (x.numpy() for x in got)
    t_ref, s_ref, u_ref, v_ref = want
    hit = s_ref >= 0
    assert 0.2 < hit.mean() < 0.9
    np.testing.assert_array_equal(slot, s_ref)
    _assert_t(t, t_ref)
    np.testing.assert_allclose(u[hit], u_ref[hit], atol=1e-4)
    np.testing.assert_allclose(v[hit], v_ref[hit], atol=1e-4)
    assert (t[~hit] == 1e9).all()


@pytest.mark.parametrize("mt_gate", [False, True])
def test_closest_hit_dual_plain_matches_dual_kernel(ref, mt_gate):
    t, slot, u, v = walks.closest_hit_dual_plain(ref["fat"],
                                                 *_rays_of(ref))
    t_ref, s_ref, u_ref, v_ref = ref["jax"]("dual", mt_gate=mt_gate)
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


def test_closest_hit_fat_cache_plain_matches_fat_cache_kernel(ref):
    _assert_preorder_packet(
        walks.closest_hit_fat_cache_plain(ref["fat"], *_rays_of(ref)),
        ref["jax"]("fat_cache"))


def test_closest_hit_block_cache_plain_matches_hbm8(ref):
    got = walks.closest_hit_block_cache_plain(*ref["padded"],
                                              *_rays_of(ref))
    modes = (0, 1, 2) if ref["name"] == ALL_LEAF_MODES else (0,)
    for mode in modes:
        _assert_preorder_packet(got, ref["jax"]("block_cache",
                                                leaf_mode=mode))


def test_closest_hit_row_stage_plain_matches_hbm8_row(ref):
    _assert_preorder_packet(
        walks.closest_hit_row_stage_plain(*ref["padded"], *_rays_of(ref)),
        ref["jax"]("row_stage"))


def test_row_stage_reference_fault():
    """pallas_traverse_hbm8_row clamps every leaf row to the last full
    64-row block of the leaf table (hbm_kernel.py:328-332, 442), so on
    the 224-row leaf table of the subdivision-3 scene the leaves in rows
    192-223 read the wrong block. The port reads leaf[first // leaf_size]
    and gives the preorder walk's slot (pallas_traverse_wide8) on every
    lane; the JAX kernel does not."""
    sp = _scene(3, 8)
    org, d = _rays(N, seed=5)
    t_max = np.full(N, 1e9, np.float32)
    args = (sp.p_inst_base[0], sp.p_inst_end[0], sp.max_leaf, sp.wide_k)
    rows, leaf = tables.split_fat(np.array(sp.p_fat), sp.max_leaf)
    assert leaf.shape[0] == 224 and leaf.shape[0] % BLK
    jr = (jnp.asarray(org), jnp.asarray(d), jnp.asarray(t_max), *args)
    wide8 = [np.asarray(x) for x in wide_kernel.pallas_traverse_wide8(
        sp.p_rows, sp.p_leaf, *jr)]
    row = np.asarray(hbm_kernel.pallas_traverse_hbm8_row(
        sp.p_rows, sp.p_leaf, *jr)[1])
    got = walks.closest_hit_row_stage_plain(
        *map(torch.from_numpy, (rows, leaf, org, d, t_max)), *args)
    _assert_preorder_packet(got, wide8)
    assert (row != wide8[1]).sum() >= 1


def test_staged_walks_equal_the_fat_walks(ref):
    """The plain versions are bit-equal to the walks they schedule: the
    dual walk to the ordered walk, and the three preorder packet walks,
    over the fat table and over padded and unpadded split tables, to the
    preorder walk."""
    rays = _rays_of(ref)
    fat, split = ref["fat"], (ref["rows"], ref["leaf"])
    pre = walks.closest_hit_preorder_plain(fat, *rays)
    pairs = [
        (walks.closest_hit_dual_plain(fat, *rays),
         walks.closest_hit_plain(fat, *rays)),
        (walks.closest_hit_fat_cache_plain(fat, *rays), pre),
        (walks.closest_hit_block_cache_plain(*ref["padded"], *rays), pre),
        (walks.closest_hit_row_stage_plain(*ref["padded"], *rays), pre),
        (walks.closest_hit_row_stage_plain(*split, *rays), pre),
    ]
    for got, want in pairs:
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_dual_plain_takes_the_ordered_walks_steps(ref):
    """The dual walk's plain version takes closest_hit_plain's steps on
    every ray, the steps csrc/closest_hit_dual.cu counts, and gives its
    results."""
    *out, steps = walks.closest_hit_dual_plain(ref["fat"], *_rays_of(ref),
                                               return_iters=True)
    *want, want_steps = walks.closest_hit_plain(
        ref["fat"], *_rays_of(ref), return_iters=True)
    for a, b in zip(out, want):
        assert torch.equal(a, b)
    assert torch.equal(steps, want_steps)
    assert int(steps.sum()) > 0


def test_staged_wrappers_take_the_plain_version_on_cpu(ref):
    traverse.reset_launch_counts()
    rays = _rays_of(ref)
    runs = [
        (traverse.closest_hit_dual(ref["fat"], *rays),
         walks.closest_hit_dual_plain(ref["fat"], *rays)),
        (traverse.closest_hit_fat_cache(ref["fat"], *rays),
         walks.closest_hit_fat_cache_plain(ref["fat"], *rays)),
        (traverse.closest_hit_block_cache(*ref["padded"], *rays),
         walks.closest_hit_block_cache_plain(*ref["padded"], *rays)),
        (traverse.closest_hit_row_stage(ref["rows"], ref["leaf"], *rays),
         walks.closest_hit_row_stage_plain(ref["rows"], ref["leaf"],
                                           *rays)),
    ]
    for got, want in runs:
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert all(w.launches == 0 for w in traverse.WRAPPERS)


@pytest.mark.parametrize("table", ["rows", "leaf"])
def test_block_cache_rejects_tables_off_the_block(ref, table):
    padded = dict(zip(("rows", "leaf"), ref["padded"]))
    padded[table] = ref[table]
    assert padded[table].shape[0] % BLK
    with pytest.raises(ValueError, match="multiple of 64"):
        traverse.closest_hit_block_cache(padded["rows"], padded["leaf"],
                                         *_rays_of(ref))


@pytest.mark.parametrize("n, multiple", [(5, 4), (64, 64), (0, 64),
                                         (65, 64)])
def test_pad_rows(n, multiple):
    x = np.random.default_rng(n).random((n, 128), dtype=np.float32)
    y = tables.pad_rows(x, multiple)
    assert y.dtype == np.float32 and y.shape[1] == 128
    assert y.shape[0] % multiple == 0 and n <= y.shape[0] < n + multiple
    np.testing.assert_array_equal(y[:n], x)
    assert not y[n:].any()
    if n % multiple == 0:
        assert y is x


def _packet_tables(ref, table):
    """(node table, leaf table or None) of the warp-packet kernel over
    `table`: #12 over the fat table, #10 over the padded split tables."""
    return (ref["fat"], None) if table == "fat" else tuple(ref["padded"])


@pytest.mark.parametrize("table", ["fat", "split"])
def test_packet_model_at_width_one_takes_each_rays_steps(ref, table):
    *out, counts = walks.warp_packet_plain(
        *_packet_tables(ref, table), *_rays_of(ref), block_rows=8, width=1)
    *want, steps = walks.closest_hit_packet_plain(
        ref["rows"], ref["leaf"], *_rays_of(ref), return_iters=True)
    for a, b in zip(out, want):
        assert torch.equal(a, b)
    assert torch.equal(counts["packet_steps"], steps.to(torch.int64))
    assert torch.equal(counts["lane_steps"], steps.to(torch.int64))


@pytest.mark.parametrize("table", ["fat", "split"])
@pytest.mark.parametrize("width", [32, 128])
def test_packet_model_matches_lane_walk_and_jax_kernel(ref, width, table):
    """Every lane of a packet gets its own preorder walk's result, so the
    model equals the per-lane walk bit for bit and holds against the JAX
    kernel of the same table (#12 fat cache, #10 block cache) as it does;
    the packet walks the union of its lanes' nodes, fewer steps than its
    lanes take together."""
    *out, counts = walks.warp_packet_plain(
        *_packet_tables(ref, table), *_rays_of(ref), block_rows=8,
        width=width)
    *want, steps = walks.closest_hit_preorder_plain(
        ref["fat"], *_rays_of(ref), return_iters=True)
    for a, b in zip(out, want):
        assert torch.equal(a, b)
    _assert_preorder_packet(out, ref["jax"]("fat_cache" if table == "fat"
                                            else "block_cache"))
    assert counts["packet_steps"].shape == (-(-N // width),)
    assert int(counts["lane_steps"].sum()) == int(steps.sum())
    assert (counts["packet_steps"] <= counts["lane_steps"]).all()
    assert (counts["packet_steps"] >= 1).all()
    assert (counts["demand"] >= 1).all()
    assert (counts["used"] + counts["discarded"] <= counts["packet_steps"]
            * (1 if table == "fat" else 2)).all()


def _packet_walk(ref, tables, width=walks.PACKET_WIDTH):
    """The model's packet walk over split tables (rows, leaf), run to its
    end: its reads a step."""
    walk = walks.PacketWalk(
        walks.Table(*tables, ref["args"][2]), ref["org"], ref["dirn"],
        ref["t_max"].clone(), *ref["args"][:2], ref["args"][3], width)
    walks.walk_closest(walk, ref["args"][2])
    return walk


def _reads_by_packet(reads):
    """(packet, row) of every read in step order within each packet, the
    packets in order."""
    packet = torch.cat([p for p, _r in reads])
    rows = torch.cat([r for _p, r in reads])
    order = torch.sort(packet, stable=True).indices
    return packet[order], rows[order]


@pytest.mark.parametrize("padded", [True, False])
def test_leaf_rows_grow_along_the_packet_cursor(ref, padded):
    """A leaf ring that prefetches copies the block after the one in use:
    the leaf rows (first // leaf_size) of the leaf nodes grow with the node
    index in these tables, padded (#10's) or not (#11's), so along every
    packet's cursor too, as the model's reads show."""
    bits = ref["rows"].view(torch.int32)
    leaf_nodes = torch.nonzero((bits[:, 7] & 0xFF) > 0).squeeze(1)
    lj = bits[leaf_nodes, 6] // ref["args"][2]
    assert (lj[1:] > lj[:-1]).all()
    tables = ref["padded"] if padded else (ref["rows"], ref["leaf"])
    packet, rows = _reads_by_packet(_packet_walk(ref, tables).leaf_reads)
    same = packet[1:] == packet[:-1]
    assert same.any() and (rows[1:][same] >= rows[:-1][same]).all()


def _ring_by_steps(reads, block_rows, limit, prefetch=True):
    """The ring of TmaRing (csrc/bvh_common.cuh) run read by read over one
    packet's rows: (demand, used, discarded). Without `prefetch`, the
    one-buffer stage."""
    tag, cur, pre = [-1, -1], 0, [False, False]
    demand = used = discarded = 0

    def prefetch_next(s, blk):
        tag[s] = blk if blk * block_rows < limit else -1
        pre[s] = tag[s] >= 0

    for row in reads:
        blk = row // block_rows
        if tag[cur] == blk:
            continue
        if not prefetch:
            demand += 1
            tag[cur] = blk
            continue
        o = cur ^ 1
        if tag[o] == blk:
            used += 1
            pre[o] = False
            cur = o
            prefetch_next(o ^ 1, blk + 1)
        else:
            demand += 1
            tag[cur] = blk
            discarded += pre[o]
            pre[o] = False
            prefetch_next(o, blk + 1)
    return demand, used, discarded + sum(pre)


@pytest.mark.parametrize("prefetch", [True, False])
@pytest.mark.parametrize("block_rows, limit, seed", [(4, 200, 0), (8, 64, 1),
                                                     (16, 1000, 2)])
def test_ring_counts_follow_the_ring(block_rows, limit, seed, prefetch):
    """_ring_counts, which counts a ring's (or a stage's) copies from the
    reads of all packets at once, against the ring run read by read: rows
    mostly growing with jumps, repeats and, in some packets, a step
    back."""
    rng = np.random.default_rng(seed)
    n_packets, steps = 40, 30
    grow = rng.choice([0, 1, 2, block_rows, 3 * block_rows], (n_packets,
                                                              steps))
    rows = np.minimum(np.cumsum(grow, axis=1), limit - 1)
    back = rng.random(n_packets) < 0.2
    rows[back, steps // 2:] //= 3
    reads = [(torch.arange(n_packets), torch.from_numpy(rows[:, j]))
             for j in range(steps)]
    got = walks.ring_counts(reads, block_rows, limit, n_packets,
                            prefetch)
    want = np.array([_ring_by_steps(r, block_rows, limit, prefetch)
                     for r in rows])
    for j in range(3):
        np.testing.assert_array_equal(got[j].numpy(), want[:, j])


@pytest.mark.parametrize("width", [1, 32, 128])
def test_stage_model_on_unpadded_tables(ref, width):
    """#11's schedule, warp packets over one-row stages with no prefetch,
    on the unpadded split tables: every lane equals the per-lane preorder
    walk bit for bit (at width 1 each packet takes its ray's steps), and
    the stages' copies equal the stage run read by read over each packet's
    node rows and leaf rows: one demand copy a change of row."""
    rays = _rays_of(ref)
    split = (ref["rows"], ref["leaf"])
    *out, counts = walks.warp_packet_plain(*split, *rays, block_rows=1,
                                           width=width, prefetch=False)
    *want, steps = walks.closest_hit_preorder_plain(ref["fat"], *rays,
                                                    return_iters=True)
    for a, b in zip(out, want):
        assert torch.equal(a, b)
    assert int(counts["lane_steps"].sum()) == int(steps.sum())
    if width == 1:
        assert torch.equal(counts["packet_steps"], steps.to(torch.int64))
    walk = _packet_walk(ref, split, width)
    demand = np.zeros(-(-N // width), dtype=np.int64)
    for reads, limit in ((walk.node_reads, ref["args"][1]),
                         (walk.leaf_reads, ref["leaf"].shape[0])):
        packet, rows = _reads_by_packet(reads)
        for p in torch.unique(packet).tolist():
            demand[p] += _ring_by_steps(rows[packet == p].tolist(), 1, limit,
                                        prefetch=False)[0]
    np.testing.assert_array_equal(counts["demand"].numpy(), demand)
    assert not counts["used"].any() and not counts["discarded"].any()
    assert (counts["demand"] >= 1).all()


@pytest.mark.parametrize("prefetch", [True, False])
def test_packet_model_of_no_rays(ref, prefetch):
    """No ray, no packet: the model gives empty results and counts."""
    rays = [x[:0] for x in (ref["org"], ref["dirn"], ref["t_max"])]
    *out, counts = walks.warp_packet_plain(
        ref["rows"], ref["leaf"], *rays, *ref["args"], block_rows=1,
        prefetch=prefetch)
    assert all(x.shape == (0,) for x in out)
    assert all(counts[key].shape == (0,) for key in walks.PACKET_COUNTS)


@pytest.mark.parametrize("name", ["closest_hit_fat_cache",
                                  "closest_hit_block_cache",
                                  "closest_hit_row_stage",
                                  "closest_hit_dual"])
def test_packet_wrappers_take_no_counts_on_the_cpu(ref, name):
    tabs = {"closest_hit_block_cache": ref["padded"],
            "closest_hit_row_stage": (ref["rows"], ref["leaf"])}.get(
                name, (ref["fat"],))
    n_counts = 2 if name == "closest_hit_dual" else len(
        walks.PACKET_COUNTS)
    counts = torch.zeros(n_counts, dtype=torch.int64)
    with pytest.raises(ValueError, match="counts"):
        getattr(traverse, name)(*tabs, *_rays_of(ref), counts=counts)


@pytest.mark.cuda
def test_cuda_staged_kernels_match_plain_versions(ref):
    """Runs on a machine with a card: the four CUDA kernels against their
    plain versions on the same inputs, every lane equal, their launch
    counts, #9's steps against the ordered walk's, and the warp packets'
    counts against the plain model of their schedule."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda")
    fat = ref["fat"].to(dev)
    split = (ref["rows"].to(dev), ref["leaf"].to(dev))
    padded = tuple(x.to(dev) for x in ref["padded"])
    rays = (ref["org"].to(dev), ref["dirn"].to(dev), ref["t_max"].to(dev),
            *ref["args"])
    traverse.reset_launch_counts()
    runs = [
        (traverse.closest_hit_dual(fat, *rays),
         walks.closest_hit_dual_plain(fat, *rays)),
        (traverse.closest_hit_fat_cache(fat, *rays),
         walks.closest_hit_fat_cache_plain(fat, *rays)),
        (traverse.closest_hit_block_cache(*padded, *rays),
         walks.closest_hit_block_cache_plain(*padded, *rays)),
        (traverse.closest_hit_row_stage(*split, *rays),
         walks.closest_hit_row_stage_plain(*split, *rays)),
    ]
    torch.cuda.synchronize()
    for got, want in runs:
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    for w in (traverse.closest_hit_dual, traverse.closest_hit_fat_cache,
              traverse.closest_hit_block_cache,
              traverse.closest_hit_row_stage):
        assert w.launches == 1
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    traverse.closest_hit_dual(fat, *rays, counts=counts)
    steps = walks.closest_hit_dual_plain(fat, *rays, return_iters=True)[-1]
    assert int(counts[0]) == int(steps.sum()) <= int(counts[1])
    for w, tabs in ((traverse.closest_hit_fat_cache, (fat,)),
                    (traverse.closest_hit_block_cache, padded),
                    (traverse.closest_hit_row_stage, split)):
        counts = torch.zeros(len(walks.PACKET_COUNTS), dtype=torch.int64,
                             device=dev)
        got = w(*tabs, *rays, counts=counts)
        block_rows, _smem, prefetch = traverse.cache_layout(w)
        *model, mc = walks.warp_packet_plain(
            tabs[0], tabs[1] if len(tabs) > 1 else None, *rays,
            block_rows=block_rows, prefetch=prefetch)
        for a, b in zip(got, model):
            np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
        assert counts.tolist() == [int(mc[key].sum())
                                   for key in walks.PACKET_COUNTS]
