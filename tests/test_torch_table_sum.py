"""The table sum (csrc/table_sum.cu, kernels/table_sum.py) and its two
call sites: the tape backward's sums into the parameter tables
(tape._tape_backward) and the atlas fetch's backward
(textures._TexelFetch).

CPU: the wrapper's plain path equals index_add_ bit for bit, float32 and
float64; the texel fetch's gradient equals index_select's backward bit
for bit, alone and through the tape on a 32x24 bunny; a render under
no_grad takes no fetch Function; the wrapper raises on a CUDA request
without the kernel library, a wrong dtype (float64 rows on a card),
shape, width or device and a non-contiguous input, launching nothing; the counters
count only while a profiler records, and perfbench's
table_sum_adds_per_lane.train reads them (nothing from a tree without
them).
Card (`-m cuda`, skipped without one; this file imports no JAX, so on a
machine with a card and no JAX: `python -m pytest --noconftest -m cuda
tests/test_torch_table_sum.py`): the kernel against a float64 index_add_
on all ids equal, the 3 material rows at the train cell's 2,073,600
lanes, the 4,096-row texel table with most rows zero, a table over the
shared-memory budget (the global path), a NaN row (added, not skipped)
and R = 0, with int32 and int64 ids; its counters on planted inputs on
both paths, and from inside autograd's backward; and the tape's colour
and texel gradients on the 32x24 bunny, kernel against the plain path.

Tolerance on the card: the kernel adds in another order than
index_add_, and in an order that changes from run to run, so each entry
is held to its float64 sum within 1e-4 of the sum of its rows' absolute
values (float32 round-off over a chain of at most a few hundred adds of
partial sums: a warp's shuffle tree, a block's shared-memory adds, one
add a block to device memory); the tape's gradients within 1e-4 of
their norms (perfbench's grad_gap reads at most 9.7e-5 on sound runs).
"""

import importlib.util
import os
import sys
import types
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ptsharp_tpu_torch import diff, examples, profiling, tape, textures
from ptsharp_tpu_torch.core import rng
from ptsharp_tpu_torch.kernels import build, table_sum
from ptsharp_tpu_torch.renderer import RenderConfig, Renderer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(r, w, m, dtype=torch.int64, zero_share=0.0, pile=None, seed=0,
            integer=False):
    """ids (r,) in [-2, m + 2) (some out of range, clamped), rows (r, w)
    float32 in [-1, 1) (`integer`: whole numbers in [-2, 2], whose sums
    float32 holds exactly in any order) with `zero_share` of them all
    zeros (half of those -0); `pile`: that id for every zero row, as the
    atlas's untextured lanes read texel 0."""
    g = np.random.default_rng(seed)
    ids = g.integers(-2, m + 2, r)
    rows = (g.integers(-2, 3, (r, w)) if integer
            else g.uniform(-1, 1, (r, w))).astype(np.float32)
    zero = g.random(r) < zero_share
    rows[zero] = 0.0
    rows[zero & (g.random(r) < 0.5)] = -0.0
    if pile is not None:
        ids[zero] = pile
    return (torch.from_numpy(ids).to(dtype), torch.from_numpy(rows))


# ---- the CPU ----------------------------------------------------------------


@pytest.mark.parametrize("floats", [torch.float32, torch.float64])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("r,w,m", [(0, 3, 4), (1, 1, 1), (1000, 5, 3),
                                   (4099, 3, 4096), (777, 8, 50)])
def test_plain_path_equals_index_add(r, w, m, dtype, floats):
    ids, rows = _inputs(r, w, m, dtype, zero_share=0.5, seed=r)
    rows = rows.to(floats)
    table_sum.reset_launch_counts()
    got = table_sum.table_sum(ids, rows, m)
    want = torch.zeros((m, w), dtype=floats).index_add_(
        0, ids.clamp(0, m - 1).long(), rows)
    assert got.dtype == floats and got.shape == (m, w)
    assert torch.equal(got, want)
    assert table_sum.table_sum.launches == 0


def test_texel_fetch_gradient_equals_index_select_backward():
    g = np.random.default_rng(3)
    texels = torch.from_numpy(g.random((4096, 3)).astype(np.float32))
    idx = torch.from_numpy(g.integers(0, 4096, 5000))
    idx[:3000] = 7  # a pile on one texel
    cot = torch.from_numpy(g.standard_normal((5000, 3)).astype(np.float32))
    cot[::3] = 0.0
    grads = []
    for fetch in (textures._TexelFetch.apply,
                  lambda t, i: t.index_select(0, i)):
        t = texels.clone().requires_grad_()
        out = fetch(t, idx)
        assert torch.equal(out, texels.index_select(0, idx))
        (gt,) = torch.autograd.grad(out, t, cot)
        grads.append(gt)
    assert torch.equal(grads[0], grads[1])


def _bunny(w=32, h=24):
    return examples.bunny(w, h, subdivisions=2, intersector="pallas",
                          wide_k=8, device="cpu")


def _counting_fetches(monkeypatch):
    """Count the texel fetches that take _TexelFetch."""
    seen = []
    apply = textures._TexelFetch.apply

    def counted(*args):
        seen.append(args[1].shape[0])
        return apply(*args)

    monkeypatch.setattr(textures._TexelFetch, "apply", counted)
    return seen


def test_a_render_under_no_grad_takes_no_fetch_function(monkeypatch):
    scene, cam, _rc, icfg = _bunny(16, 12)
    leaf = scene.textures.data.clone().requires_grad_()
    scene = tape.plug(scene, tape.DiffParams.of(scene)._replace(
        tex_data=leaf))
    seen = _counting_fetches(monkeypatch)
    film = Renderer(scene, cam, RenderConfig(16, 12, spp=1), icfg).render(
        key=rng.PRNGKey(0))
    assert torch.isfinite(film.mean).all()
    assert seen == []
    with torch.no_grad():
        diff.render_image(scene, cam, icfg, rng.PRNGKey(0), 16, 12, 1,
                          use_tape=True)
    assert seen == []


def _tape_grads(scene, cam, icfg, w, h):
    leaves = [x.detach().clone().requires_grad_()
              for x in tape.DiffParams.of(scene)]
    s = tape.plug(scene, tape.DiffParams(*leaves))
    img = diff.render_image(s, cam, icfg, rng.PRNGKey(5), w, h, 1,
                            use_tape=True)
    wts = torch.from_numpy(np.random.default_rng(1).random(
        (h, w, 3)).astype(np.float32)).to(img.device)
    return torch.autograd.grad((img * wts).sum(), leaves, allow_unused=True)


def test_tape_gradients_through_the_fetch_function_are_the_same_bits(
        monkeypatch):
    scene, cam, _rc, icfg = _bunny()
    seen = _counting_fetches(monkeypatch)
    got = _tape_grads(scene, cam, icfg, 32, 24)
    monkeypatch.setattr(textures._TexelFetch, "apply",
                        lambda t, i: t.index_select(0, i))
    want = _tape_grads(scene, cam, icfg, 32, 24)
    # four fetches a sample, one textured sample a depth of the tape
    assert len(seen) == 4 * (icfg.max_bounces + 1)
    assert float(want[4].abs().max()) > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    ids, rows = _inputs(64, 3, 10)
    table_sum.reset_launch_counts()
    bad = [
        (ids.float(), rows, 10),                 # ids dtype
        (ids, rows.long(), 10),                  # rows dtype
        (ids[None], rows, 10),                   # ids shape
        (ids[:63], rows, 10),                    # lengths differ
        (ids, rows[:, 0], 10),                   # rows shape
        (ids, torch.zeros((64, 0)), 10),         # width 0
        (ids, torch.zeros((64, 9)), 10),         # wider than the kernel
        (ids, torch.zeros((3, 64)).t(), 10),     # not contiguous
        (ids[::2], rows[::2].contiguous(), 10),  # ids not contiguous
        (ids, rows, 0),                          # an empty table
        (ids.to("meta"), rows.to("meta"), 10),   # no kernel for meta
        (ids.to("meta"), rows, 10),              # devices differ
    ]
    for args in bad:
        with pytest.raises(ValueError):
            table_sum.table_sum(*args)
    assert table_sum.table_sum.launches == 0


def test_a_cuda_request_without_the_library_raises(monkeypatch, tmp_path):
    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_nvcc", no_nvcc)
    table_sum.reset_launch_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # a fake tensor's data pointer
        with FakeTensorMode():
            ids = torch.zeros(64, dtype=torch.int64, device="cuda")
            rows = torch.ones((64, 3), device="cuda")
            with pytest.raises(ValueError):  # the kernel sums float32
                table_sum.table_sum(ids, rows.double(), 4)
            with pytest.raises(RuntimeError, match="nvcc not found"):
                table_sum.table_sum(ids, rows, 4)
    assert table_sum.table_sum.launches == 0


def test_counts_only_while_a_profiler_records():
    cpu = torch.device("cpu")
    profiling.reset_counters()
    assert profiling.table_sum_counts(cpu) is None
    with profile(activities=[ProfilerActivity.CPU]):
        counts = profiling.table_sum_counts(cpu)
        assert counts is profiling.table_sum_counts(cpu)
        counts += torch.tensor([100, 30, 12])
    assert profiling.table_sum_counters() == dict(lanes=100, active=30,
                                                  adds=12)
    profiling.reset_counters()
    assert profiling.table_sum_counters() == dict(lanes=0, active=0, adds=0)


def _adds_per_lane_reader():
    path = os.path.join(ROOT, "perfbench", "metrics",
                        "table_sum_adds_per_lane.train.py")
    spec = importlib.util.spec_from_file_location("t_adds_per_lane", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_adds_per_lane_reader(monkeypatch):
    """adds / lanes of a traced run; None without a trace, without the
    counter (a tree from before it) or with no lane summed."""
    read = _adds_per_lane_reader().read
    traced = {"trace": {"units": 2}}
    profiling.reset_counters()
    assert read(traced) is None
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.table_sum_counts(torch.device("cpu")).add_(
            torch.tensor([400, 30, 12]))
    assert read(traced) == 12 / 400
    assert read({"trace": None}) is None
    monkeypatch.setitem(sys.modules, "ptsharp_tpu_torch.profiling",
                        types.SimpleNamespace())
    assert read(traced) is None
    profiling.reset_counters()


# ---- the card ---------------------------------------------------------------

R_TRAIN = 1920 * 1080
# (r, w, m, zero share, pile): all ids equal; the tape's material sums
# (mid 5 wide, lm 4) at the train cell's lanes; the 64x64 marble's texel
# table with most lanes zero and piled on texel 0; a table over the
# kernel's 48 KiB shared-memory budget (the global path); mostly zero
# rows on each path; R = 0
CARD_CASES = {
    "all_equal": (100_003, 5, 1, 0.0, None),
    "material_mid": (R_TRAIN, 5, 3, 0.3, None),
    "material_lm": (R_TRAIN, 4, 3, 0.6, None),
    "texels": (R_TRAIN, 3, 4096, 0.9, 0),
    "global_path": (R_TRAIN, 3, 8192, 0.5, 0),
    "mostly_zero_shared": (300_000, 5, 3, 0.99, None),
    "mostly_zero_global": (300_000, 3, 100_000, 0.99, 0),
    "empty": (0, 3, 4096, 0.0, None),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _assert_close(got, ids, rows, m):
    """Each entry within 1e-4 of the sum of its rows' absolute values of
    the float64 sum (the module docstring's tolerance)."""
    i = ids.clamp(0, m - 1).long().cpu()
    r64 = rows.cpu().double()
    want = torch.zeros((m, rows.shape[1]), dtype=torch.float64) \
        .index_add_(0, i, r64)
    mass = torch.zeros_like(want).index_add_(0, i, r64.abs())
    err = (got.cpu().double() - want).abs()
    assert bool((err <= 1e-4 * mass).all()), float((err - 1e-4 * mass).max())


@pytest.mark.cuda
@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_kernel_matches_index_add(case, dtype, integer):
    """Whole-number rows sum exactly in any order (at most 2 x 2,073,600
    in size, below 2^24): there the kernel must equal the sum bit for
    bit, so a lost or doubled row shows."""
    dev = _card()
    r, w, m, zeros, pile = CARD_CASES[case]
    ids, rows = _inputs(r, w, m, dtype, zeros, pile, seed=len(case),
                        integer=integer)
    if case == "all_equal":
        ids.fill_(0)
    ids, rows = ids.to(dev), rows.to(dev)
    table_sum.reset_launch_counts()
    got = table_sum.table_sum(ids, rows, m)
    torch.cuda.synchronize()
    assert got.shape == (m, w) and got.device.type == "cuda"
    assert table_sum.table_sum.launches == (1 if r else 0)
    if integer:
        want = torch.zeros((m, w), dtype=torch.float64).index_add_(
            0, ids.clamp(0, m - 1).long().cpu(), rows.cpu().double())
        assert torch.equal(got.cpu().double(), want)
    _assert_close(got, ids, rows, m)
    if r == 0:
        assert not bool(got.any())


@pytest.mark.cuda
@pytest.mark.parametrize("m", [3, 100_000])
def test_a_nan_row_is_added(m):
    dev = _card()
    ids, rows = _inputs(50_000, 3, m, zero_share=0.5, seed=9)
    ids[1234], rows[1234] = 2, torch.tensor([float("nan"), 0.0, 0.0])
    got = table_sum.table_sum(ids.to(dev), rows.to(dev), m).cpu()
    assert bool(torch.isnan(got[2, 0]))
    keep = torch.ones(rows.shape[0], dtype=torch.bool)
    keep[1234] = False
    rest, rest_ids = rows[keep], ids[keep]
    # every entry but the NaN's against the float64 sum of the other rows
    i = rest_ids.clamp(0, m - 1).long()
    ref = torch.zeros((m, 3), dtype=torch.float64).index_add_(
        0, i, rest.double())
    mass = torch.zeros((m, 3), dtype=torch.float64).index_add_(
        0, i, rest.double().abs())
    err = (got.double() - ref).abs()
    err[2, 0] = 0.0
    assert bool((err <= 1e-4 * mass).all())


def _planted(dev, m):
    """Two warps of lanes, 2 wide: warp 0's 32 lanes all id 1, lanes 0-9
    nonzero in column 0 alone; warp 1's lane l id l % 4, every lane
    nonzero in column 0 and id 3's in column 1 too."""
    ids = torch.cat([torch.ones(32, dtype=torch.int64),
                     torch.arange(32) % 4])
    rows = torch.zeros((64, 2))
    rows[:10, 0] = 1.0
    rows[32:, 0] = 0.5
    rows[32:][ids[32:] == 3, 1] = 2.0
    return ids.to(dev), rows.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("m,adds", [
    # the shared path: the block adds the table's nonzero entries,
    # rows 0-3 of column 0 and row 3 of column 1
    (4, 5),
    # the global path (8,192 x 2 floats, over 48 KiB): warp 0's one
    # group adds column 0; warp 1's four groups column 0, id 3 column 1
    (8192, 6),
])
def test_counters_on_planted_inputs(m, adds):
    dev = _card()
    ids, rows = _planted(dev, m)
    profiling.reset_counters()
    got = table_sum.table_sum(ids, rows, m)  # no profiler: no counts
    assert profiling.table_sum_counters() == dict(lanes=0, active=0, adds=0)
    with profile(activities=[ProfilerActivity.CPU]):
        again = table_sum.table_sum(ids, rows, m)
    assert profiling.table_sum_counters() == dict(lanes=64, active=42,
                                                  adds=adds)
    profiling.reset_counters()
    want = torch.zeros((m, 2))
    want[0, 0] = want[2, 0] = want[3, 0] = 4.0
    want[1, 0] = 10.0 + 4.0
    want[3, 1] = 16.0
    assert torch.equal(got.cpu(), want) and torch.equal(again.cpu(), want)


@pytest.mark.cuda
def test_counts_from_inside_the_backward():
    """autograd runs a card's backward on a thread of its own; the
    profiler's state reaches it, so the fetch's kernel counts there."""
    dev = _card()
    texels = torch.rand((4096, 3), device=dev, requires_grad=True)
    idx = torch.randint(0, 4096, (10_000,), device=dev)
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        out = textures._TexelFetch.apply(texels, idx)
        (g,) = torch.autograd.grad(out.sum(), texels)
    c = profiling.table_sum_counters()
    profiling.reset_counters()
    assert c["lanes"] == 10_000 and c["active"] == 10_000 and c["adds"] > 0
    want = torch.zeros(4096, device=dev).index_add_(
        0, idx, torch.ones(10_000, device=dev))
    assert torch.equal(g, want[:, None].expand(4096, 3))


@pytest.mark.cuda
def test_tape_gradients_kernel_against_the_plain_path(monkeypatch):
    dev = _card()
    scene, cam, _rc, icfg = examples.bunny(32, 24, subdivisions=3,
                                           intersector="pallas", wide_k=8,
                                           device=dev)
    table_sum.reset_launch_counts()
    got = _tape_grads(scene, cam, icfg, 32, 24)
    # two material sums and four texel fetches a depth
    assert table_sum.table_sum.launches == 6 * (icfg.max_bounces + 1)
    monkeypatch.setattr(tape.table_sum, "table_sum", table_sum.plain)
    want = _tape_grads(scene, cam, icfg, 32, 24)
    for name, a, b in zip(tape.DiffParams._fields, got, want):
        a, b = a.double().reshape(a.shape[0], -1), b.double().reshape(
            b.shape[0], -1)
        gap = float((a - b).norm() / b.norm().clamp_min(1e-30))
        assert gap <= 1e-4, (name, gap)
    assert float(want[0].abs().max()) > 0 and float(want[4].abs().max()) > 0
