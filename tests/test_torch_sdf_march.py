"""The sphere trace's kernel route (csrc/sdf_march.cu, kernels/sdf_march.py,
geometry/sdf.py compile_program and its routing, geometry/march.py fused).

CPU: the compiler covers every node kind of geometry/sdf.py, and its
program, run by `run_program` (a plain model of the kernel's interpreter
in torch ops), gives each tree's distances bit for bit; an unknown Sdf
subclass and every CPU tensor take the lockstep march (no launch), a tree
deeper than the kernel's stacks has no program; tensor constants are
gathered on the device and not cached; the wrapper raises on a wrong dtype, shape, layout
or device; a fused march's device counts reach the march counters and
march.COUNTS through a counted pass's read.
Card (`-m cuda`, skipped without one; this file imports no JAX, so on a
machine with a card and no JAX: `python -m pytest --noconftest -m cuda
tests/test_torch_sdf_march.py`): the kernel's hit t against the lockstep
march on the same card, bit for bit, over the trees of
tests/test_torch_shapes.py's sphere-trace cases (built here from the
port's classes; "sdf_scene" is the tree of the benchmark's sdf_csg
configuration), closest and shadow-cut, at 17 rays, the shape test's
2,048 and 2^19 (more than one persistent grid holds at once, so lanes
refill); its active lane steps equal the lockstep march's, one launch a
march, no host sync once its program is made; float64 rays and a tree
deeper than its stacks raise there, an unknown node kind marches in the
lockstep loop; and a 32x24 render of the sdf scene equal to the same render
with the kernel route off.

Tolerance: bit-equal everywhere.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ptsharp_tpu_torch import examples, profiling
from ptsharp_tpu_torch.core import rng, transform, vec
from ptsharp_tpu_torch.geometry import march, primitives
from ptsharp_tpu_torch.geometry import sdf as tsdf
from ptsharp_tpu_torch.kernels import sdf_march
from ptsharp_tpu_torch.renderer import RenderConfig, Renderer

CASES = {
    "sphere": lambda: tsdf.SdfSphere(0.9),
    "supersphere": lambda: tsdf.SdfSphere(0.9, exponent=3.0),
    "cube": lambda: tsdf.SdfCube((1.2, 0.8, 1.0)),
    "cylinder": lambda: tsdf.SdfCylinder(0.5, 1.4),
    "capsule": lambda: tsdf.SdfCapsule(a=(0, -0.4, 0.1), b=(0.3, 0.5, 0),
                                       radius=0.3),
    "capsule_n": lambda: tsdf.SdfCapsule(radius=0.3, exponent=4.0),
    "torus": lambda: tsdf.SdfTorus(0.8, 0.25),
    "torus_exponents": lambda: tsdf.SdfTorus(0.8, 0.25, major_exponent=3.0,
                                             minor_exponent=4.0),
    "union": lambda: tsdf.SdfSphere(0.6) | tsdf.SdfCube((1.4, 0.3, 0.3)),
    "difference": lambda: tsdf.SdfCube((1.2, 1.2, 1.2)) - tsdf.SdfSphere(0.75),
    "intersection": lambda: tsdf.SdfCube((1.2, 1.2, 1.2)) & tsdf.SdfSphere(
        0.8),
    "transform": lambda: tsdf.SdfTransform(
        tsdf.SdfCylinder(0.3, 1.5), transform.rotate([1.0, 0.5, 0.0], 0.7)),
    "scale": lambda: tsdf.SdfScale(tsdf.SdfTorus(0.6, 0.2), 1.5),
    "repeat": lambda: tsdf.SdfRepeat(tsdf.SdfSphere(0.2), (0.6, 0.6, 0.6),
                                     (-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)),
    "sdf_scene": lambda: examples.build("sdf", width=8, height=8,
                                        device="cpu")[0].sdf_objects[0][0],
    "love": lambda: examples.build("love", width=8, height=8,
                                   device="cpu")[0].sdf_objects[0][0],
}


def every_kind():
    """One tree with every node kind and both norms of each shape."""
    return tsdf.SdfUnion(
        tsdf.SdfSphere(0.5),
        tsdf.SdfTransform(tsdf.SdfSphere(0.4, exponent=3.0),
                          transform.translate([0.7, 0.0, 0.1])),
        tsdf.SdfCube((0.6, 0.4, 0.5)) - tsdf.SdfCylinder(0.2, 1.0),
        tsdf.SdfCapsule(a=(0.1, -0.4, 0), b=(0.2, 0.5, 0.1), radius=0.2)
        & tsdf.SdfCapsule(radius=0.25, exponent=4.0),
        tsdf.SdfScale(tsdf.SdfTorus(0.6, 0.2, major_exponent=3.0,
                                    minor_exponent=4.0), 1.5),
        tsdf.SdfRepeat(tsdf.SdfTorus(0.3, 0.1), (0.9, 0.8, 0.7),
                       (-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)),
        tsdf.SdfTorus(0.5, 0.1, major_exponent=2.0, minor_exponent=3.0),
    )


TREES = {**CASES, "every_kind": every_kind}


def run_program(prog, p):
    """The program's distances at p (R, 3): the kernel's interpreter in
    the torch ops geometry/sdf.py evaluates with (its plain model)."""
    k = prog.consts.cpu()
    ds, ps = [], []

    def pw(x, e):
        return vec.pow_f32(x, e)

    def norm(q, two, e, inv):
        if two:
            return vec.sqrt(vec.dot(q, q))
        return pw(vec.sum_last(pw(torch.abs(q), e)), inv)

    def capsule(c):
        pa, ba = p - c[0:3], c[3:6] - c[0:3]
        h = torch.clamp(vec.dot(pa, ba)
                        / torch.clamp(vec.dot(ba, ba), min=1e-12), 0.0, 1.0)
        return pa - ba * h[..., None]

    for op, off, flags in prog.code.cpu().tolist():
        name, c = sdf_march.OPS[op], k[off:]
        f = [float(x) for x in c[:12]]
        if name == "sphere":
            ds.append(vec.length(p) - f[0])
        elif name == "sphere_n":
            ds.append(pw(vec.sum_last(pw(torch.abs(p), f[0])), f[1]) - f[2])
        elif name == "cube":
            q = torch.abs(p) - c[0:3] / 2.0
            ds.append(vec.length(torch.clamp(q, min=0.0))
                      + torch.clamp(torch.amax(q, dim=-1), max=0.0))
        elif name == "cylinder":
            x, y, z = p.unbind(-1)
            q = torch.stack([vec.sqrt(x * x + z * z) - f[0],
                             torch.abs(y) - c[1] / 2.0], dim=-1)
            qp = torch.clamp(q, min=0.0)
            ds.append(vec.sqrt(vec.dot(qp, qp))
                      + torch.clamp(torch.amax(q, dim=-1), max=0.0))
        elif name == "capsule":
            ds.append(vec.length(capsule(c)) - f[6])
        elif name == "capsule_n":
            d = capsule(c)
            ds.append(pw(vec.sum_last(pw(torch.abs(d), f[7])), f[8]) - f[6])
        elif name == "torus":
            xy = p[..., :2]
            a = norm(xy, flags & sdf_march.TORUS_MAJOR_TWO, f[2], f[3]) - f[0]
            q = torch.stack([a, p[..., 2]], dim=-1)
            ds.append(norm(q, flags & sdf_march.TORUS_MINOR_TWO, f[4], f[5])
                      - f[1])
        elif name in ("union", "intersection", "difference"):
            e = ds.pop()
            d = ds.pop()
            ds.append(torch.minimum(d, e) if name == "union"
                      else torch.maximum(d, e if name == "intersection"
                                         else -e))
        elif name == "scale":
            ds.append(ds.pop() * c[0])
        elif name == "affine":
            ps.append(p)
            p = vec.affine(c[:12].reshape(3, 4), p)
        elif name == "divide":
            ps.append(p)
            p = p / c[0]
        elif name == "repeat":
            ps.append(p)
            p = torch.remainder(p, c[0:3]) - c[0:3] / 2.0
        elif name == "pop":
            p = ps.pop()
        else:
            raise AssertionError(name)
    assert len(ds) == 1 and not ps
    return ds[0]


def points(n, seed):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.uniform(-1.6, 1.6, (n, 3)).astype(np.float32))


def test_program_covers_every_node_kind():
    prog = tsdf.compile_program(every_kind(), "cpu")
    assert prog.code.dtype == torch.int32 and prog.code.shape[1] == 3
    assert prog.consts.dtype == torch.float32
    assert sorted(set(prog.code[:, 0].tolist())) == list(
        range(len(sdf_march.OPS)))
    assert 2 <= prog.depth <= sdf_march.STACK


@pytest.mark.parametrize("case", sorted(TREES))
def test_program_gives_the_trees_distances(case):
    tree = TREES[case]()
    prog = tsdf.compile_program(tree, "cpu")
    assert prog is not None and tsdf.compile_program(tree, "cpu") is prog
    p = points(4096, seed=len(case))
    assert torch.equal(run_program(prog, p), tree.evaluate(p))


class Bumpy(tsdf.SdfSphere):
    """A sphere subclass with its own distance: unknown to the compiler."""

    def evaluate(self, p):
        return super().evaluate(p) + 0.01 * torch.sin(8.0 * p[..., 0])


def _nested(depth):
    tree = tsdf.SdfSphere(0.5)
    for _ in range(depth - 1):
        tree = tsdf.SdfUnion(tsdf.SdfSphere(0.4), tree)
    return tree


def test_unknown_and_deep_trees_have_no_program():
    assert tsdf.compile_program(Bumpy(0.8), "cpu") is None
    assert tsdf.compile_program(tsdf.SdfUnion(tsdf.SdfCube(), Bumpy(0.5)),
                                "cpu") is None
    assert tsdf.compile_program(_nested(sdf_march.STACK), "cpu").depth \
        == sdf_march.STACK
    with pytest.raises(ValueError, match="sphere-trace kernel holds"):
        tsdf.compile_program(_nested(sdf_march.STACK + 1), "cpu")


@pytest.mark.parametrize("tree", ["unknown", "deep"])
def test_cpu_rays_take_the_lockstep_march_whatever_the_tree(tree):
    """The CPU route asks nothing of the compiler: an unknown node kind, a
    tree deeper than the kernel's stacks and float64 rays all march."""
    t = Bumpy(0.8) if tree == "unknown" else _nested(sdf_march.STACK + 1)
    org, d, te, tx = (x.double() for x in _box_rays(t, 128, seed=9))
    sdf_march.reset_launch_counts()
    assert tsdf._kernel_program(t, org, d, te, tx) is None
    hit = tsdf.sphere_trace(t, org, d, te, tx)
    assert sdf_march.march.launches == 0
    assert hit.dtype == torch.float64 and bool((hit < 1e8).any())


def test_tensor_constants_are_gathered_and_not_cached():
    r = torch.tensor(0.7)
    tree = tsdf.SdfTransform(tsdf.SdfSphere(r), transform.translate(
        [0.1, 0.2, 0.3]))
    prog = tsdf.compile_program(tree, "cpu")
    assert "cpu" not in tree._programs
    assert torch.equal(prog.consts[12], r)  # after the 3x4 affine
    p = points(512, seed=3)
    assert torch.equal(run_program(prog, p), tree.evaluate(p))


def _box_rays(tree, n, seed, cut=False):
    """Origins on a sphere around the tree's box, aimed at points in and
    around it (as tests/test_torch_shapes.py's rays_at_box), clipped to
    the box; with `cut`, each exit bounded by a shadow cut within it."""
    lo, hi = (np.asarray(b, np.float32) for b in tree.bounds())
    g = np.random.default_rng(seed)
    c, ext = (lo + hi) / 2, (hi - lo) / 2
    rad = 2.5 * float(np.linalg.norm(ext)) + 0.5
    u = g.normal(size=(n, 3))
    org = c + rad * u / np.linalg.norm(u, axis=1, keepdims=True)
    d = c + ext * g.uniform(-1.2, 1.2, (n, 3)) - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    org = torch.from_numpy(org.astype(np.float32))
    d = torch.from_numpy(d.astype(np.float32))
    te, tx = primitives.box_entry_exit(org, d, torch.from_numpy(lo),
                                       torch.from_numpy(hi))
    if cut:
        tx = torch.minimum(tx, te + (tx - te) * torch.from_numpy(
            g.uniform(0.0, 1.3, n).astype(np.float32)))
    return org, d, te, tx


def test_cpu_rays_take_the_lockstep_march():
    tree = CASES["love"]()
    org, d, te, tx = _box_rays(tree, 256, seed=5)
    sdf_march.reset_launch_counts()
    march.reset_counts()
    t = tsdf.sphere_trace(tree, org, d, te, tx, tag="closest")
    assert sdf_march.march.launches == 0
    assert march.COUNTS["closest"][1] > 0  # the lockstep loop's steps
    assert tsdf._kernel_program(tree, org, d, te, tx) is None
    assert bool((t < 1e8).any())
    march.reset_counts()


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "active",
                                 "counts", "device"])
def test_wrapper_rejects_bad_inputs(bad):
    prog = tsdf.compile_program(CASES["sphere"](), "cpu")
    n = 64
    org, d = torch.zeros(n, 3), torch.ones(n, 3)
    t0, tx = torch.zeros(n), torch.ones(n)
    active = torch.ones(n, dtype=torch.bool)
    counts = None
    match = "must be a contiguous"
    if bad == "dtype":
        org = org.double()
    elif bad == "shape":
        tx = tx[:-1]
    elif bad == "contiguous":
        d = torch.cat([d, d], dim=1)[:, ::2]
    elif bad == "active":
        active = active.float()
    elif bad == "counts":
        counts = torch.zeros(2, dtype=torch.int64)
    else:
        match = "no sdf march kernel"
    with pytest.raises(ValueError, match=match):
        sdf_march.march(prog, org, d, t0, tx, active, 10, counts)
    assert sdf_march.march.launches == 0


def test_fused_counts_reach_the_counters_through_the_pass_read():
    """A fused march under a profiler: its march counted at once in
    march.COUNTS, its device counts (checks 0) at the pass's read."""
    profiling.reset_counters()
    march.reset_counts()
    seen = []

    def launch(counts):
        seen.append(counts)
        if counts is not None:
            counts += torch.tensor([120, 160, 9])
        return torch.zeros(4)

    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.counted_pass() as tally:
            march.fused(launch, "closest", "cpu")
            march.fused(launch, None, "cpu")
            assert march.COUNTS["closest"] == [1, 0, 0]
            assert tally.read(torch.tensor(7)) == 7
    assert seen[1] is None
    assert march.COUNTS == {"closest": [1, 9, 160]}
    assert profiling.march_counters() == {"closest": dict(
        marches=1, steps=9, checks=0, carried=160, active=120)}
    # without a profiler: the march alone, no counts for the kernel
    march.fused(launch, "shadow", "cpu")
    assert seen[2] is None and march.COUNTS["shadow"] == [1, 0, 0]
    profiling.reset_counters()
    march.reset_counts()


# ---- the card ---------------------------------------------------------------

# rays of a march: fewer than a warp; tests/test_torch_shapes.py's count;
# more than the persistent grid holds at once (132 SMs x 2,048 threads at
# most), so that warps refill their lanes
CARD_RAYS = (17, 2048, 1 << 19)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _plain(monkeypatch):
    """Turn the kernel route off: every march takes the lockstep loop."""
    monkeypatch.setattr(tsdf, "_kernel_program", lambda *a: None)


def _active(fn, tag):
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    got = profiling.march_counters()[tag]
    profiling.reset_counters()
    return out, got


@pytest.mark.cuda
@pytest.mark.parametrize("n", CARD_RAYS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_march_matches_the_lockstep_march(case, n, monkeypatch):
    dev = _card()
    tree = CASES[case]()
    for tag, cut in (("closest", False), ("shadow", True)):
        org, d, te, tx = (x.to(dev) for x in _box_rays(tree, n, len(case),
                                                       cut))
        sdf_march.reset_launch_counts()
        got, counted = _active(
            lambda: tsdf.sphere_trace(tree, org, d, te, tx, tag=tag), tag)
        assert sdf_march.march.launches == 1
        assert counted["checks"] == 0 and counted["marches"] == 1
        assert counted["active"] <= counted["carried"]
        assert counted["steps"] <= tsdf.TRACE_MAX_STEPS
        with monkeypatch.context() as m:
            _plain(m)
            want, plain = _active(
                lambda: tsdf.sphere_trace(tree, org, d, te, tx, tag=tag), tag)
        assert sdf_march.march.launches == 1
        assert torch.equal(got, want), (case, tag, n, int((got != want).sum()))
        assert counted["active"] == plain["active"]
        # the lockstep loop runs its slowest lane's steps up to its next
        # check
        every = march.CHECK_EVERY
        assert plain["steps"] == min(-(-counted["steps"] // every) * every,
                                     tsdf.TRACE_MAX_STEPS)
        if n >= 2048:
            assert bool((got < 1e8).any()) and bool((got >= 1e8).any())


@pytest.mark.cuda
def test_kernel_march_makes_no_host_sync():
    dev = _card()
    tree = CASES["sdf_scene"]()
    org, d, te, tx = (x.to(dev) for x in _box_rays(tree, 4099, seed=2))
    tsdf.sphere_trace(tree, org, d, te, tx, tag="closest")
    torch.cuda.synchronize()
    sdf_march.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t = tsdf.sphere_trace(tree, org, d, te, tx, tag="closest")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert sdf_march.march.launches == 1 and t.shape == (4099,)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["float64", "deep"])
def test_card_rays_the_kernel_cannot_take_raise(bad):
    """On a card only an unknown node kind takes the lockstep loop: float64
    rays and a tree deeper than the kernel's stacks raise, launching
    nothing."""
    dev = _card()
    tree = (CASES["sdf_scene"]() if bad == "float64"
            else _nested(sdf_march.STACK + 1))
    rays = (x.to(dev) for x in _box_rays(tree, 256, seed=4))
    if bad == "float64":
        rays = (x.double() for x in rays)
    org, d, te, tx = rays
    sdf_march.reset_launch_counts()
    match = "float32 rays" if bad == "float64" else "kernel holds"
    with pytest.raises(ValueError, match=match):
        tsdf.sphere_trace(tree, org, d, te, tx, tag="closest")
    assert sdf_march.march.launches == 0


@pytest.mark.cuda
def test_card_rays_of_an_unknown_tree_take_the_lockstep_march():
    dev = _card()
    tree = tsdf.SdfUnion(tsdf.SdfCube((1.0, 1.0, 1.0)), Bumpy(0.5))
    org, d, te, tx = (x.to(dev) for x in _box_rays(tree, 256, seed=6))
    sdf_march.reset_launch_counts()
    march.reset_counts()
    hit = tsdf.sphere_trace(tree, org, d, te, tx, tag="closest")
    assert sdf_march.march.launches == 0
    assert march.COUNTS["closest"][1] > 0  # the lockstep loop's steps
    assert bool((hit < 1e8).any())
    march.reset_counts()


@pytest.mark.cuda
def test_sdf_render_equals_the_lockstep_render(monkeypatch):
    dev = _card()
    scene, cam, _rc, icfg = examples.build("sdf", width=32, height=24,
                                           device=dev)
    cfg = RenderConfig(32, 24, spp=2)
    sdf_march.reset_launch_counts()
    film = Renderer(scene, cam, cfg, icfg).render(key=rng.PRNGKey(11))
    launches = sdf_march.march.launches
    assert launches > 0
    with monkeypatch.context() as m:
        _plain(m)
        plain = Renderer(scene, cam, cfg, icfg).render(key=rng.PRNGKey(11))
    assert sdf_march.march.launches == launches
    for name in ("mean", "m2", "n"):
        assert torch.equal(getattr(film, name), getattr(plain, name)), name
