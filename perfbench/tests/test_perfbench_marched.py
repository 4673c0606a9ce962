"""The marched loop and its reference (loops/marched.py,
reference/marched.py, reference/sdf.py), and the march metrics
(march_ops.py and their readers): the command at toy size, the SDF nodes
against values worked by hand from SDF.cs's formulas, the tree's
operation count, the bfloat16 control failing the cell's limits at toy
size, and the readers' arithmetic on a hand-made trace."""

import json
import math
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from perfbench import common, march_ops, run
from perfbench.loops import marched as marched_loop
from perfbench.reference import marched, sdf, tracer
from perfbench.run import load_module

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MS = 1_000_000
MARCH_METRICS = ("march_device_ms.render", "march_launches_per_pass.render",
                 "march_lane_use_pct.render", "march_roofline")


def _conf():
    with open(os.path.join(ROOT, "perfbench", "configs",
                           "sdf_csg.json")) as f:
        return json.load(f)


def _reader(name):
    return load_module(f"perfbench/metrics/{name}.py",
                       "m_" + name.replace(".", "_"))


@pytest.mark.parametrize("trace", ["0", "1"])
def test_command_at_toy_size(trace):
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "sdf.final", "--seed", str(2**32 + 9), "--seconds",
                        "1", "--trace", trace, "--cpu-toy"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert set(line["checks"]) == {"samples_off", "z_max", "z_mean"}
    assert "not a measurement" in line["device"]["kind"]
    if trace == "0":
        assert set(line["metrics"]) == {"render_mpaths_s", "setup_s"}
    else:
        # a CPU run has no device operation: the counters alone read
        assert set(line["metrics"]) == {"scene_build_s",
                                        "march_lane_use_pct.render"}
        assert 0 < line["metrics"]["march_lane_use_pct.render"]["value"] \
            <= 100


def _at(node, *p, dtype=torch.float32):
    return float(sdf.field(node, "cpu", dtype)(torch.tensor([p], dtype=dtype))
                 [0])


def test_nodes_against_hand_worked_values():
    sphere = {"kind": "sphere", "radius": 1.0}
    cube = {"kind": "cube", "size": [2.0, 2.0, 2.0]}
    cyl = {"kind": "cylinder", "radius": 1.0, "height": 2.0}
    assert _at(sphere, 3, 4, 0) == 4.0
    assert _at(sphere, 0, 0.5, 0) == -0.5
    # the cube: outside a face, beyond an edge, inside
    assert _at(cube, 2, 0, 0) == 1.0
    assert _at(cube, 2, 2, 0) == pytest.approx(math.sqrt(2), abs=1e-7)
    assert _at(cube, 0.5, 0, 0) == -0.5
    # the cylinder: beside its side, above its cap, past its rim, inside
    assert _at(cyl, 3, 0, 4) == 4.0
    assert _at(cyl, 0, 3, 0) == 2.0
    assert _at(cyl, 4, 5, 0) == 5.0
    assert _at(cyl, 0, 0.25, 0.5) == -0.5
    # the operators at one point (0.5, 0, 0): sphere -0.5, cube -0.5
    small = {"kind": "sphere", "radius": 0.25}
    assert _at({"kind": "union", "items": [sphere, small]}, 0.5, 0, 0) \
        == -0.5
    assert _at({"kind": "intersection", "items": [sphere, small]},
               0.5, 0, 0) == 0.25
    assert _at({"kind": "difference", "items": [sphere, small]},
               0.5, 0, 0) == -0.25
    # a transform moves the child by M: up by 1, and a quarter turn about
    # z that lays the y-axis cylinder along x
    up = {"kind": "transform", "translate": [0, 1, 0], "child": sphere}
    assert _at(up, 0, 1, 0) == -1.0
    turned = {"kind": "transform",
              "rotate": {"axis": [0, 0, 1], "degrees": 90}, "child": cyl}
    assert _at(turned, 3, 0, 0) == pytest.approx(2.0, abs=1e-6)
    assert _at(turned, 0, 3, 0) == pytest.approx(2.0, abs=1e-6)
    # the configuration's tree: the drilled cube's bound, a face centre
    # drilled through (the bore's wall 0.55 away), a corner rounded by the
    # sphere
    tree = _conf()["scene"]["sdf"]["tree"]
    lo, hi = sdf.bounds(tree)
    np.testing.assert_allclose(lo, [-0.8, 0.2, -0.8], atol=1e-6)
    np.testing.assert_allclose(hi, [0.8, 1.8, 0.8], atol=1e-6)
    assert _at(tree, 0, 1.8, 0) == pytest.approx(0.55, abs=1e-6)
    assert _at(tree, 0.8, 1.8, 0.8) == pytest.approx(
        math.sqrt(3 * 0.64) - 1.05, abs=1e-6)


def test_normal_and_trace_on_a_sphere():
    f = sdf.field({"kind": "sphere", "radius": 1.0}, "cpu", torch.float32)
    f64 = sdf.field({"kind": "sphere", "radius": 1.0}, "cpu", torch.float64)
    o = torch.tensor([[0.0, 0.0, -3.0], [0.0, 2.0, -3.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    lo, hi = torch.full((3,), -1.0), torch.full((3,), 1.0)
    te, tx = sdf.box_clip(o, d, lo, hi)
    t = sdf.sphere_trace(f, o, d, te, tx)
    assert t[0] == pytest.approx(2.0, abs=2e-5) and t[1] == sdf.INF
    n = sdf.normal(f64, o[:1] + d[:1] * t[:1, None])
    np.testing.assert_allclose(n[0], [0, 0, -1], atol=1e-6)


def test_tree_operation_count():
    # the sphere 7, the cube 19, the cylinder 16, an affine 18; the tree:
    # translate(18) + difference(2) + intersection(19 + 7 + 1)
    # + union(16 + (18 + 16) + (18 + 16) + 2)
    tree = _conf()["scene"]["sdf"]["tree"]
    assert march_ops.node_ops({"kind": "sphere", "radius": 1}) == 7
    assert march_ops.node_ops({"kind": "cube", "size": [1, 1, 1]}) == 19
    assert march_ops.node_ops({"kind": "cylinder", "radius": 1,
                               "height": 1}) == 16
    assert march_ops.node_ops(tree) == 18 + 2 + 27 + 86 == 133
    assert march_ops.lane_step_ops(tree) == 133 + march_ops.STEP_OPS == 155


def test_bfloat16_control_fails_at_toy_size():
    spec = run.cell_spec("sdf.final")
    check = dict(spec["traffic"]["check"], **spec["traffic"]["toy_check"])
    limits = check["limits"]
    for seed in (1, 2**31 + 5):
        got = marched_loop.control(spec["config"], check, seed, 16, 32, 24,
                                   "cpu")
        assert any(got[k] > limits[k] for k in limits), got


def _hand_record():
    """One traced pass of 20 ms: `pt.march` spans [2, 6] and [10, 14] ms;
    kernels at [1, 3], [4, 5], [5.5, 7] and [12, 13] ms and a copy at
    [11, 11.5]."""
    host = [(0, 20, "pt.pass"), (2, 6, "pt.march"), (3, 4, "pt.march.check"),
            (10, 14, "pt.march")]
    ops = [("k", 1 * MS, 2 * MS, True, False),
           ("k", 4 * MS, 1 * MS, True, False),
           ("k", int(5.5 * MS), int(1.5 * MS), True, False),
           ("Memcpy DtoH", 11 * MS, MS // 2, False, False),
           ("k", 12 * MS, 1 * MS, True, False)]
    return {"sdf_tree": _conf()["scene"]["sdf"]["tree"], "trace": {
        "ops": ops, "window": (0, 20 * MS), "units": 1, "counts": {},
        "host": (np.array([int(a * MS) for a, _b, _n in host]),
                 np.array([int(b * MS) for _a, b, _n in host]),
                 [n for _a, _b, n in host])}}


@pytest.fixture
def counters(monkeypatch):
    """A program whose march counters read 4e9 active of 5e9 carried."""
    fake = types.SimpleNamespace(march_counters=lambda: {
        "closest": {"active": 3 * 10**9, "carried": 4 * 10**9},
        "shadow": {"active": 10**9, "carried": 10**9}})
    monkeypatch.setitem(sys.modules, "ptsharp_tpu_torch.profiling", fake)


def test_readers_on_a_hand_made_trace(counters):
    rec = _hand_record()
    # inside [2, 6] and [10, 14]: [2, 3], [4, 5], [5.5, 6], [11, 11.5],
    # [12, 13]: 4 ms
    assert _reader("march_device_ms.render").read(rec) == pytest.approx(4.0)
    # kernels starting inside: 4 and 5.5 and 12 (the copy left out)
    assert _reader("march_launches_per_pass.render").read(rec) == 3
    assert _reader("march_lane_use_pct.render").read(rec) == \
        pytest.approx(80.0)
    # 4e9 lane steps x 155 operations at 67 TFLOP/s over 4 ms
    want = 100.0 * (4e9 * 155 / common.PEAK_F32) / 4e-3
    assert _reader("march_roofline").read(rec) == pytest.approx(want)


def test_readers_read_nothing_without_spans_or_counters(monkeypatch):
    rec = _hand_record()
    red = rec["trace"]
    bare = dict(rec, trace=dict(red, host=(red["host"][0][:1],
                                           red["host"][1][:1],
                                           red["host"][2][:1])))
    monkeypatch.setitem(sys.modules, "ptsharp_tpu_torch.profiling",
                        types.SimpleNamespace())
    for name in MARCH_METRICS:
        assert _reader(name).read(bare) is None, name
        assert _reader(name).read({}) is None, name
    # the parent's program has the span and no counters
    assert _reader("march_device_ms.render").read(rec) == pytest.approx(4.0)
    assert _reader("march_lane_use_pct.render").read(rec) is None
    assert _reader("march_roofline").read(rec) is None


def test_reference_lens_spreads_origins_on_the_aperture():
    rs = marched.build(_conf()["scene"], "cpu")
    n = 64
    x = torch.full((n,), 16)
    half = torch.full((n,), 0.5)
    lu = torch.arange(n) / n
    o, d = marched.camera_rays(rs, x, x, 32, 24, half, half, lu,
                               torch.ones(n) - 1e-7)
    r = torch.linalg.vector_norm(o - rs.eye, dim=1)
    np.testing.assert_allclose(r, 0.06, rtol=1e-5)
    # every ray of the pixel sample passes the pinhole ray's point at the
    # focal distance
    o0, d0 = tracer.camera_rays(rs, x, x, 32, 24, half, half)
    focal = o0 + d0 * rs.focal_distance
    miss = torch.linalg.vector_norm(torch.cross(focal - o, d, dim=1), dim=1)
    assert float(miss.max()) < 1e-5
