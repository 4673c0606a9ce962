"""The yardstick's arithmetic: peaks and bytes, the roofline share, the
kernel classes, the percentile over all passes, the interval union and
gaps, the guard against JAX and the JAX package, and the readers."""

import math
import os
import sys

import numpy as np
import pytest

from perfbench import checks, common, devtrace
from perfbench.run import load_module

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def test_peaks_and_query_bytes():
    assert common.PEAK_BYTES == 3.35e12 and common.PEAK_F32 == 67e12
    # closest hit: R * (28 + 16) + launches * T * 36
    assert common.query_bytes(1000, 2, 10, common.CLOSEST_OUT_BYTES) \
        == 1000 * 44 + 2 * 10 * 36
    assert common.query_bytes(1000, 1, 10, common.ANY_OUT_BYTES) \
        == 1000 * 29 + 360


def test_roofline_pct():
    # 3.35 GB in 1 ms at 3.35 TB/s is the bound itself
    assert common.roofline_pct(3.35e9, 1e-3) == pytest.approx(100.0)
    assert common.roofline_pct(3.35e9, 2e-3) == pytest.approx(50.0)
    assert common.roofline_pct(0, 1e-3) is None
    assert common.roofline_pct(1e9, 0) is None


@pytest.mark.parametrize("name, kind", [
    ("void closest_hit_kernel<8, (Push)1>(Table, float const*)",
     "traversal"),
    ("void any_hit_kernel<8>(Table)", "traversal"),
    ("tlas_walk_kernel<false, 8, true>", "traversal"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "collective"),
    ("void at::native::radixSortKVInPlace<-2, -1, 32, 4>", "sort"),
    ("void at::native::index_elementwise_kernel<128, 4>", "gather/scatter"),
    ("void at::native::reduce_kernel<512, 1>", "reduction"),
    ("void at::native::vectorized_elementwise_kernel<4, AddFunctor>",
     "elementwise/other"),
])
def test_kinds(name, kind):
    assert common.kind_of(name) == kind


def test_percentile_over_all_values():
    v = list(range(1, 101))  # 1..100
    assert common.percentile(v, 90) == 90
    assert common.percentile(v, 100) == 100
    assert common.percentile([5.0], 90) == 5.0
    assert common.percentile(list(reversed(v)), 50) == 50


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7)]
    assert common.union_length(iv) == pytest.approx(4.0)
    assert common.gaps(iv, 0, 8) == [(3, 5), (6, 8)]
    assert common.union_length([]) == 0.0
    m = common.merge(iv)
    assert m == [[0, 3], [5, 6]]
    starts = [a for a, _b in m]
    assert common.inside(m, starts, 2.5) and not common.inside(m, starts, 4)


def test_forbidden_modules_compare_whole_names(monkeypatch):
    before = common.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ptsharp_tpu_torch_fake", object())
    assert common.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "ptsharp_tpu.fake", object())
    assert "ptsharp_tpu" in common.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax", object())
    assert "jax" in common.forbidden_modules()


def test_run_key_takes_large_seeds():
    a, b = checks.run_key(2**31 + 5), checks.run_key(5)
    assert a != b
    assert checks.run_key(2**31 + 5) == a
    assert all(0 <= w < 2**32 for w in a)


def _trace_record():
    # two passes: a closest hit of 1 ms, an any hit of 0.5 ms, 2 ms of
    # other kernels, a copy; the window 10 ms
    ms = 1_000_000
    ops = [("void closest_hit_kernel<8, (Push)1>(T)", 0, ms, True, False),
           ("void any_hit_kernel<8>(T)", 2 * ms, ms // 2, True, False),
           ("vectorized_elementwise_kernel", 3 * ms, 2 * ms, True, True),
           ("Memcpy DtoH", 6 * ms, ms, False, False)]
    return {"trace": {"ops": ops, "window": (0, 10 * ms), "units": 2,
                      "counts": {"closest_hit": (2, 1_000_000),
                                 "any_hit": (2, 500_000)},
                      "host": (np.array([0]), np.array([10 * ms]),
                               ["aten::pass"])},
            "triangles": 1000, "busy_s": 4.5e-3, "traced_s": 1e-2,
            "setup_s": 12.5, "scene_build_s": 3.0}


def _reader(name):
    return load_module(f"perfbench/metrics/{name}.py",
                       "t_" + name.replace(".", "_"))


def test_readers_on_a_trace():
    rec = _trace_record()
    assert _reader("launches_per_pass.render").read(rec) == 1.5
    assert _reader("integrator_device_ms.render").read(rec) \
        == pytest.approx((2 + 1) / 2)
    ch = common.query_bytes(1_000_000, 2, 1000, 16)
    assert _reader("closest_hit_roofline").read(rec) == pytest.approx(
        100 * ch / 3.35e12 / 1e-3)
    assert _reader("device_idle_pct.render").read(rec) \
        == pytest.approx(55.0)
    assert _reader("backward_device_ms.train").read(rec) \
        == pytest.approx(1.0)
    assert _reader("allreduce_device_ms.train").read(rec) is None
    assert _reader("scene_build_s").read(rec) == 3.0
    assert _reader("setup_s").read(rec) == 12.5


def test_readers_find_nothing_without_a_trace():
    rec = {"setup_s": 1.0, "trace": None}
    for name in ("launches_per_pass.render", "closest_hit_roofline",
                 "any_hit_roofline", "device_idle_pct.train",
                 "backward_device_ms.train", "allreduce_device_ms.train",
                 "render_mpaths_s", "train_step_ms", "pass_p90_ms"):
        assert _reader(name).read(rec) is None


def test_end_to_end_readers():
    rec = {"paths": 4_147_200 * 10, "window_s": 3.0,
           "pass_s": [0.3] * 9 + [0.5], "steps": 8}
    assert _reader("render_mpaths_s").read(rec) \
        == pytest.approx(4.1472 * 10 / 3)
    assert _reader("pass_p90_ms").read(rec) == pytest.approx(300.0)
    assert _reader("train_step_ms").read(rec) == pytest.approx(375.0)


def test_busy_and_breakdown():
    rec = _trace_record()["trace"]
    assert devtrace.busy_s(rec) == pytest.approx(4.5e-3)
    b = devtrace.breakdown(rec)
    assert b["device_ops"][0][0].startswith("vectorized")
    assert len(b["idle_gaps"]) <= 10
    assert math.isclose(sum(g for _n, g in b["idle_gaps"]), 5.5e-3)
    assert b["idle_gaps"][0][0] == "aten::pass"
