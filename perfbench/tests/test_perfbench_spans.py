"""The readers of the program's spans and lane counters
(`rng_host_ms.render`, `dispatch_idle_ms.render`, `lane_use_pct.render`,
`dispatch_idle_ms.train`), their interval arithmetic and the idle by
innermost span and lanes by depth that chip_spans.py prints
(`perfbench/spans.py`): exact on a hand-made trace, and on the record of
a `--cpu-toy --trace 1` run of each cell's loop. A CPU run has no device
operation, so the idle readers read nothing there until one is planted;
a record without the program's spans, as a program without them leaves,
reads nothing."""

import copy
import time

import numpy as np
import pytest

from perfbench import run, spans
from perfbench.run import load_module

MS = 1_000_000


def _reader(name):
    return load_module(f"perfbench/metrics/{name}.py",
                       "s_" + name.replace(".", "_"))


def _loop_result(workload, seed):
    """The result of one cell's loop at toy size with --trace 1, as
    run.main makes it."""
    args = run.parse(["--workload", workload, "--seed", str(seed),
                      "--seconds", "1", "--trace", "1", "--cpu-toy"])
    spec = run.cell_spec(workload)
    loop = load_module(f"perfbench/loops/{spec['traffic']['loop']}.py",
                       "s_loop_" + spec["traffic"]["loop"])
    ctx = {"args": args, "spec": spec, "root": run.ROOT,
           "t_start": time.time(), "hooks": {}}
    return spec, loop.run(ctx)


@pytest.fixture(scope="module")
def render_run():
    from ptsharp_tpu_torch import profiling

    profiling.reset_counters()
    spec, result = _loop_result("bunny.progressive", 2**31 + 29)
    # the counters are the process's: read them before anything else
    lane = _reader("lane_use_pct.render").read(result["record"])
    counters = profiling.counters()
    line = run.result_line(spec, result, True)
    profiling.reset_counters()
    return result, lane, counters, line


@pytest.fixture(scope="module")
def train_run():
    return _loop_result("bunny.train", 2**33 + 3)


def _hand_record():
    """Two passes of 10 ms, each with a 2 ms sync at its end; the device
    busy [1, 3] and [12, 19] ms; RNG spans [0, 2] with [1, 1.5] nested,
    and [10, 11]."""
    host = [(0, 10, "pt.pass"), (8, 10, "pt.sync"), (10, 20, "pt.pass"),
            (18, 20, "pt.sync"), (0, 2, "pt.rng.draw"),
            (1, 1.5, "pt.rng.keys"), (10, 11, "pt.rng.keys"),
            (0, 20, "aten::whatever"), (2, 9, "pt.step")]
    ops = [("k", 1 * MS, 2 * MS, True, False),
           ("k", 12 * MS, 7 * MS, True, False)]
    return {"trace": {
        "ops": ops, "window": (0, 20 * MS), "units": 2, "counts": {},
        "host": (np.array([int(a * MS) for a, _b, _n in host]),
                 np.array([int(b * MS) for _a, b, _n in host]),
                 [n for _a, _b, n in host])}}


def test_interval_arithmetic():
    assert spans.subtract([(0, 10), (20, 30)], [(2, 3), (8, 22)]) == \
        [(0, 2), (3, 8), (22, 30)]
    assert spans.subtract([(0, 10)], []) == [(0, 10)]
    assert spans.overlap([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert spans.overlap([(0, 1)], [(1, 2)]) == 0
    red = _hand_record()["trace"]
    assert spans.device_idle(red) == [(0, MS), (3 * MS, 12 * MS),
                                      (19 * MS, 20 * MS)]
    assert spans.named(red, "pt.pass") == [[0, 20 * MS]]


def test_readers_on_a_hand_made_trace():
    rec = _hand_record()
    # idle [0,1] + [3,12] + [19,20] inside pass less sync ([0,8], [10,18]):
    # 1 + 5 + 2 = 8 ms over 2 passes
    assert _reader("dispatch_idle_ms.render").read(rec) == \
        pytest.approx(4.0)
    # RNG: [0, 2] and [10, 11], the nested span once
    assert _reader("rng_host_ms.render").read(rec) == pytest.approx(1.5)
    # idle inside the step [2, 9]: [3, 9], 6 ms over 2 units
    assert _reader("dispatch_idle_ms.train").read(rec) == \
        pytest.approx(3.0)


def test_idle_by_innermost_span():
    """A 10 ms window: pt.pass [1, 9] holds pt.depth [2, 6] > pt.hit
    [3, 4], then pt.sync [7, 9]; the device busy [4, 5]."""
    host = [(1, 9, "pt.pass"), (2, 6, "pt.depth"), (3, 4, "pt.hit"),
            (7, 9, "pt.sync"), (0, 10, "aten::whatever")]
    red = {"ops": [("k", 4 * MS, MS, True, False)], "window": (0, 10 * MS),
           "units": 1,
           "host": (np.array([a * MS for a, _b, _n in host]),
                    np.array([b * MS for _a, b, _n in host]),
                    [n for _a, _b, n in host])}
    assert spans.innermost(red) == {
        "outside": [(0, MS), (9 * MS, 10 * MS)],
        "pt.pass": [(MS, 2 * MS), (6 * MS, 7 * MS)],
        "pt.depth": [(2 * MS, 3 * MS), (4 * MS, 6 * MS)],
        "pt.hit": [(3 * MS, 4 * MS)], "pt.sync": [(7 * MS, 9 * MS)]}
    got = spans.idle_by_span(red)
    # idle [0, 4] and [5, 10]: the hit's [4, 5] is busy
    assert got["idle_ms"] == 9.0 and got["traced_ms"] == 10.0
    assert got["idle_ms_by_innermost_span"] == {
        "outside": 2.0, "pt.pass": 2.0, "pt.depth": 2.0, "pt.sync": 2.0,
        "pt.hit": 1.0}
    assert got["spans_a_unit"] == {"pt.depth": 1.0, "pt.hit": 1.0,
                                   "pt.pass": 1.0, "pt.sync": 1.0}


def test_lanes_by_depth():
    got = spans.lanes_by_depth({
        1: {"alive": 75, "carried": 100, "survivors": 0},
        0: {"alive": 100, "carried": 100, "survivors": 0},
        2: {"alive": 40, "carried": 50, "survivors": 80}})
    assert list(got) == [0, 1, 2]
    assert got[0] == {"alive_pct": 100.0} and got[1] == {"alive_pct": 75.0}
    assert got[2] == {"alive_pct": 80.0, "dropped_pct": 50.0}


def test_readers_read_nothing_without_spans():
    rec = _hand_record()
    starts, ends, names = rec["trace"]["host"]
    rec["trace"]["host"] = (starts, ends,
                            [n.replace("pt.", "aten::") for n in names])
    for name in ("rng_host_ms.render", "dispatch_idle_ms.render",
                 "dispatch_idle_ms.train"):
        assert _reader(name).read(rec) is None, name
    for name in ("rng_host_ms.render", "dispatch_idle_ms.render",
                 "dispatch_idle_ms.train", "lane_use_pct.render"):
        assert _reader(name).read({"trace": None}) is None, name


def test_toy_render_record(render_run):
    result, lane, counters, line = render_run
    rec = result["record"]
    red = rec["trace"]
    # the RNG's host time: inside the traced window, a number
    rng_ms = _reader("rng_host_ms.render").read(rec)
    window_ms = (red["window"][1] - red["window"][0]) / MS
    assert 0 < rng_ms < window_ms / red["units"]
    # lanes: a share of the counted lanes, as the counters read
    alive = sum(d["alive"] for d in counters.values())
    carried = sum(d["carried"] for d in counters.values())
    assert 0 < lane <= 100
    assert lane == pytest.approx(100.0 * alive / carried)
    assert sorted(counters) == [0, 1, 2, 3, 4]
    # the toy's 32 x 24 x 2 lanes are fewer than a compaction's least cap
    # (4,096), so none engages and no depth drops lanes
    lanes = spans.lanes_by_depth(counters)
    assert all(list(lanes[d]) == ["alive_pct"] for d in lanes)
    assert all(0 < lanes[d]["alive_pct"] <= 100 for d in lanes)
    # no device operation on the CPU: nothing to be idle against
    assert red["ops"] == []
    assert _reader("dispatch_idle_ms.render").read(rec) is None
    assert _reader("dispatch_idle_ms.train").read(rec) is None
    # the result line of a --trace 1 run carries the readable ones
    assert line["correct"] is True
    assert {"rng_host_ms.render", "lane_use_pct.render"} <= \
        set(line["metrics"])
    assert "dispatch_idle_ms.render" not in line["metrics"]


def test_toy_render_record_with_a_device_operation(render_run):
    """A device operation planted over the first pass's first half: the
    idle the reader counts is the passes' time outside their syncs and
    outside the operation, within the window's idle time."""
    rec = copy.deepcopy(render_run[0]["record"])
    red = rec["trace"]
    p0, p1 = spans.named(red, "pt.pass")[0]
    busy = (p1 - p0) // 2
    red["ops"] = [("k", p0, busy, True, False)]
    got = _reader("dispatch_idle_ms.render").read(rec)
    host = spans.subtract(spans.named(red, "pt.pass"),
                          spans.named(red, "pt.sync"))
    window = red["window"][1] - red["window"][0]
    assert got == pytest.approx(
        (sum(b - a for a, b in host) - spans.overlap(host, [(p0, p0 + busy)]))
        / red["units"] / MS)
    assert 0 < got * red["units"] * MS <= window - busy


def test_toy_train_record(train_run):
    spec, result = train_run
    rec = result["record"]
    red = rec["trace"]
    assert spans.named(red, "pt.step")
    assert _reader("dispatch_idle_ms.train").read(rec) is None  # no device
    (s0, s1) = spans.named(red, "pt.step")[0]
    red = copy.deepcopy(red)
    red["ops"] = [("k", s0, (s1 - s0) // 4, True, False)]
    got = _reader("dispatch_idle_ms.train").read({"trace": red})
    steps = spans.named(red, "pt.step")
    total = sum(b - a for a, b in steps)
    assert got == pytest.approx(
        (total - (s1 - s0) // 4) / red["units"] / MS)
    line = run.result_line(spec, result, True)
    assert line["correct"] is True
    assert "dispatch_idle_ms.train" not in line["metrics"]
