"""The port's spans and lane counters (ptsharp_tpu_torch/profiling.py) on
the CPU at toy size: off, nothing is built and nothing is counted; under
a CPU torch.profiler a render records its spans nested pass > depth >
hit under their exact names and a train step its own; the film is the
same bits with a profiler recording and without; and the alive lanes
counted over the depth steps add up to the pass's ray count where no
shadow rays are traced."""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ptsharp_tpu_torch import examples, profiling
from ptsharp_tpu_torch.core import rng
from ptsharp_tpu_torch.parallel import shard
from ptsharp_tpu_torch.parallel.mesh import single_device_mesh
from ptsharp_tpu_torch.renderer import RenderConfig, Renderer

W, H, SPP = 64, 48, 2  # 6,144 lanes: the three compactions engage


def _bunny(**icfg_fields):
    scene, cam, _rc, icfg = examples.bunny(W, H, subdivisions=3,
                                           intersector="pallas", wide_k=8,
                                           device="cpu")
    return scene, cam, dataclasses.replace(icfg, **icfg_fields)


def _renderer(**icfg_fields):
    scene, cam, icfg = _bunny(**icfg_fields)
    return Renderer(scene, cam, RenderConfig(W, H, spp=SPP), icfg)


def _spans(prof):
    """{name: [(start_ns, end_ns)]} of the program's spans."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("pt."):
            out.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def _inside(inner, outer):
    return all(any(a <= s and t <= b for a, b in outer) for s, t in inner)


@pytest.fixture(autouse=True)
def _clear_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def test_no_profiler_builds_no_range_and_counts_nothing(monkeypatch):
    made = []

    def record_function(name):
        made.append(name)
        raise AssertionError("a range was built with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    assert profiling.span("pt.pass") is profiling.span("pt.depth")
    r = _renderer()
    r.render(key=rng.PRNGKey(3))
    assert made == [] and profiling.counters() == {}
    assert r.rays_traced > 0


def test_render_spans_nest_under_a_profiler():
    r = _renderer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.render(key=rng.PRNGKey(3))
    spans = _spans(prof)
    assert set(spans) == {"pt.pass", "pt.raygen", "pt.depth", "pt.hit",
                          "pt.occlusion", "pt.compact", "pt.merge",
                          "pt.sync", "pt.rng.keys", "pt.rng.draw"}
    assert len(spans["pt.pass"]) == 1 and len(spans["pt.sync"]) == 1
    # depths 0..4, one closest hit and one shadow query each
    assert len(spans["pt.depth"]) == 5 == len(spans["pt.hit"])
    assert len(spans["pt.occlusion"]) == 5
    assert len(spans["pt.compact"]) == 3  # before depths 2, 3, 4
    assert _inside(spans["pt.depth"], spans["pt.pass"])
    assert _inside(spans["pt.hit"], spans["pt.depth"])
    assert _inside(spans["pt.occlusion"], spans["pt.depth"])
    for name in ("pt.raygen", "pt.compact", "pt.merge", "pt.sync"):
        assert _inside(spans[name], spans["pt.pass"]), name


def test_train_step_spans_nest_under_a_profiler():
    scene, cam, icfg = _bunny()
    mesh = single_device_mesh("cpu")
    target = torch.zeros((H, W, 3))
    step = shard.make_train_step(cam, icfg, W, H, 1, mesh, lr=0.5)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(scene, rng.PRNGKey(5), target)
    spans = _spans(prof)
    assert len(spans["pt.step"]) == 1
    for name in ("pt.forward", "pt.backward", "pt.update"):
        assert len(spans[name]) == 1 and _inside(spans[name],
                                                 spans["pt.step"]), name
    assert _inside(spans["pt.depth"], spans["pt.forward"])
    # a render outside a Renderer pass counts no lanes
    assert profiling.counters() == {}


def test_film_is_the_same_bits_with_a_profiler():
    r = _renderer()
    plain = r.render(key=rng.PRNGKey(11))
    with profile(activities=[ProfilerActivity.CPU]):
        traced = r.render(key=rng.PRNGKey(11))
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


def test_alive_lanes_add_up_to_the_rays_traced():
    r = _renderer(direct_lighting=False)
    r.render(key=rng.PRNGKey(7))
    before = r.rays_traced
    with profile(activities=[ProfilerActivity.CPU]):
        r.render(key=rng.PRNGKey(7))
        r.render(key=rng.PRNGKey(8))
    c = profiling.counters()
    assert sorted(c) == [0, 1, 2, 3, 4]
    assert sum(d["alive"] for d in c.values()) == r.rays_traced - before
    lanes = W * H * SPP
    # full width at depths 0-1, then the caps of compaction_schedule
    # (max(4096, lanes / 2**k) < lanes), both passes
    assert [c[d]["carried"] for d in range(5)] == \
        [2 * lanes] * 2 + [2 * 4096] * 3
    assert [c[d]["survivors"] for d in (0, 1)] == [0, 0]
    for d in range(5):
        assert 0 < c[d]["alive"] <= c[d]["carried"]
    for d in (2, 3, 4):
        # the lanes a compaction keeps (at most its cap, the next step's
        # width) are the next step's alive lanes
        assert c[d]["alive"] == min(c[d]["survivors"], c[d]["carried"])
    profiling.reset_counters()
    assert profiling.counters() == {}
