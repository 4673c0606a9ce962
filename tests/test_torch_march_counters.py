"""The marches' counters and span (geometry/march.py, profiling.py) on the
CPU, and the SDF scene of the benchmark's sdf_csg configuration against
its plain reference (perfbench/reference/marched.py) at 32x24: the
depth-0 hits and normals lane by lane, and the film by the cell's tile
rule."""

import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench.loops import marched as marched_loop
from perfbench.reference import marched as rmarched
from ptsharp_tpu_torch import examples, intersect, profiling
from ptsharp_tpu_torch.core import rng
from ptsharp_tpu_torch.geometry import march
from ptsharp_tpu_torch.renderer import RenderConfig, Renderer
from ptsharp_tpu_torch.scene import PT_NONE, PT_PLANE, PT_SDF, PT_SPHERE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 32, 24
# the port's primitive codes as the reference's kinds
KINDS = {PT_NONE: 0, PT_PLANE: 1, PT_SPHERE: 2, PT_SDF: rmarched.SDF_KIND}


def _conf():
    with open(os.path.join(ROOT, "perfbench", "configs",
                           "sdf_csg.json")) as f:
        return json.load(f)


def _traffic():
    with open(os.path.join(ROOT, "perfbench", "traffic",
                           "marched_final.json")) as f:
        return json.load(f)


@pytest.fixture(autouse=True)
def _clear_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def _render(seed=5, spp=2):
    scene, cam, _rc, icfg = examples.build("sdf", width=W, height=H,
                                           device="cpu")
    r = Renderer(scene, cam, RenderConfig(W, H, spp=spp), icfg)
    return r, r.render(key=rng.PRNGKey(seed))


def _counted_render(every, monkeypatch):
    monkeypatch.setattr(march, "CHECK_EVERY", every)
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        _r, film = _render()
    return profiling.march_counters(), film


def test_march_counters_agree_across_check_intervals(monkeypatch):
    """Marches and active lane steps are the work itself: equal at a check
    after every step and at the default interval (the steps, the carried
    lanes and the checks are the schedule's, and may differ)."""
    assert march.CHECK_EVERY == 8
    one, film1 = _counted_render(1, monkeypatch)
    eight, film8 = _counted_render(8, monkeypatch)
    assert torch.equal(film1.mean, film8.mean)
    assert set(one) == set(eight) == {"closest", "shadow"}
    for tag in one:
        a, b = one[tag], eight[tag]
        assert a["marches"] == b["marches"] > 0
        assert a["active"] == b["active"] > 0
        assert a["checks"] > b["checks"] > 0
        for c in (a, b):
            assert c["active"] <= c["carried"]
            assert c["checks"] <= c["steps"] + c["marches"]


def test_march_counts_nothing_outside_a_profiler():
    march.reset_counts()
    _render()
    assert profiling.march_counters() == {}
    # COUNTS still counts every march, as chip_smoke reads it
    assert march.COUNTS["closest"][0] > 0 and march.COUNTS["shadow"][0] > 0
    march.reset_counts()


def test_a_mesh_render_counts_no_march():
    """The mesh cells' scenes march nothing: under a profiler their
    passes leave the march counters empty."""
    scene, cam, _rc, icfg = examples.bunny(W, H, subdivisions=2,
                                           intersector="pallas", wide_k=8,
                                           device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        Renderer(scene, cam, RenderConfig(W, H, spp=2), icfg).render(
            key=rng.PRNGKey(4))
    assert profiling.counters() and profiling.march_counters() == {}


def test_reset_counters_clears_the_march_counters(monkeypatch):
    got, _film = _counted_render(8, monkeypatch)
    assert got
    profiling.reset_counters()
    assert profiling.march_counters() == {}


def test_march_check_span_nests_in_the_march_span():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _render()
    spans = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("pt.march"):
            spans.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    outer, inner = spans["pt.march"], spans["pt.march.check"]
    assert len(inner) >= len(outer) > 0
    assert all(any(a <= s and t <= b for a, b in outer) for s, t in inner)
    checks = sum(c["checks"] for c in profiling.march_counters().values())
    assert checks == len(inner)


def _depth0(dtype=torch.float32):
    """The port's camera rays of every pixel at 4 jittered lens samples,
    its closest hit and shading normal, and the reference's on the same
    rays in `dtype`."""
    scene, cam, _rc, _icfg = examples.build("sdf", width=W, height=H,
                                            device="cpu")
    g = torch.Generator().manual_seed(17)
    n = 4 * W * H
    ys = torch.arange(n) // W % H
    xs = torch.arange(n) % W
    ju, jv, lu, lv = torch.rand((4, n), generator=g)
    org, dirn = cam.cast_rays(xs, ys, W, H, ju, jv, lu, lv)
    hit = intersect.closest_hit(scene, org, dirn)
    info = intersect.hit_info(scene, org, dirn, hit)
    rs = rmarched.build(_conf()["scene"], "cpu", dtype)
    o, d = org.to(dtype), dirn.to(dtype)
    t, kind, idx, _u, _v = rmarched.Walker(rs).closest(o, d)
    _pos, normal, _in, _m, _c = rmarched._shade(rs, o, d, t, kind, idx,
                                                rs.materials["color"])
    port_kind = torch.tensor([KINDS[int(k)] for k in hit.ptype])
    return (port_kind, hit.t, info.normal), (kind, t.float(), normal.float())


def _depth0_gaps(port, ref):
    """The share of lanes whose kinds differ, and over the lanes that hit
    the SDF in both the largest relative t gap and normal gap."""
    (pk, pt, pn), (rk, rt, rn) = port, ref
    both = (pk == rmarched.SDF_KIND) & (rk == rmarched.SDF_KIND)
    assert int(both.sum()) > 200
    t_gap = float((torch.abs(pt - rt) / rt)[both].max())
    n_gap = float(torch.linalg.vector_norm(pn - rn, dim=1)[both].max())
    return float((pk != rk).float().mean()), t_gap, n_gap


# Kinds: the sphere trace accepts within 1e-5 of the surface and the two
# programs round differently, so a ray that grazes a silhouette or an
# edge of the drilled cube can hit in one and pass in the other: at most
# 1% of lanes. t: each accepts at d < 1e-5 after steps of at least d, so
# on a lane both hit their t agree within a few 1e-5 over the secant of
# the grazing angle, 1e-4 of t at 32x24 (float32's own rounding of t ~ 5
# is 5e-7). Normals: both take the float64 central difference at 1e-4 of
# points that agree to that t, so their gap is of the order of the t gap
# over the curvature radius (>= 0.55): 0.01. bfloat16 rounds t ~ 5 to
# 0.03 (6e-3 of t) and misses every bound.
KIND_SHARE, T_REL, NORMAL_GAP = 0.01, 1e-4, 0.01


def test_depth0_hits_and_normals_match_the_reference():
    mism, t_gap, n_gap = _depth0_gaps(*_depth0())
    assert mism <= KIND_SHARE and t_gap <= T_REL and n_gap <= NORMAL_GAP, \
        (mism, t_gap, n_gap)


def test_depth0_bounds_fail_in_bfloat16():
    mism, t_gap, n_gap = _depth0_gaps(*_depth0(torch.bfloat16))
    assert mism > KIND_SHARE or t_gap > T_REL or n_gap > NORMAL_GAP


def test_film_meets_the_cells_tile_rule():
    """The program's 32x24 film at 16 spp against the reference's 64-spp
    estimate of the seed's 16 4x4 tiles, by the cell's z limits."""
    seed = 2**31 + 21  # the check's tiles and keys; the render's key is 21
    _r, film = _render(seed=21, spp=16)
    traffic = _traffic()
    check = dict(traffic["check"], **traffic["toy_check"])
    got = marched_loop.check_numbers(_conf(), check, seed, film.mean,
                                     film.m2, film.n, 16, W, H, "cpu")
    assert got["samples_off"] == 0
    for k, limit in check["limits"].items():
        assert got[k] <= limit, (k, got)

