"""Renderer.render() of the port against the JAX package's, from the same
key, at 1 spp, on examples.bunny(32, 24, subdivisions=3,
intersector="pallas", wide_k=8) and examples.cornell(32, 24); and at
30x17 (510 rays, not a multiple of the TPU kernels' 1,024-ray tile) on
the bunny with pallas_ordered=False and on examples.dragon_hd(30, 17,
subdivisions=3, intersector="pallas", wide_k=8) in both walk orders. The
JAX scene is carried over with convert.scene_from_reference, its walk
order included, so the port runs its preorder or ordered kernels' plain
versions; the JAX side's mesh queries run through its plain reference
walk (intersector "wide" over the same scene's tables).

Tolerances: per-pixel film mean within rtol 1e-4, atol 1e-4 on at least
99.5% of pixels, image mean within 1e-3 relative, sample counts equal,
rays traced within 0.5%.

At 768 rays the compaction schedule is empty, so both renderers take the
plain trace. The compacted route is checked on the port alone: with
compaction engaged, one lane that differs by an ulp before a reservoir
compaction shifts the lane order of every later lane, so the two packages
agree only in expectation there (ROADMAP Queue 3).
"""

import dataclasses

import jax
import numpy as np
import pytest

from ptsharp_tpu import examples as jex
from ptsharp_tpu.renderer import RenderConfig as JRenderConfig
from ptsharp_tpu.renderer import Renderer as JRenderer

from ptsharp_tpu_torch import convert
from ptsharp_tpu_torch import examples as tex
from ptsharp_tpu_torch.core import rng
from ptsharp_tpu_torch.integrator import compaction_schedule
from ptsharp_tpu_torch.renderer import RenderConfig, Renderer

from tests.test_torch_integrator import assert_radiance_parity, port_config

PALLAS = dict(subdivisions=3, intersector="pallas", wide_k=8)
CASES = {  # name: (width, height, JAX example)
    "bunny": (32, 24, lambda w, h: jex.bunny(w, h, **PALLAS)),
    "cornell": (32, 24, lambda w, h: jex.cornell(w, h)),
    "bunny_preorder": (30, 17, lambda w, h: jex.bunny(
        w, h, pallas_ordered=False, **PALLAS)),
    "dragon_hd": (30, 17, lambda w, h: jex.dragon_hd(w, h, **PALLAS)),
    "dragon_hd_preorder": (30, 17, lambda w, h: jex.dragon_hd(
        w, h, pallas_ordered=False, **PALLAS)),
}


def _port_renderer(sj, cam, w, h, icfg):
    """The port's renderer over the JAX scene, carried over with
    convert.scene_from_reference (its walk order included)."""
    st = convert.scene_from_reference(*convert.reference_arrays(sj),
                                       device="cpu")
    assert st.p_ordered == bool(sj.p_ordered)
    return Renderer(st, convert.camera_from_reference(cam._asdict(),
                                                      device="cpu"),
                    RenderConfig(width=w, height=h, spp=1), port_config(icfg))


# Each test builds its case itself rather than sharing a module-scoped
# fixture: a worker then holds no JAX renderer, compiled programs or port
# scene from one test to the next, and no case depends on what an earlier
# test or file left in the worker.


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_film_matches(case):
    w, h, make = CASES[case]
    sj, cam, _rc, icfg = make(w, h)
    walk = (dataclasses.replace(sj, intersector="wide")
            if sj.inst_inv.shape[0] else sj)
    rj = JRenderer(walk, cam, JRenderConfig(width=w, height=h, spp=1), icfg)
    ref = {k: np.asarray(v)
           for k, v in rj.render(key=jax.random.PRNGKey(1))._asdict().items()}
    rt = _port_renderer(sj, cam, w, h, icfg)
    film = rt.render(key=rng.PRNGKey(1))
    assert_radiance_parity(film.mean.numpy().reshape(-1, 3),
                           ref["mean"].reshape(-1, 3), rt.rays_traced,
                           rj.rays_traced)
    np.testing.assert_array_equal(film.n.numpy(), ref["n"])
    close = np.isclose(film.albedo.numpy(), ref["albedo"], atol=1e-4)
    assert close.all(axis=-1).mean() >= 0.995


@pytest.mark.parametrize("case", sorted(CASES))
def test_film_accumulates_across_renders(case):
    """A second render merges into the same film: counts double and the
    variance becomes defined."""
    w, h, make = CASES[case]
    sj, cam, _rc, icfg = make(w, h)
    rt = _port_renderer(sj, cam, w, h, icfg)
    film = rt.render(key=rng.PRNGKey(1))
    film = rt.render(film, key=rng.PRNGKey(2))
    assert (film.n.numpy() == 2.0).all()
    assert np.isfinite(film.mean.numpy()).all()
    assert np.isfinite(film.variance().numpy()).all()
    assert float(film.variance().sum()) > 0.0


def test_renderer_takes_the_compacted_trace():
    """64x48 at 2 spp is 6,144 rays, above the 4,096-lane minimum
    capacity: the renderer compacts (fewer rays traced than the plain
    trace) and the image agrees with the plain render in expectation."""
    scene, cam, _rc, icfg = tex.bunny(64, 48, subdivisions=3,
                                      intersector="pallas", wide_k=8,
                                      device="cpu")
    assert compaction_schedule(icfg, 64 * 48 * 2)
    films, rays = [], []
    for compaction in (True, False):
        r = Renderer(scene, cam, RenderConfig(64, 48, spp=2,
                                              compaction=compaction), icfg)
        films.append(r.render(key=rng.PRNGKey(4)).mean.numpy())
        rays.append(r.rays_traced)
    assert rays[0] < rays[1]
    assert np.isfinite(films[0]).all()
    rel = abs(films[0].mean() - films[1].mean()) / films[1].mean()
    assert rel < 0.05, rel
