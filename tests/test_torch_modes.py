"""The port's integrator modes against the JAX package's, ray by ray, from
the same key: the specular branch split ("first"; "all" at
all_split_depth 1 and 2), light modes "all" and "power", and closest-hit
shadow rays (anyhit_shadows=False), each through `trace` on
examples.bunny(32, 24, subdivisions=3, intersector="pallas", wide_k=8)
and on the glossy scene of tests/test_modes_and_passes.py (a glossy
floor, a diffuse sphere, a sphere light); examples.veach at 32x24, 1
spp, through both renderers; and diff.render_image's gradients under
veach's modes (specular "first", light "all", which the tape leaves to
autograd) against JAX AD. The JAX scene is carried over with
convert.scene_from_reference; the JAX side runs jitted, its mesh queries
through its plain reference walk (intersector "wide" over the same
scene's XLA tables), as tests/test_torch_integrator.py does.

Tolerances (tests/test_torch_integrator.py's): per-lane radiance within
rtol 1e-4, atol 1e-4 on at least 99.5% of lanes, mean radiance within
1e-3 relative, rays traced within 0.5%; gradients per DiffParams leaf at
rtol 1e-3, atol 1e-3 * max |g_jax| (tests/test_torch_tape.py's).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptsharp_tpu import diff as jdiff
from ptsharp_tpu import examples as jex
from ptsharp_tpu import integrator as jint
from ptsharp_tpu import tape as jtape
from ptsharp_tpu.camera import Camera as JCamera
from ptsharp_tpu.renderer import RenderConfig as JRenderConfig
from ptsharp_tpu.renderer import Renderer as JRenderer

from ptsharp_tpu_torch import convert, diff
from ptsharp_tpu_torch import examples as tex
from ptsharp_tpu_torch import integrator as tint
from ptsharp_tpu_torch import tape as ttape
from ptsharp_tpu_torch.core import rng
from ptsharp_tpu_torch.renderer import RenderConfig, Renderer

from tests.test_modes_and_passes import _gloss_scene
from tests.test_torch_integrator import (
    assert_radiance_parity, camera_rays, port_config,
)

W, H = 32, 24
KEY = 3
MODES = {
    "first": dict(specular_mode="first"),
    "all_depth1": dict(specular_mode="all", all_split_depth=1),
    "all_depth2": dict(specular_mode="all", all_split_depth=2),
    "lights_all": dict(light_mode="all"),
    "lights_power": dict(light_mode="power"),
    "closest_hit_shadows": dict(anyhit_shadows=False),
}


def _glossy():
    cam = JCamera.look_at([0, 2, -6], [0, 1, 0], [0, 1, 0], 40.0)
    return _gloss_scene(), cam, None, jint.IntegratorConfig(max_bounces=3)


SCENES = {
    "bunny": lambda: jex.bunny(W, H, subdivisions=3, intersector="pallas",
                               wide_k=8),
    "glossy": _glossy,
}


def jax_walk(sj):
    """The JAX scene with its mesh queries on the plain reference walk."""
    return (dataclasses.replace(sj, intersector="wide")
            if sj.inst_inv.shape[0] else sj)


def trace_both(st, sj, jcfg, o, d, key=KEY):
    """(port TraceResult, JAX TraceResult as numpy) of one wavefront."""
    rj = jax.jit(jint.trace, static_argnums=(1,))(
        jax_walk(sj), jcfg, jnp.asarray(o), jnp.asarray(d),
        jax.random.PRNGKey(key))
    rt = tint.trace(st, port_config(jcfg), torch.from_numpy(o.copy()),
                    torch.from_numpy(d.copy()), rng.PRNGKey(key))
    return rt, [np.asarray(x) for x in rj]


def assert_trace_parity(rt, rj):
    assert_radiance_parity(rt.radiance.numpy(), rj[0], int(rt.rays_traced),
                           int(rj[3]))
    np.testing.assert_allclose(rt.albedo.numpy(), rj[1], atol=1e-4)
    np.testing.assert_allclose(rt.normal.numpy(), rj[2], atol=1e-4)


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene_case(request):
    sj, cam, _rc, icfg = SCENES[request.param]()
    st = convert.scene_from_reference(*convert.reference_arrays(sj),
                                      device="cpu")
    o, d = camera_rays(cam, W, H)
    return dict(name=request.param, sj=sj, st=st, icfg=icfg, o=o, d=d)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_trace_matches(scene_case, mode):
    jcfg = dataclasses.replace(scene_case["icfg"], **MODES[mode])
    rt, rj = trace_both(scene_case["st"], scene_case["sj"], jcfg,
                        scene_case["o"], scene_case["d"])
    assert_trace_parity(rt, rj)
    if jint.SPECULAR_MODE_NAIVE != jcfg.specular_mode:
        # the split traces more rays than one wavefront would
        assert int(rt.rays_traced) > W * H * 2


def test_split_modes_do_not_compact():
    """The renderer's compacted trace falls back to the plain trace in the
    split modes, as the JAX package's does."""
    for mode in ("first", "all_depth2"):
        cfg = tint.IntegratorConfig(**MODES[mode])
        assert tint.compaction_schedule(cfg, 1 << 20) == ()
        assert jint.compaction_schedule(
            jint.IntegratorConfig(**MODES[mode]), 1 << 20) == ()


def test_veach_film_matches():
    """veach (four sphere lights over four transformed metallic bars,
    specular "first", light "all"): the port's Renderer film against the
    JAX Renderer's at 32x24, 1 spp; its build equal to the JAX build."""
    sj, cam, _rc, icfg = jex.veach(W, H)
    st, _cam, _trc, ticfg = tex.veach(W, H, device="cpu")
    assert ticfg == port_config(icfg)
    assert st.num_lights == 4 and st.light_types == tuple(sj.light_types)
    for name in ("light_center", "light_radius", "light_pmf", "cube_inv",
                 "sphere_center"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(sj, name)))
    rj = JRenderer(sj, cam, JRenderConfig(width=W, height=H, spp=1), icfg)
    ref = {k: np.asarray(v)
           for k, v in rj.render(key=jax.random.PRNGKey(1))._asdict().items()}
    rt = Renderer(st, convert.camera_from_reference(cam._asdict(),
                                                    device="cpu"),
                  RenderConfig(width=W, height=H, spp=1), ticfg)
    film = rt.render(key=rng.PRNGKey(1))
    assert_radiance_parity(film.mean.numpy().reshape(-1, 3),
                           ref["mean"].reshape(-1, 3), rt.rays_traced,
                           rj.rays_traced)
    np.testing.assert_array_equal(film.n.numpy(), ref["n"])


def test_render_image_grads_match_jax_ad_under_light_mode_all():
    """diff.render_image on veach at 16x12, 1 spp, under its modes: the
    port's gradients of sum(image * wts) per DiffParams leaf, by autograd
    and through the tape's entry point (which leaves these modes to
    autograd), against JAX AD through its render_image."""
    w, h = 16, 12
    sj, cam, _rc, icfg = jex.veach(w, h)
    assert not jtape.tape_supported(sj, icfg)
    wts = np.random.default_rng(2).random((h, w, 3)).astype(np.float32)

    def loss(p, scene):
        img = jdiff.render_image(jtape._plug(scene, p), cam, icfg,
                                 jax.random.PRNGKey(KEY), w, h, 1)
        return jnp.sum(img * jnp.asarray(wts))

    pj = jtape.DiffParams(color=sj.materials.color,
                          emittance=sj.materials.emittance,
                          tint=sj.materials.tint,
                          env_color=jnp.asarray(sj.env_color),
                          tex_data=sj.textures.data)
    gj = jax.jit(jax.grad(loss))(pj, sj)
    st = convert.scene_from_reference(*convert.reference_arrays(sj),
                                      device="cpu")
    tcam = convert.camera_from_reference(cam._asdict(), device="cpu")
    assert not ttape.tape_supported(st, port_config(icfg))
    for use_tape in (False, True):
        leaves = [x.detach().clone().requires_grad_()
                  for x in ttape.DiffParams.of(st)]
        s = ttape.plug(st, ttape.DiffParams(*leaves))
        img = diff.render_image(s, tcam, port_config(icfg), rng.PRNGKey(KEY),
                                w, h, 1, use_tape=use_tape)
        gs = torch.autograd.grad((img * torch.from_numpy(wts)).sum(), leaves,
                                 allow_unused=True)
        for name, gt, x in zip(ttape.DiffParams._fields, gs, leaves):
            gt = np.zeros(x.shape, np.float32) if gt is None else gt.numpy()
            want = np.asarray(getattr(gj, name))
            assert np.isfinite(gt).all()
            np.testing.assert_allclose(
                gt, want, rtol=1e-3,
                atol=1e-3 * max(np.abs(want).max(), 1e-30), err_msg=name)
        assert np.abs(gs[0].numpy()).max() > 0
