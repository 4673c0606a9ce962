"""The rest of the catalog, first part: simple_sphere, material_spheres,
refraction, mesh and dragon rendered by the port against the JAX package
at 32x24, 1 spp, from the same key: the JAX scene carried over with
convert.scene_from_reference, and the port's own build of the scene,
whose tables must equal the carried ones. tests/test_torch_catalog_b.py
and _c.py hold the other nine scenes with the helpers of this file.

Tolerances: the render rule of tests/test_torch_render.py (per-pixel film
mean within rtol 1e-4, atol 1e-4 on >= 99.5% of pixels, image mean within
1e-3 relative, rays traced within 0.5%, sample counts equal), except for
the scenes of OUTLIERS, whose test in _c.py shows why: the jitted JAX
renderer contracts a multiply and an add into one fused multiply-add
where the port and the JAX package's own eager arithmetic round twice.
The builds' tables are bit-equal but for the cylinders of gopher and
cylinder_field, whose rotations take sin and cos in each package's float32
(within 1e-6 relative).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ptsharp_tpu import examples as jex
from ptsharp_tpu.renderer import RenderConfig as JRenderConfig
from ptsharp_tpu.renderer import Renderer as JRenderer

from ptsharp_tpu_torch import convert
from ptsharp_tpu_torch import examples as tex
from ptsharp_tpu_torch.core import rng
from ptsharp_tpu_torch.renderer import RenderConfig, Renderer

from tests.test_torch_integrator import port_config

W, H = 32, 24
SCENES = ("simple_sphere", "material_spheres", "refraction", "mesh",
          "dragon")
# scene: (share of pixels within 1e-4, image mean's relative tolerance)
OUTLIERS = {"hits": (0.98, 5e-3), "go": (0.98, 1e-2), "craft": (0.95, 1e-3)}
# rotations in a transform: float32 sin and cos of each package
ROTATED = {"gopher": ("cyl_inv",), "cylinder_field": ("cyl_inv", "u_rows",
                                                      "w_rows")}


def assert_render_rule(got, want, rays_t, rays_j, name):
    frac, mean_tol = OUTLIERS.get(name, (0.995, 1e-3))
    close = np.all(np.isclose(got, want, rtol=1e-4, atol=1e-4), axis=-1)
    rel = abs(got.mean() - want.mean()) / max(abs(want.mean()), 1e-9)
    print(f"{name} {W}x{H}: pixels within 1e-4 {close.mean():.4%}, mean "
          f"within {rel:.3e}, rays {rays_t} against {rays_j}")
    assert np.isfinite(got).all()
    assert close.mean() >= frac, (name, close.mean())
    assert rel <= mean_tol, (name, rel)
    assert abs(rays_t - rays_j) <= 0.005 * rays_j, (rays_t, rays_j)


def assert_same_build(own, carried, name):
    """The port's build of a scene holds the carried JAX build's tables."""
    for f in dataclasses.fields(own):
        a, b = getattr(own, f.name), getattr(carried, f.name)
        if f.name == "bvh_builder":
            continue
        if isinstance(a, torch.Tensor):
            assert a.shape == b.shape and a.dtype == b.dtype, f.name
            if f.name in ROTATED.get(name, ()):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                           atol=1e-6, err_msg=f.name)
            else:
                assert torch.equal(a, b), f.name
        elif isinstance(a, tuple) and all(isinstance(x, torch.Tensor)
                                          for x in a):  # the atlas
            assert all(torch.equal(x, y) for x, y in zip(a, b)), f.name
        elif isinstance(a, (bool, int, float, str)):
            assert a == b, f.name


def check_scene(name):
    """Render `name` by both packages and hold the port to the rule, over
    the carried scene and over its own build."""
    sj, cam, rc_j, icfg = jex.build(name, width=W, height=H)
    rj = JRenderer(sj, cam, JRenderConfig(width=W, height=H, spp=1), icfg)
    ref = rj.render(key=jax.random.PRNGKey(1))
    want = np.asarray(ref.mean).reshape(-1, 3)
    st = convert.scene_from_reference(*convert.reference_arrays(sj),
                                       device="cpu")
    ct = convert.camera_from_reference(cam._asdict(), device="cpu")
    own = tex.build(name, width=W, height=H, device="cpu")
    assert own[3] == port_config(icfg)
    assert own[2] == RenderConfig(**dataclasses.asdict(rc_j))
    assert_same_build(own[0], st, name)
    for scene, camera in ((st, ct), own[:2]):
        r = Renderer(scene, camera, RenderConfig(W, H, spp=1), own[3])
        film = r.render(key=rng.PRNGKey(1))
        assert_render_rule(film.mean.numpy().reshape(-1, 3), want,
                           r.rays_traced, rj.rays_traced, name)
        np.testing.assert_array_equal(film.n.numpy(), np.asarray(ref.n))
    return own


@pytest.mark.parametrize("name", SCENES)
def test_catalog_render_matches(name):
    scene = check_scene(name)[0]
    if name in ("mesh", "dragon"):
        assert scene.intersector == "wide" and not scene.use_tlas
    else:
        assert not scene.has_meshes and not scene.use_tlas


def test_catalog_names_match():
    """The port's catalog holds the JAX package's 28 scenes."""
    from ptsharp_tpu.examples import CATALOG

    assert set(tex.CATALOG) == set(CATALOG)
    assert len(tex.CATALOG) == 28
