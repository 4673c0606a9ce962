"""The port's integrator against the independent scalar tracer
(tests/reference_tracer.py, numpy only): the two golden-parity cases of
tests/test_integrator.py run on the port, with its Renderer on the CPU
in place of the JAX package's.

  * NEE on BASELINE's config-#1 scene (a diffuse sphere, a plane, a
    sphere light, 3 bounces): 6x6 pixels, 512 spp, in the naive mode and,
    since each targets the same integral, with the branch split at the
    first hit, with every light sampled and with closest-hit shadow rays;
  * Fresnel-weighted reflection and refraction on a glass sphere under a
    flat environment, no NEE, 4 bounces: 6x6 pixels, 256 spp.

Tolerances (tests/test_integrator.py's, Monte Carlo: both estimators
target one integral from independent samples): image mean within 5%
(8% for glass) relative, every pixel within 0.25 for NEE.
"""

import numpy as np
import pytest

from ptsharp_tpu_torch.camera import Camera
from ptsharp_tpu_torch.core import rng
from ptsharp_tpu_torch.integrator import IntegratorConfig
from ptsharp_tpu_torch.materials import (
    diffuse_material, light_material, specular_material,
)
from ptsharp_tpu_torch.renderer import RenderConfig, Renderer
from ptsharp_tpu_torch.scene import SceneBuilder

from tests import reference_tracer as ref


def _trace_image(scene, cam, w, h, spp, icfg, seed=0):
    r = Renderer(scene, cam, RenderConfig(width=w, height=h, spp=spp), icfg)
    return r.render(key=rng.PRNGKey(seed)).mean.numpy()


@pytest.mark.parametrize("mode", [{}, {"specular_mode": "first"},
                                  {"light_mode": "all"},
                                  {"anyhit_shadows": False}],
                         ids=["naive", "split_first", "lights_all",
                              "closest_hit_shadows"])
def test_nee_matches_reference_tracer(mode):
    b = SceneBuilder()
    b.add_sphere([0, 1, 0], 1.0, diffuse_material([0.7, 0.2, 0.2]))
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.8, 0.8, 0.8]))
    b.add_sphere([3, 6, -3], 1.5, light_material([1, 1, 1], 8.0))
    b.set_environment(color=[0.1, 0.1, 0.1])
    scene = b.build(device="cpu")
    cam = Camera.look_at([0, 2, -6], [0, 1, 0], [0, 1, 0], 40.0,
                         device="cpu")
    w = h = 6
    img = _trace_image(scene, cam, w, h, 512,
                       IntegratorConfig(max_bounces=3, **mode))
    rscene = ref.RefScene(
        [
            ref.Sph(np.array([0.0, 1, 0]), 1.0,
                    ref.Mat(np.array([0.7, 0.2, 0.2]))),
            ref.Pln(np.array([0.0, 0, 0]), np.array([0.0, 1, 0]),
                    ref.Mat(np.array([0.8, 0.8, 0.8]))),
            ref.Sph(np.array([3.0, 6, -3]), 1.5,
                    ref.Mat(np.array([1.0, 1, 1]), emittance=8.0)),
        ],
        env=(0.1, 0.1, 0.1),
    )
    ref_img = ref.render(rscene, [0, 2, -6], [0, 1, 0], 40.0, w, h, 512, 3,
                         seed=3)
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img.mean(), ref_img.mean(), rtol=0.05)
    np.testing.assert_allclose(img, ref_img, atol=0.25)


def test_specular_glass_matches_reference():
    b = SceneBuilder()
    b.add_sphere([0, 0, 0], 1.0, specular_material([1, 1, 1], 1.5))
    b.set_environment(color=[0.5, 0.5, 0.5])
    scene = b.build(device="cpu")
    cam = Camera.look_at([0, 0, -4], [0, 0, 0], [0, 1, 0], 35.0,
                         device="cpu")
    w = h = 6
    img = _trace_image(scene, cam, w, h, 256,
                       IntegratorConfig(max_bounces=4, direct_lighting=False))
    rscene = ref.RefScene(
        [ref.Sph(np.array([0.0, 0, 0]), 1.0,
                 ref.Mat(np.array([1.0, 1, 1]), index=1.5))],
        env=(0.5, 0.5, 0.5),
    )
    ref_img = ref.render(rscene, [0, 0, -4], [0, 0, 0], 35.0, w, h, 256, 4,
                         seed=5)
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img.mean(), ref_img.mean(), rtol=0.08)
