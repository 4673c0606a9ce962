"""The rest of the catalog, third part: runway, go, qbert and maze
rendered by the port against the JAX package at 32x24, 1 spp, from the
same key (tests/test_torch_catalog_a.py's check_scene and tolerances);
why hits, go and craft miss the 99.5% rule; and the port's half of
tests/test_many_lights.py.

hits and go hold 60 and 47 non-uniformly scaled spheres, many of them
small: a camera ray reaches them with an object-space origin far out and
a long direction, so the quadratic's discriminant b*b - 4ac cancels. The
jitted JAX renderer contracts its products and sums into fused
multiply-adds; the port rounds each as the JAX package's own eager
arithmetic does, and equals that bit for bit. So the closest hit's t of
a lane differs by up to ~1e-4 relative between the two packages on such
spheres, and a lane at a silhouette or a light's edge takes another path:
hits holds ~98.8-99.4% of pixels within 1e-4, go ~98.3-98.6%, their
means within 1.8e-3 and 5.7e-3. craft's closest hits are equal, but the
jitted hit position's x and y are fused as org + t * dirn with one
rounding, the port's rounded twice (again the eager arithmetic): a
texture coordinate that is exactly 0 or 1 on a cube's side face lands an
ulp either side of the texture's wrap and samples the opposite texel
column, ~4% of pixels (mean within 2.3e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ptsharp_tpu import examples as jex
from ptsharp_tpu import intersect as jis
from ptsharp_tpu.geometry import primitives as jprim

from ptsharp_tpu_torch import convert
from ptsharp_tpu_torch import examples as tex
from ptsharp_tpu_torch import intersect as tis
from ptsharp_tpu_torch.core import rng
from ptsharp_tpu_torch.geometry import primitives as tprim
from ptsharp_tpu_torch.integrator import IntegratorConfig, trace
from ptsharp_tpu_torch.materials import diffuse_material, light_material
from ptsharp_tpu_torch.scene import SceneBuilder

from tests.test_torch_catalog_a import check_scene
from tests.test_torch_integrator import camera_rays

SCENES = ("runway", "go", "qbert", "maze")


@pytest.mark.parametrize("name", SCENES)
def test_catalog_render_matches(name):
    scene = check_scene(name)[0]
    if name == "go":
        assert not scene.has_meshes and not scene.use_tlas
    else:  # 84 cubes, 126 lights, a maze's walls: the TLAS
        assert scene.use_tlas and not scene.has_meshes


def _carried(name):
    sj, cam, _rc, _icfg = jex.build(name, width=32, height=24)
    st = convert.scene_from_reference(*convert.reference_arrays(sj),
                                       device="cpu")
    o, d = camera_rays(cam, 256, 192)
    return sj, st, o, d


@pytest.mark.parametrize("name", ["hits", "go"])
def test_scaled_spheres_fused_in_the_jit(name):
    """The port's sphere test equals the JAX package's eager one bit for
    bit on the scene's object-space camera rays; the jitted one differs
    on most of the lanes that hit a sphere."""
    sj, st, o, d = _carried(name)
    ot, dt = tis._local(st.sphere_inv, st.sphere_xform,
                        torch.from_numpy(o)[:, None, :],
                        torch.from_numpy(d)[:, None, :])
    args = (jnp.asarray(ot.numpy()), jnp.asarray(dt.numpy()),
            sj.sphere_center, sj.sphere_radius)
    eager = np.asarray(jprim.intersect_spheres(*args))
    fused = np.asarray(jax.jit(jprim.intersect_spheres)(*args))
    port = tprim.intersect_spheres(ot, dt, st.sphere_center,
                                   st.sphere_radius).numpy()
    np.testing.assert_array_equal(port, eager)
    hit = eager < 1e8
    differ = (fused != eager)[hit].mean()
    rel = np.abs(fused - eager)[hit] / eager[hit]
    print(f"{name}: {hit.sum()} sphere hits, jit != eager on {differ:.1%}, "
          f"largest relative difference {rel.max():.2e}")
    assert differ > 0.5 and rel.max() > 1e-5


def test_craft_position_fused_in_the_jit():
    """craft: equal closest hits; the jitted hit position's x and y equal
    org + t * dirn with one rounding (float64, rounded once), the port's
    the twice-rounded product and sum; texel columns flip at the wrap."""
    sj, st, o, d = _carried("craft")
    oj, dj = jnp.asarray(o), jnp.asarray(d)
    hj = jax.jit(jis.closest_hit)(sj, oj, dj)
    ij = jax.jit(jis.hit_info)(sj, oj, dj, hj)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    ht = tis.closest_hit(st, ot, dt)
    it = tis.hit_info(st, ot, dt, ht)
    for f in ("t", "ptype", "pindex", "inst"):
        np.testing.assert_array_equal(getattr(ht, f).numpy(),
                                      np.asarray(getattr(hj, f)))
    t = np.asarray(hj.t)
    hit = t < 1e8
    once = (o.astype(np.float64) + d.astype(np.float64)
            * t[:, None].astype(np.float64)).astype(np.float32)
    twice = o + d * t[:, None]
    pj, pt = np.asarray(ij.position), it.position.numpy()
    np.testing.assert_array_equal(pt[hit], twice[hit])
    np.testing.assert_array_equal(pj[hit][:, :2], once[hit][:, :2])
    assert (pj[hit] != pt[hit]).any(axis=-1).mean() > 0.3
    col_j = np.floor(np.mod(np.asarray(ij.tex_u), 1.0) * 32)
    col_t = np.floor(np.mod(it.tex_u.numpy(), 1.0) * 32)
    flips = (col_j != col_t)[hit].mean()
    print(f"craft: positions differ on "
          f"{(pj[hit] != pt[hit]).any(axis=-1).mean():.1%} of hits, texel "
          f"column flips on {flips:.2%}")
    assert flips > 0.005


# ---- the port's half of tests/test_many_lights.py -------------------------


def _lights_scene(n_lights):
    b = SceneBuilder()
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.6, 0.6, 0.6]))
    g = np.random.default_rng(1)
    for _ in range(n_lights):
        p = [float(g.uniform(-8, 8)), float(g.uniform(2, 5)),
             float(g.uniform(-8, 8))]
        e = float(g.uniform(1.0, 12.0))
        b.add_sphere(p, 0.4, light_material(g.uniform(0.3, 1.0, 3), e))
    # both counts intersect their spheres in one batched test, outside a
    # TLAS (whose plain walk loops as long as its deepest ray)
    return b.build(use_tlas=False, device="cpu")


def _down_rays(n, key):
    ju, jv = rng.uniform(key, (2, n))
    org = torch.stack([ju * 12 - 6, torch.full((n,), 4.0), jv * 12 - 6],
                      dim=-1)
    return org, torch.tensor([[0.0, -1.0, 0.0]]).repeat(n, 1)


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


def test_power_mode_flat_in_light_count():
    """A "power" trace runs the same ops at 8 and at 126 lights: one
    power-CDF pick a bounce, whatever the count."""
    key = rng.PRNGKey(3)
    cfg = IntegratorConfig(max_bounces=1, light_mode="power")
    ops = []
    for n in (8, 126):
        scene = _lights_scene(n)
        assert scene.num_lights == n
        org, d = _down_rays(256, key)
        with _OpCount() as count:
            rad = trace(scene, cfg, org, d, key).radiance
        assert torch.isfinite(rad).all() and float(rad.mean()) > 0
        ops.append(count.ops)
    assert ops[0] == ops[1], ops


def test_runway_example_smokes():
    scene, cam, _rcfg, icfg = tex.build("runway", device="cpu")
    assert scene.num_lights > 100 and icfg.light_mode == "power"
    assert scene.use_tlas
    key = rng.PRNGKey(0)
    px = torch.arange(1024) % 512
    py = 150 + torch.div(torch.arange(1024), 512, rounding_mode="floor") * 40
    ju, jv = rng.uniform(key, (2, 1024))
    org, d = cam.cast_rays(px, py, 512, 288, ju, jv)
    img = trace(scene, icfg, org, d, key).radiance
    assert torch.isfinite(img).all() and float(img.mean()) > 0
