"""The port's integrator against the JAX package's, ray by ray, from the
same key: `trace` and `trace_compacted_static` on
examples.bunny(32, 24, subdivisions=3, intersector="pallas", wide_k=8) and
on examples.cornell(32, 24). The JAX scene is carried over with
convert.scene_from_reference. The JAX side runs jitted, and its mesh
queries go through the JAX package's plain reference walk (intersector
"wide" over the same scene's XLA tables), which compiles 3-4x faster on
the CPU than its Pallas kernels in interpret mode; tests/
test_torch_kernels.py and test_torch_intersect.py hold the port against
those kernels themselves.

Tolerances: per-lane radiance within rtol 1e-4, atol 1e-4 on at least
99.5% of lanes (a 1-ulp difference can flip one path's branch), mean
radiance within 1e-3 relative, rays traced within 0.5%.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptsharp_tpu import examples as jex
from ptsharp_tpu import integrator as jint

from ptsharp_tpu_torch import convert
from ptsharp_tpu_torch import integrator as tint
from ptsharp_tpu_torch.core import rng

W, H = 32, 24
KEY = 3
# two reservoir compactions of the 768-ray wavefront (768 -> 384 -> 192)
SCHEDULE = ((2, 384), (3, 192))


def port_config(icfg) -> tint.IntegratorConfig:
    names = [f.name for f in dataclasses.fields(tint.IntegratorConfig)]
    return tint.IntegratorConfig(**{n: getattr(icfg, n) for n in names})


def camera_rays(cam, w, h, seed=0):
    """Jittered primary rays, one per pixel, jitter from numpy."""
    g = np.random.default_rng(seed)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ju, jv = g.random((2, w * h)).astype(np.float32)
    o, d = cam.cast_rays(jnp.asarray(xs.reshape(-1)),
                         jnp.asarray(ys.reshape(-1)), w, h,
                         jnp.asarray(ju), jnp.asarray(jv))
    return np.asarray(o), np.asarray(d)


def assert_radiance_parity(rad_t, rad_j, rays_t=None, rays_j=None):
    close = np.all(np.isclose(rad_t, rad_j, rtol=1e-4, atol=1e-4), axis=-1)
    assert close.mean() >= 0.995, (close.mean(), np.nonzero(~close)[0][:10])
    assert np.isfinite(rad_t).all()
    rel = abs(rad_t.mean() - rad_j.mean()) / max(abs(rad_j.mean()), 1e-9)
    assert rel <= 1e-3, rel
    if rays_j is not None:
        assert abs(rays_t - rays_j) <= 0.005 * rays_j, (rays_t, rays_j)


def build(name):
    if name == "bunny":
        return jex.bunny(W, H, subdivisions=3, intersector="pallas",
                         wide_k=8)
    return jex.cornell(W, H)


@pytest.fixture(scope="module", params=["bunny", "cornell"])
def case(request):
    sj, cam, _rc, icfg = build(request.param)
    st = convert.scene_from_reference(*convert.reference_arrays(sj),
                                       device="cpu")
    o, d = camera_rays(cam, W, H)
    key = jax.random.PRNGKey(KEY)
    walk = (dataclasses.replace(sj, intersector="wide")
            if sj.inst_inv.shape[0] else sj)
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    plain = jax.jit(jint.trace, static_argnums=(1,))(walk, icfg, jo, jd, key)
    compact = jax.jit(jint.trace_compacted_static, static_argnums=(1,),
                      static_argnames=("schedule",))(
        walk, icfg, jo, jd, key, schedule=SCHEDULE)
    return dict(
        st=st, icfg=port_config(icfg), org=torch.from_numpy(o.copy()),
        dirn=torch.from_numpy(d.copy()),
        plain=[np.asarray(x) for x in plain],
        compact=[np.asarray(x) for x in compact],
        schedule=jint.compaction_schedule(icfg, W * H, SCHEDULE))


def test_trace_matches(case):
    res = tint.trace(case["st"], case["icfg"], case["org"], case["dirn"],
                     rng.PRNGKey(KEY))
    rad_j, alb_j, nrm_j, rays_j = case["plain"]
    assert_radiance_parity(res.radiance.numpy(), rad_j,
                           int(res.rays_traced), int(rays_j))
    np.testing.assert_allclose(res.albedo.numpy(), alb_j, atol=1e-4)
    np.testing.assert_allclose(res.normal.numpy(), nrm_j, atol=1e-4)


def test_trace_compacted_static_matches(case):
    assert case["schedule"] == SCHEDULE  # the compacted path really runs
    res = tint.trace_compacted_static(case["st"], case["icfg"], case["org"],
                                      case["dirn"], rng.PRNGKey(KEY),
                                      schedule=SCHEDULE)
    rad_j, _alb, _nrm, rays_j = case["compact"]
    assert_radiance_parity(res.radiance.numpy(), rad_j,
                           int(res.rays_traced), int(rays_j))


@pytest.mark.parametrize("rr", [False, True])
@pytest.mark.parametrize("r", [100, 5000, 1 << 20])
def test_compaction_schedule_matches(r, rr):
    cj = jint.IntegratorConfig(max_bounces=5, russian_roulette=rr)
    assert tint.compaction_schedule(port_config(cj), r) == \
        jint.compaction_schedule(cj, r)


@pytest.mark.parametrize("with_box", [False, True])
def test_morton_key_matches(with_box):
    g = np.random.default_rng(2)
    p = g.normal(size=(2048, 3)).astype(np.float32)
    d = g.normal(size=(2048, 3)).astype(np.float32)
    box = (np.array([-0.5, -0.5, -0.5], np.float32),
           np.array([0.5, 0.7, 0.5], np.float32))
    kj = jint._morton_key(jnp.asarray(p), jnp.asarray(d),
                          box=tuple(map(jnp.asarray, box)) if with_box
                          else None)
    kt = tint._morton_key(torch.from_numpy(p), torch.from_numpy(d),
                          box=tuple(map(torch.from_numpy, box)) if with_box
                          else None)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj).astype(np.int64))


def test_reservoir_compact_matches():
    g = np.random.default_rng(4)
    r, cap = 4096, 1024
    fields = dict(
        org=g.normal(size=(r, 3)).astype(np.float32),
        dirn=g.normal(size=(r, 3)).astype(np.float32),
        throughput=g.random((r, 3)).astype(np.float32),
        radiance=np.zeros((r, 3), np.float32),
        emission_ok=g.random(r) < 0.5,
        alive=g.random(r) < 0.4)
    sj, srcj = jint._reservoir_compact(
        jint.RayState(**{k: jnp.asarray(v) for k, v in fields.items()}), cap,
        jax.random.PRNGKey(7))
    st, srct = tint._reservoir_compact(
        tint.RayState(**{k: torch.from_numpy(v) for k, v in fields.items()}),
        cap, rng.PRNGKey(7))
    np.testing.assert_array_equal(srct.numpy(), np.asarray(srcj))
    for a, b in zip(st, sj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("kw", [{"light_mode": "every"},
                                {"specular_mode": "split"},
                                {"remat_policy": "some"}])
def test_unknown_modes_raise(kw):
    """An unknown mode is refused where the JAX package asserts."""
    with pytest.raises(ValueError):
        tint.IntegratorConfig(**kw)
