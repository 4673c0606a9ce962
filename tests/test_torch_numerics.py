"""The port's divisions by Python numbers against the JAX package's, bit for
bit on the CPU, on inputs made with numpy from a seed.

The card takes `tensor / python_number` as a product with the number's
reciprocal, where the CPU and the JAX package divide; the two roundings
differ on a share of values (about a fifth for 3 and a sixth for pi). The
port divides by a 0-d float32 tensor on the operand's device instead
(core/vec.py div), which the card divides as the CPU does: chip_smoke.py's
numerics_check holds the card's bits against the CPU's. Here, where the CPU
divides either way, the four expressions that divided by a Python number
(the bump map's luminance, the cone's angle, the environment's and the
sphere's lat-long coordinates) are held to the JAX package's bits with the
JAX package's float32 transcendentals swapped into core/vec.py, so that
the only difference left would be the arithmetic around them (the port's
own transcendentals are correctly rounded and differ from XLA's by an ulp
on a share of inputs).
"""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptsharp_tpu import integrator as jint
from ptsharp_tpu import textures as jtex
from ptsharp_tpu.core import sampling as jsamp
from ptsharp_tpu.geometry import primitives as jprim
from ptsharp_tpu_torch import integrator as tint
from ptsharp_tpu_torch import textures as ttex
from ptsharp_tpu_torch.core import sampling as tsamp
from ptsharp_tpu_torch.core import vec
from ptsharp_tpu_torch.geometry import primitives as tprim

N = 8192


def _jax_fn(fn):
    """fn of jax.numpy as a function of CPU tensors."""
    return lambda *xs: torch.from_numpy(np.array(fn(*(jnp.asarray(
        x.numpy()) for x in xs))))


@pytest.fixture
def jax_transcendentals(monkeypatch):
    for name, fn in (("acos", jnp.arccos), ("atan2", jnp.arctan2),
                     ("sin", jnp.sin), ("cos", jnp.cos), ("sqrt", jnp.sqrt),
                     ("rsqrt", jax.lax.rsqrt)):
        monkeypatch.setattr(vec, name, _jax_fn(fn))


def _inputs(seed=21):
    g = np.random.default_rng(seed)
    d = g.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return dict(
        d=d, p=g.normal(size=(N, 3)).astype(np.float32),
        c=g.normal(size=(N, 3)).astype(np.float32),
        u1=g.uniform(0, 1, N).astype(np.float32),
        u2=g.uniform(0, 1, N).astype(np.float32),
        theta=g.uniform(0, 0.6, N).astype(np.float32),
        tex=g.uniform(0, 1, (2, 16, 20, 3)).astype(np.float32),
        tid=g.integers(0, 2, N).astype(np.int32))


def _bump(x, torch_side):
    sizes = np.array([[16, 20], [12, 9]], np.int32)
    if torch_side:
        atlas = ttex.TextureAtlas.from_arrays(x["tex"], sizes, "cpu")
        return atlas.bump_sample(*(torch.from_numpy(x[k])
                                   for k in ("tid", "u1", "u2")))
    atlas = jtex.TextureAtlas(jnp.asarray(x["tex"]), jnp.asarray(sizes))
    return atlas.bump_sample(*(jnp.asarray(x[k]) for k in ("tid", "u1", "u2")))


def _cone(x, torch_side):
    if torch_side:
        return tsamp.cone(*(torch.from_numpy(x[k])
                            for k in ("d", "theta", "u1", "u2")))
    return jsamp.cone(*(jnp.asarray(x[k]) for k in ("d", "theta", "u1", "u2")))


def _env_uv(x, torch_side):
    if torch_side:
        scene = types.SimpleNamespace(texture_angle=0.3)
        return torch.stack(tint.env_uv(scene, torch.from_numpy(x["d"])))
    scene = types.SimpleNamespace(texture_angle=jnp.float32(0.3))
    return jnp.stack(jint.env_uv(scene, jnp.asarray(x["d"])))


def _sphere_uv(x, torch_side):
    if torch_side:
        return torch.stack(tprim.sphere_uv(torch.from_numpy(x["p"]),
                                           torch.from_numpy(x["c"]), 1.0))
    return jnp.stack(jprim.sphere_uv(jnp.asarray(x["p"]),
                                     jnp.asarray(x["c"]), 1.0))


@pytest.mark.parametrize("fn", [_bump, _cone, _env_uv, _sphere_uv],
                         ids=["bump_luminance", "cone", "env_uv", "sphere_uv"])
def test_divisions_match_jax_bits(fn, jax_transcendentals):
    x = _inputs()
    got = fn(x, True).numpy()
    want = np.asarray(fn(x, False))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d", [3.0, math.pi, 2.0 * math.pi, 2e-3, 7, 0.25])
def test_div_is_a_float32_division(d):
    """vec.div rounds x / float32(d) once, as numpy's float32 division and
    the JAX package's do, and keeps x's device and dtype."""
    x = np.random.default_rng(22).normal(size=4096).astype(np.float32)
    got = vec.div(torch.from_numpy(x), d)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), x / np.float32(d))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.asarray(x) / d))
