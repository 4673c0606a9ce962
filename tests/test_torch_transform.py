"""core/transform.py and core/color.py's constructors of the port against
the JAX package's, from the same seeded numpy inputs, as
tests/test_core_math.py exercises the reference's (a matrix round trip,
a transformed box holding its transformed corners).

Tolerance: rtol 1e-6, atol 1e-6 on every entry (float32 math on both
sides; the inverse and determinant of a well-conditioned 4x4 matrix)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptsharp_tpu.core import color as jcolor
from ptsharp_tpu.core import transform as jt

from ptsharp_tpu_torch.core import color as tcolor
from ptsharp_tpu_torch.core import transform as tt

TOL = dict(rtol=1e-6, atol=1e-6)


def _inputs():
    g = np.random.default_rng(7)
    return dict(
        v=g.uniform(-2, 2, 3).astype(np.float32),
        s=g.uniform(0.5, 2, 3).astype(np.float32),
        axis=g.normal(size=3).astype(np.float32),
        theta=float(g.uniform(-3, 3)),
        p=g.uniform(-3, 3, (5, 3)).astype(np.float32),
        bmin=g.uniform(-2, -0.5, 3).astype(np.float32),
        bmax=g.uniform(0.5, 2, 3).astype(np.float32),
    )


def _m(mod, x):
    """A rotation, a scale and a translation composed in `mod`."""
    return mod.mul(mod.translate(x["v"]),
                   mod.mul(mod.rotate(x["axis"], x["theta"]),
                           mod.scale(x["s"])))


CASES = {
    "identity": lambda mod, x: mod.identity(),
    "translate": lambda mod, x: mod.translate(x["v"]),
    "scale": lambda mod, x: mod.scale(x["s"]),
    "rotate": lambda mod, x: mod.rotate(x["axis"], x["theta"]),
    "frustum": lambda mod, x: mod.frustum(-1.0, 1.5, -0.8, 0.9, 0.5, 40.0),
    "orthographic": lambda mod, x: mod.orthographic(-2.0, 3.0, -1.0, 1.5,
                                                    0.1, 10.0),
    "perspective": lambda mod, x: mod.perspective(38.0, 16 / 9, 0.1, 100.0),
    "look_at_matrix": lambda mod, x: mod.look_at_matrix(
        x["v"], x["p"][0], [0.0, 1.0, 0.0]),
    "mul": _m,
    "mul_position": lambda mod, x: mod.mul_position(_m(mod, x),
                                                    _arr(mod, x["p"])),
    "mul_direction": lambda mod, x: mod.mul_direction(_m(mod, x),
                                                      _arr(mod, x["p"])),
    "mul_direction_raw": lambda mod, x: mod.mul_direction_raw(
        _m(mod, x), _arr(mod, x["p"])),
    "mul_box": lambda mod, x: mod.mul_box(_m(mod, x), _arr(mod, x["bmin"]),
                                          _arr(mod, x["bmax"])),
    "inverse": lambda mod, x: mod.inverse(_m(mod, x)),
    "transpose": lambda mod, x: mod.transpose(_m(mod, x)),
    "determinant": lambda mod, x: mod.determinant(_m(mod, x)),
    "rgb": lambda mod, x: _color(mod).rgb(0.25, 0.5, 0.75),
    "hex_color": lambda mod, x: _color(mod).hex_color(0x45B29D),
}


def _arr(mod, a):
    return jnp.asarray(a) if mod is jt else torch.from_numpy(a)


def _color(mod):
    return jcolor if mod is jt else tcolor


def _np(x):
    if isinstance(x, tuple):
        return tuple(_np(a) for a in x)
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_reference(name):
    x = _inputs()
    got, want = _np(CASES[name](tt, x)), _np(CASES[name](jt, x))
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, **TOL)


def test_roundtrip_and_box():
    """The inverse undoes the matrix; the box holds every corner."""
    x = _inputs()
    m = _m(tt, x)
    p = torch.from_numpy(x["p"])
    back = tt.mul_position(tt.inverse(m), tt.mul_position(m, p))
    np.testing.assert_allclose(back.numpy(), x["p"], atol=1e-5)
    lo, hi = tt.mul_box(m, torch.from_numpy(x["bmin"]),
                        torch.from_numpy(x["bmax"]))
    corners = torch.tensor([[a, b, c] for a in (x["bmin"][0], x["bmax"][0])
                            for b in (x["bmin"][1], x["bmax"][1])
                            for c in (x["bmin"][2], x["bmax"][2])])
    tc = tt.mul_position(m, corners)
    assert bool((tc >= lo - 1e-5).all()) and bool((tc <= hi + 1e-5).all())
