"""Signed-distance-field CSG shapes with batched sphere tracing.

Counterpart of ptsharp_tpu/geometry/sdf.py (reference SDF.cs: the
primitives supersphere, cube, cylinder, capsule and torus; the operators
union, difference, intersection, transform, scale and repeat; sphere
tracing with jump-back refinement, SDF.cs:32-76). Each host node
contributes straight-line torch ops over the whole batch of points, so a
tree is one branch-free distance function; the sphere trace runs it in
geometry/march.py's lockstep loop. A node's vector constants are made once
per device and kept.

Distance parameters may be 0-d tensors; the march itself is detached, as
in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ptsharp_tpu_torch.core import vec
from ptsharp_tpu_torch.geometry.march import march

# Sphere-trace constants (reference SDFShape.Intersect, SDF.cs:34-37).
TRACE_EPS = 1e-5
TRACE_START = 1e-4
TRACE_JUMP = 1e-3
TRACE_MAX_STEPS = 1000


def _is_two(x) -> bool:
    return float(np.asarray(x)) == 2.0


def _affine(aff, p):
    """aff (3, 4) applied to points p (..., 3), as vec.affine applies it
    (the JAX package's einsum bit for bit, on every device); float64
    points (sdf_normal's) take a float64 affine in elementwise ops, the
    same bits on every device too."""
    if p.dtype == torch.float64:
        a64 = aff.double()
        return vec.dot(a64[:, :3], p[..., None, :]) + a64[:, 3]
    return vec.affine(aff, p)


class Sdf:
    """Base class: host CSG node. Subclasses implement
    `evaluate(p) -> (...,)` over (..., 3) points and `bounds() -> (lo, hi)`
    numpy arrays."""

    def evaluate(self, p):  # pragma: no cover - abstract
        raise NotImplementedError

    def bounds(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def _const(self, name: str, value, device) -> torch.Tensor:
        """`value` as a float32 tensor on `device`, made once."""
        if isinstance(value, torch.Tensor):
            return value.to(device=device, dtype=torch.float32)
        cache = self.__dict__.setdefault("_consts", {})
        key = (name, str(device))
        if key not in cache:
            cache[key] = torch.as_tensor(np.asarray(value, np.float32),
                                         device=device)
        return cache[key]

    # operator sugar
    def __or__(self, other):
        return SdfUnion(self, other)

    def __and__(self, other):
        return SdfIntersection(self, other)

    def __sub__(self, other):
        return SdfDifference(self, other)


@dataclass(eq=False)
class SdfSphere(Sdf):
    """Supersphere |p|_n - r (SphereSDF, SDF.cs:115-139)."""

    radius: Any = 1.0
    exponent: Any = 2.0

    def evaluate(self, p):
        if _is_two(self.exponent):
            return vec.length(p) - self.radius
        return vec.length_n(p, self.exponent) - self.radius

    def bounds(self):
        r = float(np.asarray(self.radius))
        return np.full(3, -r, np.float32), np.full(3, r, np.float32)


@dataclass(eq=False)
class SdfCube(Sdf):
    """Axis box of half-extents `size/2` centered at origin (CubeSDF)."""

    size: Any = (1.0, 1.0, 1.0)

    def evaluate(self, p):
        half = self._const("size", self.size, p.device) / 2.0
        q = torch.abs(p) - half
        outside = vec.length(torch.clamp(q, min=0.0))
        inside = torch.clamp(torch.amax(q, dim=-1), max=0.0)
        return outside + inside

    def bounds(self):
        half = np.asarray(self.size, np.float32) / 2.0
        return -half, half


@dataclass(eq=False)
class SdfCylinder(Sdf):
    """Capped Y-axis cylinder (CylinderSDF, SDF.cs:197-252)."""

    radius: Any = 1.0
    height: Any = 1.0

    def evaluate(self, p):
        h = self._const("height", self.height, p.device) / 2.0
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        dx = vec.sqrt(x * x + z * z) - self.radius
        dy = torch.abs(y) - h
        q = torch.stack([dx, dy], dim=-1)
        qp = torch.clamp(q, min=0.0)
        outside = vec.sqrt(vec.dot(qp, qp))
        inside = torch.clamp(torch.amax(q, dim=-1), max=0.0)
        return outside + inside

    def bounds(self):
        r = float(np.asarray(self.radius))
        h = float(np.asarray(self.height)) / 2.0
        return (np.array([-r, -h, -r], np.float32),
                np.array([r, h, r], np.float32))


@dataclass(eq=False)
class SdfCapsule(Sdf):
    """Capsule from a to b (CapsuleSDF, SDF.cs:254-285)."""

    a: Any = (0.0, -0.5, 0.0)
    b: Any = (0.0, 0.5, 0.0)
    radius: Any = 0.25
    exponent: Any = 2.0

    def evaluate(self, p):
        a = self._const("a", self.a, p.device)
        b = self._const("b", self.b, p.device)
        pa = p - a
        ba = b - a
        h = torch.clamp(vec.dot(pa, ba)
                        / torch.clamp(vec.dot(ba, ba), min=1e-12), 0.0, 1.0)
        d = pa - ba * h[..., None]
        if _is_two(self.exponent):
            return vec.length(d) - self.radius
        return vec.length_n(d, self.exponent) - self.radius

    def bounds(self):
        a = np.asarray(self.a, np.float32)
        b = np.asarray(self.b, np.float32)
        r = float(np.asarray(self.radius))
        return np.minimum(a, b) - r, np.maximum(a, b) + r


@dataclass(eq=False)
class SdfTorus(Sdf):
    """Torus in the XY plane (TorusSDF, SDF.cs:287-319)."""

    major: Any = 1.0
    minor: Any = 0.25
    major_exponent: Any = 2.0
    minor_exponent: Any = 2.0

    @staticmethod
    def _norm(q, e):
        if _is_two(e):
            return vec.sqrt(vec.dot(q, q))
        e = float(np.asarray(e))
        return vec.pow_f32(vec.sum_last(vec.pow_f32(torch.abs(q), e)),
                           1.0 / e)

    def evaluate(self, p):
        xy = torch.stack([p[..., 0], p[..., 1]], dim=-1)
        a = self._norm(xy, self.major_exponent) - self.major
        q = torch.stack([a, p[..., 2]], dim=-1)
        return self._norm(q, self.minor_exponent) - self.minor

    def bounds(self):
        b = float(np.asarray(self.major)) + float(np.asarray(self.minor))
        a = float(np.asarray(self.minor))
        return (np.array([-b, -b, -a], np.float32),
                np.array([b, b, a], np.float32))


class SdfUnion(Sdf):
    """min over children (UnionSDF)."""

    def __init__(self, *items):
        self.items = items

    def evaluate(self, p):
        d = self.items[0].evaluate(p)
        for it in self.items[1:]:
            d = torch.minimum(d, it.evaluate(p))
        return d

    def bounds(self):
        los, his = zip(*(it.bounds() for it in self.items))
        return np.min(np.stack(los), 0), np.max(np.stack(his), 0)


class SdfDifference(Sdf):
    """Successive subtraction max(d0, -d_i) (DifferenceSDF,
    SDF.cs:437-477)."""

    def __init__(self, *items):
        self.items = items

    def evaluate(self, p):
        d = self.items[0].evaluate(p)
        for it in self.items[1:]:
            d = torch.maximum(d, -it.evaluate(p))
        return d

    def bounds(self):
        return self.items[0].bounds()


class SdfIntersection(Sdf):
    """max over children (IntersectionSDF)."""

    def __init__(self, *items):
        self.items = items

    def evaluate(self, p):
        d = self.items[0].evaluate(p)
        for it in self.items[1:]:
            d = torch.maximum(d, it.evaluate(p))
        return d

    def bounds(self):
        los, his = zip(*(it.bounds() for it in self.items))
        # conservative: the intersection fits inside every child's box
        return np.max(np.stack(los), 0), np.min(np.stack(his), 0)


class SdfTransform(Sdf):
    """Evaluate the child at M^-1 p (TransformSDF, SDF.cs:321-352).
    `matrix` is a host 4x4; its inverse is applied as a 3x4 affine, as
    intersect._xform_point applies one (_affine: the JAX package's einsum
    bit for bit, on every device)."""

    def __init__(self, sdf: Sdf, matrix):
        self.sdf = sdf
        self.matrix = np.asarray(matrix, np.float32)
        self.inv = np.linalg.inv(self.matrix)

    def evaluate(self, p):
        q = _affine(self._const("inv", self.inv[:3, :4], p.device), p)
        return self.sdf.evaluate(q)

    def bounds(self):
        lo, hi = self.sdf.bounds()
        corners = np.array(
            [[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
             for z in (lo[2], hi[2])],
            np.float32,
        )
        world = corners @ self.matrix[:3, :3].T + self.matrix[:3, 3]
        return world.min(0), world.max(0)


class SdfScale(Sdf):
    """Uniform scale: f * child(p / f) (ScaleSDF, SDF.cs:355-381)."""

    def __init__(self, sdf: Sdf, factor):
        self.sdf = sdf
        self.factor = factor

    def evaluate(self, p):
        f = self._const("factor", self.factor, p.device)
        return self.sdf.evaluate(p / f) * f

    def bounds(self):
        lo, hi = self.sdf.bounds()
        f = float(np.asarray(self.factor))
        return lo * f, hi * f


class SdfRepeat(Sdf):
    """Mod-space tiling (RepeatSDF, SDF.cs:533-558) inside an explicit box
    (the tracer clips to it). Floor-mod, as jnp.mod: torch.remainder."""

    def __init__(self, sdf: Sdf, step, bounds_lo, bounds_hi):
        self.sdf = sdf
        self.step = np.asarray(step, np.float32)
        self._lo = np.asarray(bounds_lo, np.float32)
        self._hi = np.asarray(bounds_hi, np.float32)

    def evaluate(self, p):
        step = self._const("step", self.step, p.device)
        q = torch.remainder(p, step) - step / 2.0
        return self.sdf.evaluate(q)

    def bounds(self):
        return self._lo, self._hi


# ---------------------------------------------------------------------------
# Sphere tracing (batched)
# ---------------------------------------------------------------------------


def sphere_trace(sdf: Sdf, org, dirn, t_enter, t_exit,
                 max_steps: int = TRACE_MAX_STEPS,
                 tag: str | None = None):
    """March rays against one SDF object (ptsharp_tpu/geometry/sdf.py:292).
    org/dirn (R, 3), unit directions; t_enter/t_exit from the box clip.
    Step t += d; on the first sign flip jump back once and go on refining;
    accept where d < TRACE_EPS (SDF.cs:47-75). Returns t (R,), INF on a
    miss. Detached, as the JAX package's while_loop is: gradients stop at
    the march (shading gradients flow outside it)."""
    org, dirn = org.detach(), dirn.detach()
    t_enter, t_exit = t_enter.detach(), t_exit.detach()
    t0 = torch.clamp(t_enter, min=TRACE_START)
    active0 = t_exit >= torch.clamp(t_enter, min=0.0)

    def step(lanes, active):
        t, jump = lanes["t"], lanes["jump"]
        d = sdf.evaluate(lanes["org"] + lanes["dirn"] * t[:, None])
        # jump-back refinement on penetrating the surface
        do_jump_back = jump & (d < 0.0)
        hit_now = active & ~do_jump_back & (d < TRACE_EPS)
        lanes["hit_t"] = torch.where(hit_now, t, lanes["hit_t"])
        stride = torch.where(jump & (d < TRACE_JUMP),
                             torch.full_like(d, TRACE_JUMP), d)
        new_t = torch.where(do_jump_back, t - TRACE_JUMP, t + stride)
        lanes["jump"] = jump & ~do_jump_back
        lanes["t"] = new_t
        return active & ~hit_now & ~(new_t > lanes["t_exit"])

    lanes = dict(org=org, dirn=dirn, t=t0, t_exit=t_exit, jump=active0,
                 hit_t=torch.full_like(t0, vec.INF))
    return march(step, lanes, active0, ("hit_t",), max_steps,
                 tag)["hit_t"]


def sdf_normal(sdf: Sdf, p, eps: float = 1e-4):
    """Central-difference normal (SDFShape.NormalAt, SDF.cs:83-92): the six
    offset points evaluated as one batch, in float64, and the unit normal
    rounded to float32. In float32 (as the JAX package evaluates it) the
    difference of two distances over 2e-4 carries ~1e-3 of rounding noise
    that hangs on the last bit of p, so two devices whose rays differ by an
    ulp shade differently; in float64 the normal is the central difference
    itself, the same on every device: the JAX package's sdf_normal run on
    float64 points (jax x64) within 1e-6, its float32 one within its noise
    (tests/test_torch_shapes.py)."""
    offs = torch.zeros((6, 3), dtype=torch.float64, device=p.device)
    offs[[0, 2, 4], [0, 1, 2]] = eps
    offs[[1, 3, 5], [0, 1, 2]] = -eps
    d = sdf.evaluate(p.double()[None]
                     + offs.reshape(6, *([1] * (p.dim() - 1)), 3))
    n = torch.stack([d[0] - d[1], d[2] - d[3], d[4] - d[5]], dim=-1)
    return vec.normalize(n).to(p.dtype)
