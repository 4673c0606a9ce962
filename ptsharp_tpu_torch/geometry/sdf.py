"""Signed-distance-field CSG shapes with batched sphere tracing.

Counterpart of ptsharp_tpu/geometry/sdf.py (reference SDF.cs: the
primitives supersphere, cube, cylinder, capsule and torus; the operators
union, difference, intersection, transform, scale and repeat; sphere
tracing with jump-back refinement, SDF.cs:32-76). Each host node
contributes straight-line torch ops over the whole batch of points, so a
tree is one branch-free distance function; the sphere trace runs it in
geometry/march.py's lockstep loop. A node's vector constants are made once
per device and kept.

On a card the sphere trace is one kernel instead (csrc/sdf_march.cu,
kernels/sdf_march.py), which marches each ray to its end over the tree
compiled into a postfix program (`compile_program`), bit-equal to the
lockstep loop, which stays its plain version: rays on a CUDA device whose
tree holds only this module's node kinds take it (float32 rays and a tree
no deeper than its stacks, else ValueError); rays on any other device, or
a tree with any other Sdf subclass, take the lockstep loop.

Distance parameters may be 0-d tensors; the march itself is detached, as
in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ptsharp_tpu_torch.core import vec
from ptsharp_tpu_torch.geometry import march
from ptsharp_tpu_torch.kernels import sdf_march

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
# The tree as data: csrc/sdf_march.cu's program
# ---------------------------------------------------------------------------


class _Emitter:
    """Collects a program's instructions, constants and stack depth."""

    def __init__(self):
        self.code, self.pieces = [], []
        self.size = self.live = self.points = self.depth = 0
        self.numbers = True

    def op(self, name, *consts, flags=0, pushes=0):
        """One instruction; each constant (value, length), a number, an
        array or a tensor of that many values; `pushes` the distances it
        adds to the stack (a leaf 1, a join -1)."""
        self.code.append((sdf_march.OP[name], self.size, flags))
        for value, n in consts:
            if isinstance(value, torch.Tensor):
                if value.numel() != n:
                    raise _Unknown(f"{name}: {value.numel()} values")
                self.numbers = False
                piece = value.detach().reshape(-1)
            else:
                piece = np.asarray(value, np.float32).reshape(-1)
                if piece.size != n:
                    raise _Unknown(f"{name}: {piece.size} values")
            self.pieces.append(piece)
            self.size += n
        self.live += pushes
        self.depth = max(self.depth, self.live, self.points)

    def point(self, name, *consts):
        """A point op: saves the point for the subtree that follows."""
        self.points += 1
        self.op(name, *consts)

    def pop(self):
        self.points -= 1
        self.op("pop")

    def join(self, name, items):
        if not items:
            raise _Unknown(f"{name} of no items")
        self.emit(items[0])
        for it in items[1:]:
            self.emit(it)
            self.op(name, pushes=-1)

    def exponent(self, e):
        """length_n's float32 n and 1 / n (a float32 division)."""
        n32 = torch.tensor(float(e), dtype=torch.float32)
        return ((n32.item(), 1), ((1.0 / n32).item(), 1))

    def emit(self, node):
        kind = type(node)
        if kind is SdfSphere:
            if _is_two(node.exponent):
                self.op("sphere", (node.radius, 1), pushes=1)
            else:
                self.op("sphere_n", *self.exponent(node.exponent),
                        (node.radius, 1), pushes=1)
        elif kind is SdfCube:
            self.op("cube", (node.size, 3), pushes=1)
        elif kind is SdfCylinder:
            self.op("cylinder", (node.radius, 1), (node.height, 1),
                    pushes=1)
        elif kind is SdfCapsule:
            ends = ((node.a, 3), (node.b, 3), (node.radius, 1))
            if _is_two(node.exponent):
                self.op("capsule", *ends, pushes=1)
            else:
                self.op("capsule_n", *ends, *self.exponent(node.exponent),
                        pushes=1)
        elif kind is SdfTorus:
            flags, norms = 0, []
            for e, two in ((node.major_exponent, sdf_march.TORUS_MAJOR_TWO),
                           (node.minor_exponent, sdf_march.TORUS_MINOR_TWO)):
                if _is_two(e):
                    flags |= two
                    norms += [(2.0, 1), (0.5, 1)]
                else:  # SdfTorus._norm: float32(e), float32(1 / e)
                    e = float(np.asarray(e))
                    norms += [(np.float32(e), 1), (np.float32(1.0 / e), 1)]
            self.op("torus", (node.major, 1), (node.minor, 1), *norms,
                    flags=flags, pushes=1)
        elif kind is SdfUnion:
            self.join("union", node.items)
        elif kind is SdfIntersection:
            self.join("intersection", node.items)
        elif kind is SdfDifference:
            self.join("difference", node.items)
        elif kind is SdfTransform:
            self.point("affine", (node.inv[:3, :4], 12))
            self.emit(node.sdf)
            self.pop()
        elif kind is SdfScale:
            self.point("divide", (node.factor, 1))
            self.emit(node.sdf)
            self.pop()
            self.op("scale", (node.factor, 1))
        elif kind is SdfRepeat:
            self.point("repeat", (node.step, 3))
            self.emit(node.sdf)
            self.pop()
        else:
            raise _Unknown(f"no program for {kind.__name__}")

    def program(self, device) -> sdf_march.Program:
        code = torch.as_tensor(np.asarray(self.code, np.int32),
                               device=device)
        if self.numbers:
            consts = torch.as_tensor(np.concatenate(self.pieces),
                                     device=device)
        else:  # gathered on the device: no read of a tensor constant
            consts = torch.cat([
                p.to(device=device, dtype=torch.float32)
                if isinstance(p, torch.Tensor)
                else torch.as_tensor(p, device=device) for p in self.pieces])
        return sdf_march.Program(code, consts, self.depth)


class _Unknown(Exception):
    """A tree the program cannot hold."""


def compile_program(sdf: Sdf, device) -> sdf_march.Program | None:
    """The tree as csrc/sdf_march.cu's postfix program on `device`, or
    None where it holds a node of another kind than this module's (an Sdf
    subclass, say). Each constant is rounded to float32 as the torch ops
    round it; constants that are tensors are gathered into the buffer by
    device ops, with no read of the card. A tree whose constants are all
    numbers keeps its program, once per device. A tree deeper than the
    kernel's stacks (sdf_march.STACK) raises ValueError."""
    key = str(torch.device(device))
    cache = sdf.__dict__.setdefault("_programs", {})
    if key in cache:
        return cache[key]
    em = _Emitter()
    try:
        em.emit(sdf)
    except _Unknown:
        prog = None
    else:
        if em.depth > sdf_march.STACK:
            raise ValueError(f"an SDF tree that holds {em.depth} distances "
                             f"or points at once; the sphere-trace kernel "
                             f"holds {sdf_march.STACK}")
        prog = em.program(device)
    if em.numbers:
        cache[key] = prog
    return prog


def _kernel_program(sdf: Sdf, org, dirn, t_enter, t_exit):
    """The tree's program for rays on a CUDA device, else None (the
    lockstep loop): rays on any other device, or a tree with a node of
    another kind than this module's. On a card, rays of another dtype than
    float32 raise ValueError, as a tree deeper than the kernel's stacks
    does (compile_program)."""
    if org.device.type != "cuda":
        return None
    prog = compile_program(sdf, org.device)
    dtypes = {x.dtype for x in (org, dirn, t_enter, t_exit)}
    if prog is not None and dtypes != {torch.float32}:
        raise ValueError(f"the sphere-trace kernel takes float32 rays, got "
                         f"{sorted(map(str, dtypes))}")
    return prog


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
    the march (shading gradients flow outside it). Rays on a card with a
    tree of this module's kinds march in one kernel launch (march.fused),
    any others in geometry/march.py's lockstep loop, with the same bits;
    on a card, rays of another dtype than float32 or a tree deeper than
    the kernel's stacks raise ValueError."""
    org, dirn = org.detach(), dirn.detach()
    t_enter, t_exit = t_enter.detach(), t_exit.detach()
    t0 = torch.clamp(t_enter, min=TRACE_START)
    active0 = t_exit >= torch.clamp(t_enter, min=0.0)
    prog = _kernel_program(sdf, org, dirn, t_enter, t_exit)
    if prog is not None:
        lanes = [x.contiguous() for x in (org, dirn, t0, t_exit, active0)]
        return march.fused(
            lambda counts: sdf_march.march(prog, *lanes, max_steps, counts),
            tag, org.device)

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
    return march.march(step, lanes, active0, ("hit_t",), max_steps,
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
