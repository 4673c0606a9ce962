"""SoA 3-vector math over (..., 3) float tensors.

Counterpart of ptsharp_tpu/core/vec.py: the same pointwise functions and
constants, written with torch ops so the wavefront stays a batch of
tensors on whatever device it lives on. Precision is float32.

The scalar functions below (sqrt, rsqrt, sin, cos, acos, atan2, pow_f32)
and the 3x3 products (linear, affine) give the same float32 bits on the
CPU and on the card, and so does div, a division by a Python number: torch's float32 kernels of the two differ by an ulp
on a share of inputs (the CPU's sqrt on ~0.7%, the card's rsqrt, sin and
cos, the card's matrix library's summation order), and a ray a ulp away
can take another path at a silhouette or a light's edge. The
transcendentals run in float64 and round once (correctly rounded bar
rare double roundings); sqrt and division are exact on the card already.
"""

from __future__ import annotations

import torch

# INF doubles as the "no hit" t sentinel (reference Util.cs:10-11).
INF = 1e9
EPS = 1e-9


def vec3(x, y, z):
    """Build a (..., 3) tensor by stacking components on the last axis."""
    return torch.stack([x, y, z], dim=-1)


def sum_last(x):
    """Sum over the last axis left to right, in elementwise adds: the
    order of the JAX package's reductions (and of torch's on the CPU),
    which a card's reduction kernel need not keep."""
    terms = x.unbind(-1)
    total = terms[0]
    for t in terms[1:]:
        total = total + t
    return total


def dot(a, b):
    """Batched dot product -> (...,)."""
    return sum_last(a * b)


def vdot(a, b):
    """Batched dot product keeping the trailing axis -> (..., 1)."""
    return dot(a, b)[..., None]


def _f64(fn, *xs):
    if xs[0].dtype == torch.float32:
        return fn(*(x.double() for x in xs)).float()
    return fn(*xs)


def sqrt(x):
    """Correctly rounded square root on every device (torch's float32 CPU
    kernel misses by an ulp on ~0.7% of inputs)."""
    if x.device.type == "cpu":
        return _f64(torch.sqrt, x)
    return torch.sqrt(x)


def rsqrt(x):
    """1 / sqrt(x), the root correctly rounded, one rounded division:
    torch's float32 CPU rsqrt computes exactly this, the card's
    approximates."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.rsqrt(x)
    return 1.0 / torch.sqrt(x)


def sin(x):
    return _f64(torch.sin, x)


def cos(x):
    return _f64(torch.cos, x)


def acos(x):
    return _f64(torch.acos, x)


def atan2(y, x):
    return _f64(torch.atan2, y, x)


# (divisor, dtype, device) -> the divisor as a 0-d tensor there
_DIVISORS = {}


def div(x, d):
    """x / d for a Python number d, rounded as the CPU and the JAX package
    round it: by a 0-d tensor of x's dtype on x's device (the card takes a
    division by a Python number as a product with its reciprocal, which
    differs on a share of values unless d is a power of two)."""
    key = (float(d), x.dtype, x.device)
    t = _DIVISORS.get(key)
    if t is None:
        t = _DIVISORS[key] = torch.tensor(float(d), dtype=x.dtype,
                                          device=x.device)
    return x / t


def linear(m, v):
    """m (..., 3, 3+) times v (..., 3): each row's dot product the fused
    multiply-add chain fma(m2, v2, fma(m1, v1, m0 * v0)) that the JAX
    package's einsum (and torch's on the CPU) computes, each fma as a
    float64 multiply-add of the float32 operands (their product is exact
    there) rounded once to float32."""
    v = v[..., None, :]
    m64, v64 = m.double(), v.double()
    q = m[..., 0] * v[..., 0]
    for k in (1, 2):
        q = torch.addcmul(q.double(), m64[..., k], v64[..., k]).float()
    return q


def affine(aff, p):
    """aff (..., 3, 4) applied to points p (..., 3): linear(aff, p) plus
    the translation column."""
    return linear(aff, p) + aff[..., 3]


def cross(a, b):
    """a x b, each component fma(a_i, b_k, -(a_k * b_i)) as torch's CPU
    cross and the JAX package's compute it, the fma in float64 (exact
    products, one rounding), so the card gives the same bits."""
    a, b = torch.broadcast_tensors(a, b)
    i, k = [1, 2, 0], [2, 0, 1]
    q = a[..., k] * b[..., i]
    return (a[..., i].double() * b[..., k].double() - q.double()).float()


def length(a):
    return sqrt(torch.clamp(dot(a, a), min=0.0))


def pow_f32(x, e):
    """x ** e for a float32 exponent e. A float32 x's power is taken in
    float64 and rounded: the correctly rounded float32 power (as XLA's pow
    gives it, bar ~0.06% of inputs), the same on every device; torch's
    float32 pow misses by an ulp on 1-2% of inputs, and its special cases
    (e = 2, 3) multiply. A float64 x keeps its float64 power."""
    e = torch.tensor(float(e), dtype=torch.float32).item()
    if x.dtype == torch.float64:
        return torch.pow(x, e)
    return torch.pow(x.double(), e).float()


def length_n(a, n):
    """p-norm length (reference Vector.LengthN, the SDF supersphere's):
    (sum |a|^n)^(1/n) with n and 1/n in float32, as the JAX package takes
    them."""
    n32 = torch.tensor(float(n), dtype=torch.float32)
    inv = (1.0 / n32).item()
    terms = pow_f32(torch.abs(a), n32.item()).unbind(-1)
    total = terms[0]
    for x in terms[1:]:  # left to right, as the JAX package's sum
        total = total + x
    return pow_f32(total, inv)


def normalize(a, eps: float = 1e-20):
    """Unit vector; safe at 0 (returns ~0 rather than NaN)."""
    return a * rsqrt(torch.clamp(dot(a, a), min=eps))[..., None]


def distance(a, b):
    return length(a - b)


def min_axis(a):
    """Unit axis of the smallest |component| (reference Vector.MinAxis);
    ties go to x, then y."""
    ax = torch.abs(a)
    x, y, z = ax[..., 0], ax[..., 1], ax[..., 2]
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    use_x = (x <= y) & (x <= z)
    use_y = (y <= x) & (y <= z)
    return torch.where(use_x[..., None], eye[0],
                       torch.where(use_y[..., None], eye[1], eye[2]))


def min_component(a):
    return torch.amin(a, dim=-1)


def max_component(a):
    return torch.amax(a, dim=-1)


def reflect(n, i):
    """Mirror reflect incident direction `i` about normal `n`."""
    return i - 2.0 * vdot(n, i) * n


def refract(n, i, n1, n2):
    """Snell refraction of `i` at normal `n` from IOR n1 into n2; total
    internal reflection returns the zero vector. n1/n2 are (...,)."""
    cos_i = -dot(n, i)
    nr = torch.broadcast_to(n1 / n2, cos_i.shape)
    sin_t2 = nr * nr * (1.0 - cos_i * cos_i)
    tir = sin_t2 > 1.0
    cos_t = sqrt(torch.clamp(1.0 - sin_t2, min=0.0))
    t = nr[..., None] * i + (nr * cos_i - cos_t)[..., None] * n
    return torch.where(tir[..., None], torch.zeros_like(t), t)


def reflectance(n, i, n1, n2):
    """Unpolarized Fresnel reflectance of `i` hitting normal `n`;
    1 on total internal reflection. n1/n2 are (...,)."""
    shape = dot(n, i).shape
    n1 = torch.broadcast_to(n1, shape)
    n2 = torch.broadcast_to(n2, shape)
    nr2 = (n1 * n1) / (n2 * n2)
    cos_i = -dot(n, i)
    sin_t2 = nr2 * (1.0 - cos_i * cos_i)
    tir = sin_t2 > 1.0
    cos_t = sqrt(torch.clamp(1.0 - sin_t2, min=0.0))
    a = n1 * cos_i
    b = n2 * cos_t
    r_orth = (a - b) / torch.clamp(a + b, min=EPS)
    r_par = (b - a) / torch.clamp(b + a, min=EPS)
    r = 0.5 * (r_orth * r_orth + r_par * r_par)
    return torch.where(tir, torch.ones_like(r), torch.clamp(r, 0.0, 1.0))


def orthonormal_basis(w):
    """Branch-free ONB (t, b) perpendicular to unit vector w (Duff/Frisvad)."""
    z = w[..., 2]
    sign = torch.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = w[..., 0] * w[..., 1] * a
    t = vec3(
        1.0 + sign * w[..., 0] * w[..., 0] * a,
        sign * b,
        -sign * w[..., 0],
    )
    bb = vec3(b, sign + w[..., 1] * w[..., 1] * a, -w[..., 1])
    return t, bb
