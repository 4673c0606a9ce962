"""SoA 3-vector math over (..., 3) float tensors.

Counterpart of ptsharp_tpu/core/vec.py: the same pointwise functions and
constants, written with torch ops so the wavefront stays a batch of
tensors on whatever device it lives on. Precision is float32.
"""

from __future__ import annotations

import torch

# INF doubles as the "no hit" t sentinel (reference Util.cs:10-11).
INF = 1e9
EPS = 1e-9


def vec3(x, y, z):
    """Build a (..., 3) tensor by stacking components on the last axis."""
    return torch.stack([x, y, z], dim=-1)


def dot(a, b):
    """Batched dot product -> (...,)."""
    return torch.sum(a * b, dim=-1)


def vdot(a, b):
    """Batched dot product keeping the trailing axis -> (..., 1)."""
    return torch.sum(a * b, dim=-1, keepdim=True)


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def length(a):
    return torch.sqrt(torch.clamp(dot(a, a), min=0.0))


def normalize(a, eps: float = 1e-20):
    """Unit vector; safe at 0 (returns ~0 rather than NaN)."""
    return a * torch.rsqrt(torch.clamp(dot(a, a), min=eps))[..., None]


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
    cos_t = torch.sqrt(torch.clamp(1.0 - sin_t2, min=0.0))
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
    cos_t = torch.sqrt(torch.clamp(1.0 - sin_t2, min=0.0))
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
