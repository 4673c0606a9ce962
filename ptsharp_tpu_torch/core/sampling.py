"""Monte-Carlo sampling primitives over ray wavefronts.

Counterpart of ptsharp_tpu/core/sampling.py. The uniforms come from
core/rng.py, so a render is a deterministic function of
(scene, config, key) in both packages.
"""

from __future__ import annotations

import math

import torch

from ptsharp_tpu_torch.core import rng, vec


def uniform_disc(u1, u2):
    """Polar mapping to the unit disc -> (x, y), each (...,): angle
    uniform, radius uniform (not sqrt), as the reference's aperture
    sampling (Camera.cs:110-113)."""
    angle = u1 * 2.0 * math.pi
    return vec.cos(angle) * u2, vec.sin(angle) * u2


def uniform_disc_area(u1, u2):
    """Area-uniform unit disc point (sqrt radius), used for NEE light discs."""
    angle = u1 * 2.0 * math.pi
    radius = vec.sqrt(u2)
    return vec.cos(angle) * radius, vec.sin(angle) * radius


def uniform_sphere(u1, u2):
    """Uniform direction on the unit sphere (Vector.RandomUnitVector)."""
    z = 1.0 - 2.0 * u1
    r = vec.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * math.pi * u2
    return vec.vec3(r * vec.cos(phi), r * vec.sin(phi), z)


def cosine_hemisphere(n, u1, u2):
    """Cosine-weighted hemisphere direction about unit normal n."""
    t, b = vec.orthonormal_basis(n)
    radius = vec.sqrt(u1)
    theta = 2.0 * math.pi * u2
    x = radius * vec.cos(theta)
    y = radius * vec.sin(theta)
    z = vec.sqrt(torch.clamp(1.0 - u1, min=0.0))
    return t * x[..., None] + b * y[..., None] + n * z[..., None]


def cone(d, theta_max, u1, u2):
    """Perturb unit direction d inside a cone of half-angle theta_max
    (..., per ray). theta_max < EPS returns d unchanged."""
    theta_max = torch.broadcast_to(theta_max, u1.shape)
    theta = theta_max * (1.0 - vec.div(
        2.0 * vec.acos(torch.clamp(u1, 0.0, 1.0)), math.pi))
    m1 = vec.sin(theta)
    m2 = vec.cos(theta)
    a = u2 * 2.0 * math.pi
    s, t = vec.orthonormal_basis(d)
    out = (
        s * (m1 * vec.cos(a))[..., None]
        + t * (m1 * vec.sin(a))[..., None]
        + d * m2[..., None]
    )
    out = vec.normalize(out)
    return torch.where((theta_max < vec.EPS)[..., None], d, out)


def stratified_pair(base_u, base_v, n: int, idx):
    """Map sample index idx in [0, n*n) plus jitter (base_u, base_v) in
    [0,1) to a stratified (u, v) on the n x n grid."""
    iu = (idx % n).to(base_u.dtype)
    iv = torch.div(idx, n, rounding_mode="floor").to(base_v.dtype)
    nf = float(n)
    return vec.div(iu + base_u, nf), vec.div(iv + base_v, nf)


def uniforms(key, shape_or_num, num=None):
    """float32 uniforms on the key's device. uniforms(key, 3) -> a tuple
    of 3 (...,)-shaped draws for a batch of keys of shape (..., 2), each
    key's draws uniform(key_i, (3,)); uniforms(key, shape, num) -> a
    tensor of shape + (num,)."""
    if num is not None:
        return rng.uniform(key, tuple(shape_or_num) + (num,))
    n = int(shape_or_num)
    draws = (rng.uniform_per_key(key, n) if key.ndim > 1
             else rng.uniform(key, (n,)))
    return tuple(draws[..., i] for i in range(n))
