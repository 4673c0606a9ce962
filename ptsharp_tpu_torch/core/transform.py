"""4x4 homogeneous transforms as (4, 4) float32 tensors on the CPU.

Counterpart of ptsharp_tpu/core/transform.py (reference Matrix.cs:
translate, scale, rotate, frustum, orthographic, perspective, look-at,
point and direction application, box transform, inverse). Matrices are
host-side scene data: SceneBuilder's `transform=` takes anything
np.asarray takes, these included.

Convention as the reference's: row-major M, column-vector application
p' = M @ [p, 1].
"""

from __future__ import annotations

import math

import torch

from ptsharp_tpu_torch.core import vec

_F32 = torch.float32


def _t(x):
    return torch.as_tensor(x, dtype=_F32)


def identity():
    return torch.eye(4, dtype=_F32)


def translate(v):
    m = torch.eye(4, dtype=_F32)
    m[:3, 3] = _t(v)
    return m


def scale(v):
    return torch.diag(torch.cat([_t(v), torch.ones(1, dtype=_F32)]))


def rotate(axis, theta):
    """Rotation about (unnormalised ok) `axis` by `theta` radians
    (Matrix.cs Rotate)."""
    x, y, z = vec.normalize(_t(axis)).tolist()
    theta = _t(theta)
    s, c = torch.sin(theta), torch.cos(theta)
    m = 1.0 - c
    return torch.stack([
        torch.stack([m * x * x + c, m * x * y + z * s, m * z * x - y * s,
                     torch.zeros((), dtype=_F32)]),
        torch.stack([m * x * y - z * s, m * y * y + c, m * y * z + x * s,
                     torch.zeros((), dtype=_F32)]),
        torch.stack([m * z * x + y * s, m * y * z - x * s, m * z * z + c,
                     torch.zeros((), dtype=_F32)]),
        _t([0.0, 0.0, 0.0, 1.0]),
    ])


def frustum(l, r, b, t, n, f):
    t1, t2, t3, t4 = 2 * n, r - l, t - b, f - n
    return _t([[t1 / t2, 0, (r + l) / t2, 0],
               [0, t1 / t3, (t + b) / t3, 0],
               [0, 0, (-f - n) / t4, (-t1 * f) / t4],
               [0, 0, -1, 0]])


def orthographic(l, r, b, t, n, f):
    return _t([[2 / (r - l), 0, 0, -(r + l) / (r - l)],
               [0, 2 / (t - b), 0, -(t + b) / (t - b)],
               [0, 0, -2 / (f - n), -(f + n) / (f - n)],
               [0, 0, 0, 1]])


def perspective(fovy_deg, aspect, near, far):
    ymax = near * float(torch.tan(_t(math.radians(fovy_deg)) / 2.0))
    xmax = ymax * aspect
    return frustum(-xmax, xmax, -ymax, ymax, near, far)


def look_at_matrix(eye, center, up):
    """Matrix.LookAtMatrix (camera-to-world for the GL convention)."""
    eye = _t(eye)
    up = vec.normalize(_t(up))
    f = vec.normalize(_t(center) - eye)
    s = vec.normalize(vec.cross(f, up))
    u = vec.normalize(vec.cross(s, f))
    zero = torch.zeros(1, dtype=_F32)
    m = torch.stack([torch.cat([s, zero]), torch.cat([u, zero]),
                     torch.cat([-f, zero]), _t([0.0, 0.0, 0.0, 1.0])],
                    dim=1)
    return m @ translate(-eye)


def mul(a, b):
    return a @ b


def mul_position(m, p):
    """Apply to points (..., 3), with the translation."""
    return torch.einsum("ij,...j->...i", m[:3, :3], p) + m[:3, 3]


def mul_direction(m, d):
    """Apply to directions (no translation), renormalised
    (Matrix.MulDirection)."""
    return vec.normalize(torch.einsum("ij,...j->...i", m[:3, :3], d))


def mul_direction_raw(m, d):
    """The linear part alone, not renormalised (keeps t scales)."""
    return torch.einsum("ij,...j->...i", m[:3, :3], d)


def mul_box(m, bmin, bmax):
    """Transformed box by the Arvo corner-sum trick (Matrix.MulBox)."""
    r, t = m[:3, :3], m[:3, 3]
    a, b = r * bmin[None, :], r * bmax[None, :]
    return (t + torch.sum(torch.minimum(a, b), dim=1),
            t + torch.sum(torch.maximum(a, b), dim=1))


def inverse(m):
    return torch.linalg.inv(m)


def transpose(m):
    return m.T


def determinant(m):
    return torch.linalg.det(m)
