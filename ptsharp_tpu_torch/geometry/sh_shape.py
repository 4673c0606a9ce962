"""Spherical-harmonics lobe shape: the implicit surface r = |Y_lm(dir)|.

Parity with reference SH.cs: the shape is pre-meshed at construction via
iso-surface extraction (SH.cs:14-22 uses marching cubes; we use the
marching-tetrahedra mesher in mc.py) and rendered as a mesh; the material
switches between positive and negative lobes (SH.cs:62-73). Real SH basis
hardcoded for l = 0..4 (SH.cs:103-249 equivalent, derived independently
from the standard real-SH closed forms).
"""

from __future__ import annotations

import math

import numpy as np

from ptsharp_tpu_torch.geometry.mc import sdf_mesh
from ptsharp_tpu_torch.geometry.mesh import TriMesh


def real_sh(l: int, m: int, p: np.ndarray) -> np.ndarray:
    """Real spherical harmonic Y_l^m evaluated at unit directions p (N, 3).
    Supports l in 0..4, |m| <= l (closed forms in Cartesian coords)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    pi = math.pi
    s = math.sqrt

    if l == 0:
        return np.full(x.shape, 0.5 * s(1 / pi))
    if l == 1:
        c = 0.5 * s(3 / pi)
        return {-1: c * y, 0: c * z, 1: c * x}[m]
    if l == 2:
        if m == -2:
            return 0.5 * s(15 / pi) * x * y
        if m == -1:
            return 0.5 * s(15 / pi) * y * z
        if m == 0:
            return 0.25 * s(5 / pi) * (3 * z * z - 1)
        if m == 1:
            return 0.5 * s(15 / pi) * x * z
        if m == 2:
            return 0.25 * s(15 / pi) * (x * x - y * y)
    if l == 3:
        if m == -3:
            return 0.25 * s(35 / (2 * pi)) * y * (3 * x * x - y * y)
        if m == -2:
            return 0.5 * s(105 / pi) * x * y * z
        if m == -1:
            return 0.25 * s(21 / (2 * pi)) * y * (5 * z * z - 1)
        if m == 0:
            return 0.25 * s(7 / pi) * z * (5 * z * z - 3)
        if m == 1:
            return 0.25 * s(21 / (2 * pi)) * x * (5 * z * z - 1)
        if m == 2:
            return 0.25 * s(105 / pi) * (x * x - y * y) * z
        if m == 3:
            return 0.25 * s(35 / (2 * pi)) * x * (x * x - 3 * y * y)
    if l == 4:
        if m == -4:
            return 0.75 * s(35 / pi) * x * y * (x * x - y * y)
        if m == -3:
            return 0.75 * s(35 / (2 * pi)) * y * (3 * x * x - y * y) * z
        if m == -2:
            return 0.75 * s(5 / pi) * x * y * (7 * z * z - 1)
        if m == -1:
            return 0.75 * s(5 / (2 * pi)) * y * z * (7 * z * z - 3)
        if m == 0:
            return (3.0 / 16) * s(1 / pi) * (35 * z**4 - 30 * z * z + 3)
        if m == 1:
            return 0.75 * s(5 / (2 * pi)) * x * z * (7 * z * z - 3)
        if m == 2:
            return (3.0 / 8) * s(5 / pi) * (x * x - y * y) * (7 * z * z - 1)
        if m == 3:
            return 0.75 * s(35 / (2 * pi)) * x * (x * x - 3 * y * y) * z
        if m == 4:
            return (3.0 / 16) * s(35 / pi) * (
                x * x * (x * x - 3 * y * y) - y * y * (3 * x * x - y * y)
            )
    raise ValueError(f"unsupported l={l}, m={m}")


def sh_implicit(l: int, m: int, pts: np.ndarray) -> np.ndarray:
    """Implicit value r - |Y_lm(p/r)| (SH.cs:93-101): negative inside the
    lobe surface."""
    r = np.linalg.norm(pts, axis=-1)
    safe = np.maximum(r, 1e-9)
    d = pts / safe[..., None]
    return r - np.abs(real_sh(l, m, d))


def sh_lobe_sign(l: int, m: int, p: np.ndarray) -> np.ndarray:
    """+1 on positive lobes, -1 on negative (for the two-material switch,
    SH.cs:62-73)."""
    r = np.maximum(np.linalg.norm(p, axis=-1), 1e-9)
    return np.where(real_sh(l, m, p / r[..., None]) >= 0, 1, -1)


def sh_meshes(l: int, m: int, step: float = 0.02) -> tuple[TriMesh, TriMesh]:
    """Mesh the SH lobe surface and split triangles into (positive-lobe,
    negative-lobe) meshes so each can carry its own material — the
    flattened equivalent of SH.cs's per-point material switch."""
    bound = 1.0  # |Y_lm| <= ~0.6 for l<=4; unit box is safe
    mesh = sdf_mesh(lambda p: sh_implicit(l, m, p), [-bound] * 3,
                    [bound] * 3, step)
    mesh = mesh.smooth_normals()
    cen = mesh.v.mean(axis=1)
    sign = sh_lobe_sign(l, m, cen)
    pos = TriMesh(mesh.v[sign > 0], mesh.n[sign > 0], mesh.uv[sign > 0])
    neg = TriMesh(mesh.v[sign < 0], mesh.n[sign < 0], mesh.uv[sign < 0])
    return pos, neg


def add_sh_shape(builder, l: int, m: int, pos_material, neg_material,
                 transform=None, step: float = 0.02):
    """Register an SH lobe shape with a SceneBuilder (two-material)."""
    pos, neg = sh_meshes(l, m, step)
    ids = []
    if pos.num_triangles:
        ids.append(builder.add_mesh(pos, pos_material, transform=transform))
    if neg.num_triangles:
        ids.append(builder.add_mesh(neg, neg_material, transform=transform))
    return ids
