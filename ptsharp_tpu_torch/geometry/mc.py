"""Iso-surface meshing of SDFs / implicit functions (host, numpy).

Capability parity with reference MC.cs (`NewSDFMesh`: sample a grid,
polygonize cells, return a Mesh — MC.cs:9-67, consumed by the spherical-
harmonics shape SH.cs:14-22). Implementation is *marching tetrahedra*
instead of the 256-entry marching-cubes table: each cell splits into 6
tetrahedra with a 16-case trivially-enumerable polygonization — fully
numpy-vectorized over the whole grid, no per-cell Python, and no giant
lookup table to transcribe. Output topology differs from MC but the surface
(and therefore render) is equivalent at equal step size.

A copy of ptsharp_tpu/geometry/mc.py. `evaluate` may be numpy code or one
of the port's Sdf trees (its `evaluate`, or the tree itself), which gets a
CPU float32 tensor of the points and may return a tensor: the grid is
evaluated in float32, as the JAX package's jnp call evaluates it, so the
grid signs, and with them the topology, are the same.
"""

from __future__ import annotations

import numpy as np

import torch

from ptsharp_tpu_torch.geometry.mesh import TriMesh
from ptsharp_tpu_torch.geometry.sdf import Sdf

# 6 tetrahedra per cube, as corner indices of the unit cube (0..7 with
# bit order x + 2y + 4z)
_TETS = np.array(
    [
        [0, 5, 1, 6],
        [0, 1, 2, 6],
        [0, 2, 3, 6],
        [0, 3, 7, 6],
        [0, 7, 4, 6],
        [0, 4, 5, 6],
    ],
    np.int32,
)

_CUBE_CORNERS = np.array(
    [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]],
    np.int32,
)


def _numpy_evaluate(evaluate):
    """`evaluate` over (N, 3) float32 numpy points -> (N,) numpy: an Sdf
    (or its bound evaluate) gets a CPU tensor of the points; a tensor
    result comes back as numpy."""
    if isinstance(evaluate, Sdf):
        evaluate = evaluate.evaluate
    takes_tensor = isinstance(getattr(evaluate, "__self__", None), Sdf)

    def run(pts):
        out = evaluate(torch.from_numpy(pts) if takes_tensor else pts)
        if isinstance(out, torch.Tensor):
            return out.detach().cpu().numpy()
        return np.asarray(out)

    return run


def sdf_mesh(evaluate, bmin, bmax, step: float) -> TriMesh:
    """Polygonize {evaluate(p) == 0}. `evaluate` maps (N, 3) -> (N,)
    (numpy, or an Sdf tree over CPU float32 tensors; called once on the
    full grid). Matches MC.NewSDFMesh's contract (sdf, box, step)."""
    evaluate = _numpy_evaluate(evaluate)
    bmin = np.asarray(bmin, np.float64)
    bmax = np.asarray(bmax, np.float64)
    dims = np.maximum(np.ceil((bmax - bmin) / step).astype(int) + 1, 2)
    nx, ny, nz = dims
    xs = bmin[0] + np.arange(nx) * step
    ys = bmin[1] + np.arange(ny) * step
    zs = bmin[2] + np.arange(nz) * step
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    vals = np.asarray(evaluate(pts.astype(np.float32))).reshape(nx, ny, nz)

    # per-cell corner values/positions: cells (nx-1, ny-1, nz-1)
    cx, cy, cz = nx - 1, ny - 1, nz - 1
    corner_vals = np.empty((cx, cy, cz, 8), np.float64)
    corner_pos = np.empty((cx, cy, cz, 8, 3), np.float64)
    for ci, (dx, dy, dz) in enumerate(_CUBE_CORNERS):
        corner_vals[..., ci] = vals[dx : dx + cx, dy : dy + cy, dz : dz + cz]
        corner_pos[..., ci, 0] = gx[dx : dx + cx, dy : dy + cy, dz : dz + cz]
        corner_pos[..., ci, 1] = gy[dx : dx + cx, dy : dy + cy, dz : dz + cz]
        corner_pos[..., ci, 2] = gz[dx : dx + cx, dy : dy + cy, dz : dz + cz]

    corner_vals = corner_vals.reshape(-1, 8)
    corner_pos = corner_pos.reshape(-1, 8, 3)
    # quick reject cells with uniform sign
    mixed = ~((corner_vals > 0).all(axis=1) | (corner_vals < 0).all(axis=1))
    corner_vals = corner_vals[mixed]
    corner_pos = corner_pos[mixed]
    if corner_vals.shape[0] == 0:
        return TriMesh(np.zeros((0, 3, 3), np.float32))

    tris = []
    for tet in _TETS:
        tv = corner_vals[:, tet]  # (C, 4)
        tp = corner_pos[:, tet]  # (C, 4, 3)
        inside = tv < 0.0
        case = (
            inside[:, 0].astype(int)
            + inside[:, 1].astype(int) * 2
            + inside[:, 2].astype(int) * 4
            + inside[:, 3].astype(int) * 8
        )

        def interp(sel, a, b):
            va = tv[sel, a]
            vb = tv[sel, b]
            t = va / np.where(np.abs(va - vb) < 1e-20, 1e-20, va - vb)
            t = np.clip(t, 0.0, 1.0)[:, None]
            return tp[sel, a] * (1 - t) + tp[sel, b] * t

        # one-inside cases (and complements) -> 1 triangle;
        # two-inside -> 2 triangles. Enumerate the 14 non-trivial cases.
        single = {
            1: (0, (1, 2, 3)), 2: (1, (0, 3, 2)), 4: (2, (0, 1, 3)),
            8: (3, (0, 2, 1)),
            14: (0, (1, 3, 2)), 13: (1, (0, 2, 3)), 11: (2, (0, 3, 1)),
            7: (3, (0, 1, 2)),
        }
        for code, (vin, (a, b, c)) in single.items():
            sel = case == code
            if not sel.any():
                continue
            p0 = interp(sel, vin, a)
            p1 = interp(sel, vin, b)
            p2 = interp(sel, vin, c)
            tris.append(np.stack([p0, p1, p2], axis=1))

        double = {
            3: (0, 1, 2, 3),  # 0,1 inside; cut edges 0-2,0-3,1-2,1-3
            5: (0, 2, 1, 3),
            9: (0, 3, 1, 2),
            6: (1, 2, 0, 3),
            10: (1, 3, 0, 2),
            12: (2, 3, 0, 1),
        }
        for code, (i0, i1, o0, o1) in double.items():
            sel = case == code
            if not sel.any():
                continue
            a = interp(sel, i0, o0)
            b = interp(sel, i0, o1)
            c = interp(sel, i1, o0)
            d = interp(sel, i1, o1)
            tris.append(np.stack([a, c, b], axis=1))
            tris.append(np.stack([b, c, d], axis=1))

    if not tris:
        return TriMesh(np.zeros((0, 3, 3), np.float32))
    v = np.concatenate(tris).astype(np.float32)
    # drop degenerate slivers
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    area2 = np.linalg.norm(np.cross(e1, e2), axis=1)
    v = v[area2 > 1e-14]
    mesh = TriMesh(v)
    # orient consistently outward (positive SDF side) via face normal vs
    # gradient sign at the centroid
    cen = v.mean(axis=1)
    eps = step * 0.5
    g = np.stack(
        [
            np.asarray(evaluate((cen + [eps, 0, 0]).astype(np.float32)))
            - np.asarray(evaluate((cen - [eps, 0, 0]).astype(np.float32))),
            np.asarray(evaluate((cen + [0, eps, 0]).astype(np.float32)))
            - np.asarray(evaluate((cen - [0, eps, 0]).astype(np.float32))),
            np.asarray(evaluate((cen + [0, 0, eps]).astype(np.float32)))
            - np.asarray(evaluate((cen - [0, 0, eps]).astype(np.float32))),
        ],
        axis=-1,
    )
    fn = mesh.face_normals()
    flip = np.sum(fn * g, axis=1) < 0
    vv = mesh.v.copy()
    vv[flip] = vv[flip][:, ::-1]
    return TriMesh(vv)
