"""Host-side triangle mesh container and utilities.

A numpy copy of ptsharp_tpu/geometry/mesh.py (the port imports nothing
from the JAX package): TriMesh with face, smooth and thresholded smooth
normals, move-to and fit-into-box normalization, plus the cube, quad and
icosphere generators. The arithmetic is kept line for line so scenes
built by the two packages are byte-equal.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(eq=False)
class TriMesh:
    """Triangle soup: v (T, 3, 3) vertices, n (T, 3, 3) vertex normals
    (zeros = derive face normals), uv (T, 3, 2) texture coords."""

    v: np.ndarray
    n: np.ndarray | None = None
    uv: np.ndarray | None = None
    mat: np.ndarray | None = None  # optional per-triangle material ids (T,)

    def __post_init__(self):
        self.v = np.asarray(self.v, np.float32)
        t = self.v.shape[0]
        if self.n is None:
            self.n = np.zeros((t, 3, 3), np.float32)
        else:
            self.n = np.asarray(self.n, np.float32)
        if self.uv is None:
            self.uv = np.zeros((t, 3, 2), np.float32)
        else:
            self.uv = np.asarray(self.uv, np.float32)
        if self.mat is not None:
            self.mat = np.asarray(self.mat, np.int32)

    @property
    def num_triangles(self) -> int:
        return self.v.shape[0]

    def face_normals(self) -> np.ndarray:
        e1 = self.v[:, 1] - self.v[:, 0]
        e2 = self.v[:, 2] - self.v[:, 0]
        n = np.cross(e1, e2)
        ln = np.linalg.norm(n, axis=-1, keepdims=True)
        return n / np.maximum(ln, 1e-20)

    def bounds(self):
        flat = self.v.reshape(-1, 3)
        return flat.min(axis=0), flat.max(axis=0)

    def fix_normals(self) -> "TriMesh":
        """Replace zero vertex normals with face normals."""
        fn = self.face_normals()
        zero = np.all(self.n == 0.0, axis=-1)  # (T, 3)
        n = self.n.copy()
        for k in range(3):
            n[zero[:, k], k] = fn[zero[:, k]]
        return TriMesh(self.v, n, self.uv, self.mat)

    def smooth_normals(self) -> "TriMesh":
        """Average face normals over shared vertex positions."""
        fn = self.face_normals()
        flat_v = self.v.reshape(-1, 3)
        # quantize positions to build the shared-vertex key
        key = np.round(flat_v * 1e5).astype(np.int64)
        uniq, inv = np.unique(key, axis=0, return_inverse=True)
        acc = np.zeros((uniq.shape[0], 3), np.float64)
        flat_fn = np.repeat(fn, 3, axis=0)
        np.add.at(acc, inv, flat_fn)
        ln = np.linalg.norm(acc, axis=-1, keepdims=True)
        acc = acc / np.maximum(ln, 1e-20)
        n = acc[inv].reshape(self.v.shape).astype(np.float32)
        return TriMesh(self.v, n, self.uv, self.mat)

    def smooth_normals_threshold(self, radians: float) -> "TriMesh":
        """Only average normals whose face normals are within the angle
        threshold (Mesh.SmoothNormalsThreshold)."""
        fn = self.face_normals()
        flat_v = self.v.reshape(-1, 3)
        key = np.round(flat_v * 1e5).astype(np.int64)
        uniq, inv = np.unique(key, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        cos_t = np.cos(radians)
        flat_fn = np.repeat(fn, 3, axis=0)  # (3T, 3) face normal per corner
        # group corners by vertex; average only similar normals
        n_out = np.empty_like(flat_fn)
        order = np.argsort(inv, kind="stable")
        sorted_inv = inv[order]
        boundaries = np.searchsorted(sorted_inv, np.arange(uniq.shape[0] + 1))
        for g in range(uniq.shape[0]):
            idxs = order[boundaries[g]:boundaries[g + 1]]
            group = flat_fn[idxs]  # (k, 3)
            sim = group @ group.T >= cos_t  # (k, k)
            avg = (sim[:, :, None] * group[None, :, :]).sum(axis=1)
            ln = np.linalg.norm(avg, axis=-1, keepdims=True)
            n_out[idxs] = avg / np.maximum(ln, 1e-20)
        return TriMesh(self.v, n_out.reshape(self.v.shape).astype(np.float32),
                       self.uv, self.mat)

    def transform(self, matrix: np.ndarray) -> "TriMesh":
        m = np.asarray(matrix, np.float32)
        v = self.v @ m[:3, :3].T + m[:3, 3]
        inv_t = np.linalg.inv(m[:3, :3]).T
        n = self.n @ inv_t.T
        ln = np.linalg.norm(n, axis=-1, keepdims=True)
        n = np.where(ln > 1e-20, n / np.maximum(ln, 1e-20), n)
        return TriMesh(v.astype(np.float32), n.astype(np.float32), self.uv,
                       self.mat)

    def move_to(self, position, anchor) -> "TriMesh":
        """Translate so the box anchor (0..1 per axis) lands at position
        (Mesh.MoveTo)."""
        lo, hi = self.bounds()
        anchor_pt = lo + (hi - lo) * np.asarray(anchor, np.float32)
        offset = np.asarray(position, np.float32) - anchor_pt
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = offset
        return self.transform(m)

    def fit_inside(self, bmin, bmax, anchor) -> "TriMesh":
        """Uniform-scale + translate into box (Mesh.FitInside)."""
        bmin = np.asarray(bmin, np.float32)
        bmax = np.asarray(bmax, np.float32)
        anchor = np.asarray(anchor, np.float32)
        lo, hi = self.bounds()
        scale = float(np.min((bmax - bmin) / np.maximum(hi - lo, 1e-20)))
        extra = (bmax - bmin) - (hi - lo) * scale
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] *= scale
        m[:3, 3] = -lo * scale + bmin + extra * anchor
        return self.transform(m)


def cube_mesh(bmin, bmax) -> TriMesh:
    """12-triangle axis box."""
    bmin = np.asarray(bmin, np.float32)
    bmax = np.asarray(bmax, np.float32)
    x0, y0, z0 = bmin
    x1, y1, z1 = bmax
    corners = np.array(
        [
            [x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
            [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1],
        ],
        np.float32,
    )
    quads = [
        (0, 3, 2, 1),  # z = z0
        (4, 5, 6, 7),  # z = z1
        (0, 1, 5, 4),  # y = y0
        (3, 7, 6, 2),  # y = y1
        (0, 4, 7, 3),  # x = x0
        (1, 2, 6, 5),  # x = x1
    ]
    tris = []
    for a, b, c, d in quads:
        tris.append([corners[a], corners[b], corners[c]])
        tris.append([corners[a], corners[c], corners[d]])
    return TriMesh(np.array(tris, np.float32))


def quad_mesh(p0, p1, p2, p3) -> TriMesh:
    """Two-triangle quad (counter-clockwise corners): the standard area
    light, whose triangles NEE samples by area when it emits."""
    p0, p1, p2, p3 = (np.asarray(p, np.float32) for p in (p0, p1, p2, p3))
    uv = np.array(
        [[[0, 0], [1, 0], [1, 1]], [[0, 0], [1, 1], [0, 1]]], np.float32
    )
    return TriMesh(np.array([[p0, p1, p2], [p0, p2, p3]], np.float32), uv=uv)


def sphere_mesh(center, radius, subdivisions: int = 3) -> TriMesh:
    """Icosphere."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    verts = verts / np.linalg.norm(verts, axis=-1, keepdims=True)
    tris = verts[np.array(faces)]

    def norm(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    for _ in range(subdivisions):
        a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
        ab, bc, ca = norm((a + b) / 2), norm((b + c) / 2), norm((c + a) / 2)
        tris = np.concatenate(
            [
                np.stack([a, ab, ca], axis=1),
                np.stack([ab, b, bc], axis=1),
                np.stack([ca, bc, c], axis=1),
                np.stack([ab, bc, ca], axis=1),
            ]
        )
    n = tris.copy()
    v = tris * radius + np.asarray(center, np.float64)
    return TriMesh(v.astype(np.float32), n.astype(np.float32))
