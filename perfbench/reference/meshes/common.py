"""Shared steps of the procedural meshes: the icosphere, smooth vertex
normals and the fit into a box, in float32/float64 NumPy as the scenes'
published recipes state them."""

from __future__ import annotations

import numpy as np

_ICO_FACES = [
    (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
    (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
    (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
    (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
]


def icosphere(subdivisions: int) -> np.ndarray:
    """Unit icosphere triangles (T, 3, 3) in float64: each subdivision
    splits a face into four at its edges' midpoints, pushed onto the
    sphere."""
    g = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([[-1, g, 0], [1, g, 0], [-1, -g, 0], [1, -g, 0],
                      [0, -1, g], [0, 1, g], [0, -1, -g], [0, 1, -g],
                      [g, 0, -1], [g, 0, 1], [-g, 0, -1], [-g, 0, 1]],
                     np.float64)
    verts = verts / np.linalg.norm(verts, axis=-1, keepdims=True)
    tris = verts[np.array(_ICO_FACES)]

    def onto(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    for _ in range(subdivisions):
        a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
        ab, bc, ca = onto((a + b) / 2), onto((b + c) / 2), onto((c + a) / 2)
        tris = np.concatenate([np.stack([a, ab, ca], axis=1),
                               np.stack([ab, b, bc], axis=1),
                               np.stack([ca, bc, c], axis=1),
                               np.stack([ab, bc, ca], axis=1)])
    return tris


def face_normals(v: np.ndarray) -> np.ndarray:
    n = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)


def smooth_normals(v: np.ndarray) -> np.ndarray:
    """Vertex normals: the face normals averaged over corners that share a
    position (positions keyed at 1e-5)."""
    fn = face_normals(v)
    keys = np.round(v.reshape(-1, 3) * 1e5).astype(np.int64)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    acc = np.zeros((uniq.shape[0], 3), np.float64)
    np.add.at(acc, inv.reshape(-1), np.repeat(fn, 3, axis=0))
    acc = acc / np.maximum(np.linalg.norm(acc, axis=-1, keepdims=True), 1e-20)
    return acc[inv.reshape(-1)].reshape(v.shape).astype(np.float32)


def fit_inside(v, n, bmin, bmax, anchor):
    """Scale uniformly and move the mesh into the box [bmin, bmax], placed
    by `anchor` (0..1 an axis) in the room left over."""
    bmin, bmax, anchor = (np.asarray(x, np.float32)
                          for x in (bmin, bmax, anchor))
    flat = v.reshape(-1, 3)
    lo, hi = flat.min(axis=0), flat.max(axis=0)
    scale = float(np.min((bmax - bmin) / np.maximum(hi - lo, 1e-20)))
    extra = (bmax - bmin) - (hi - lo) * scale
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] *= scale
    m[:3, 3] = -lo * scale + bmin + extra * anchor
    v2 = v @ m[:3, :3].T + m[:3, 3]
    inv_t = np.linalg.inv(m[:3, :3]).T
    n2 = n @ inv_t.T
    ln = np.linalg.norm(n2, axis=-1, keepdims=True)
    n2 = np.where(ln > 1e-20, n2 / np.maximum(ln, 1e-20), n2)
    return v2.astype(np.float32), n2.astype(np.float32)


def displaced_sphere(subdivisions: int, seed: int, normals: bool = True):
    """The icosphere displaced by a band of sines and two bumps, squashed
    in y; uv the sphere's lat-long. Returns float32 (v, n, uv), n the
    smooth normals (None unless `normals`)."""
    # the icosphere's corners are stored in float32 before displacement
    v = icosphere(subdivisions).astype(np.float32).reshape(-1, 3) \
        .astype(np.float64)
    d = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    p1, p2, p3 = (np.random.default_rng(seed).uniform(0, 2 * np.pi, 3)
                  if seed != 11 else (0.0, 0.0, 0.0))
    disp = (0.16 * np.sin(5.1 * x + 1.3 + p1) * np.sin(4.3 * y + p2)
            + 0.11 * np.sin(7.7 * z + 0.5 + p2) * np.cos(6.1 * x + p3)
            + 0.07 * np.sin(11.0 * y + 2.1 + p3) * np.sin(9.0 * z + p1)
            + 0.23 * np.exp(-18.0 * ((x - 0.25) ** 2 + (y - 0.85) ** 2
                                     + z**2))
            + 0.23 * np.exp(-18.0 * ((x + 0.25) ** 2 + (y - 0.85) ** 2
                                     + z**2)))
    v2 = d * (1.0 + disp)[:, None]
    v2[:, 1] *= 0.92
    verts = v2.reshape(-1, 3, 3).astype(np.float32)
    uv = np.stack([0.5 + np.arctan2(z, x) / (2 * np.pi),
                   0.5 + np.arcsin(np.clip(y, -1, 1)) / np.pi],
                  axis=-1).astype(np.float32).reshape(-1, 3, 2)
    return verts, smooth_normals(verts) if normals else None, uv
