"""Host-side BVH construction -> flattened skip-link arrays.

A numpy copy of ptsharp_tpu/accel/bvh.py: the native binned-SAH builder
when it can be compiled, else the Morton LBVH, both returning preorder
node arrays with skip links. The result also names the builder that made
it (`FlatBVH.builder`), so a run can report which one fed its tables;
`last_builder` and `build_counts` keep the same per process, and each
build logs its builder at INFO, as in the JAX package.

Flattened node arrays (all length N, preorder):
  bmin, bmax : (N, 3) float32 node AABB
  first      : (N,)  int32  leaf -> first triangle in the *sorted* order
  count      : (N,)  int32  leaf -> triangle count (0 for internal nodes)
  skip       : (N,)  int32  preorder index after this node's subtree
"""

from __future__ import annotations

import logging
import sys
from typing import NamedTuple

import numpy as np

logger = logging.getLogger(__name__)

# the builder of the last build() ("sah" or "morton") and a count of each
last_builder: str | None = None
build_counts = {"sah": 0, "morton": 0}


class FlatBVH(NamedTuple):
    bmin: np.ndarray
    bmax: np.ndarray
    first: np.ndarray
    count: np.ndarray
    skip: np.ndarray
    order: np.ndarray  # permutation: sorted-tri -> original-tri index
    max_leaf: int
    builder: str  # "sah" (native) or "morton"


def _expand_bits(v: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of v so consecutive bits are 3 apart."""
    v = v.astype(np.uint64)
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3(points01: np.ndarray) -> np.ndarray:
    """30-bit Morton codes for (T, 3) points in [0, 1]."""
    q = np.clip(points01 * 1024.0, 0.0, 1023.0).astype(np.uint32)
    return (
        (_expand_bits(q[:, 0]) << 2)
        | (_expand_bits(q[:, 1]) << 1)
        | _expand_bits(q[:, 2])
    )


def build(tri_bmin: np.ndarray, tri_bmax: np.ndarray,
          leaf_size: int = 8) -> FlatBVH:
    """Build from per-triangle AABBs (T, 3) with the native binned-SAH
    builder, or the Morton LBVH where it cannot be compiled. Callers
    reorder their vertex/attribute arrays by `order` so leaf blocks are
    contiguous."""
    global last_builder
    t = tri_bmin.shape[0]
    if t <= 0:
        raise ValueError("empty BVH")
    from ptsharp_tpu_torch.accel import native

    out = native.build_bvh_sah(tri_bmin, tri_bmax, leaf_size)
    last_builder = "sah" if out is not None else "morton"
    build_counts[last_builder] += 1
    logger.info("bvh.build: %s, %d tris, leaf_size=%d", last_builder, t,
                leaf_size)
    if out is not None:
        bmin, bmax, first, count, skip, order = out
        return FlatBVH(bmin, bmax, first, count, skip, order, leaf_size,
                       "sah")
    centroids = 0.5 * (tri_bmin + tri_bmax)
    lo = centroids.min(axis=0)
    hi = centroids.max(axis=0)
    extent = np.maximum(hi - lo, 1e-12)
    codes = morton3((centroids - lo) / extent)
    order = np.argsort(codes, kind="stable").astype(np.int32)

    sb_min = tri_bmin[order]
    sb_max = tri_bmax[order]

    n_leaves = -(-t // leaf_size)
    lp = 1 << max(0, (n_leaves - 1).bit_length())  # pad to power of two
    depth = lp.bit_length() - 1  # perfect tree depth (leaves at `depth`)

    leaf_min = np.full((lp, 3), np.float32(np.inf))
    leaf_max = np.full((lp, 3), np.float32(-np.inf))
    pad = (-t) % leaf_size
    if pad:
        sb_min_p = np.concatenate(
            [sb_min, np.full((pad, 3), np.inf, np.float32)])
        sb_max_p = np.concatenate(
            [sb_max, np.full((pad, 3), -np.inf, np.float32)])
    else:
        sb_min_p, sb_max_p = sb_min, sb_max
    leaf_min[:n_leaves] = sb_min_p.reshape(n_leaves, leaf_size, 3).min(axis=1)
    leaf_max[:n_leaves] = sb_max_p.reshape(n_leaves, leaf_size, 3).max(axis=1)

    level_min = [leaf_min]
    level_max = [leaf_max]
    while level_min[-1].shape[0] > 1:
        cur_min, cur_max = level_min[-1], level_max[-1]
        level_min.append(np.minimum(cur_min[0::2], cur_min[1::2]))
        level_max.append(np.maximum(cur_max[0::2], cur_max[1::2]))
    level_min.reverse()  # level_min[d] = bounds of the 2^d nodes at depth d
    level_max.reverse()

    # preorder flatten over the implicit perfect tree, pruning pad subtrees
    n_nodes_cap = 2 * lp - 1
    bmin = np.empty((n_nodes_cap, 3), np.float32)
    bmax = np.empty((n_nodes_cap, 3), np.float32)
    first = np.zeros(n_nodes_cap, np.int32)
    count = np.zeros(n_nodes_cap, np.int32)
    skip = np.zeros(n_nodes_cap, np.int32)
    out = 0
    stack = [(0, 0)]
    while stack:
        d, i = stack.pop()
        if not np.isfinite(level_min[d][i][0]):
            continue  # pad subtree: nothing real inside
        idx = out
        out += 1
        bmin[idx] = level_min[d][i]
        bmax[idx] = level_max[d][i]
        if d == depth:  # leaf
            start = i * leaf_size
            first[idx] = start
            count[idx] = max(min(leaf_size, t - start), 0)
        else:
            stack.append((d + 1, 2 * i + 1))
            stack.append((d + 1, 2 * i))
    n = out

    # skip link = preorder index + subtree size
    sizes = np.zeros(n, np.int32)
    out2 = 0

    def emit(d, i):
        nonlocal out2
        if not np.isfinite(level_min[d][i][0]):
            return 0
        my = out2
        out2 += 1
        total = 1
        if d != depth:
            total += emit(d + 1, 2 * i)
            total += emit(d + 1, 2 * i + 1)
        sizes[my] = total
        return total

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, depth * 4 + 1000))
    try:
        emit(0, 0)
    finally:
        sys.setrecursionlimit(old_limit)
    skip[:n] = np.arange(n, dtype=np.int32) + sizes[:n]

    return FlatBVH(bmin[:n].copy(), bmax[:n].copy(), first[:n].copy(),
                   count[:n].copy(), skip[:n].copy(), order, leaf_size,
                   "morton")
