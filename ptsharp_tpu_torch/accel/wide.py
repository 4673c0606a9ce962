"""Wide-node (BVH-K) collapse of the binary flattened BVH.

A numpy copy of ptsharp_tpu/accel/wide.py. A K-wide node row carries the
node's own box plus its K children's boxes and preorder indices, so one
row read decides a K-way step.

Collapse: top-down. A wide node's children start as the binary node's two
children; the internal child with the largest surface area is repeatedly
replaced by its own two children until K subtree roots exist.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class WideBVH(NamedTuple):
    """Flattened K-wide BVH (preorder). Absent children have index 0 and
    inverted boxes (never hit)."""

    bmin: np.ndarray        # (Nw, 3)
    bmax: np.ndarray        # (Nw, 3)
    first: np.ndarray       # (Nw,)  leaf payload (slot start)
    count: np.ndarray       # (Nw,)  0 = internal
    kind: np.ndarray        # (Nw,)  leaf type code, 0 internal
    skip: np.ndarray        # (Nw,)  next preorder node after this subtree
    child_bmin: np.ndarray  # (Nw, K, 3)
    child_bmax: np.ndarray  # (Nw, K, 3)
    child_idx: np.ndarray   # (Nw, K) preorder index of child k
    src: np.ndarray         # (Nw,)  originating binary node index
    k: int


def _area(bmin, bmax):
    d = np.maximum(bmax - bmin, 0.0)
    return d[0] * d[1] + d[1] * d[2] + d[2] * d[0]


def collapse(bmin, bmax, first, count, skip, kind=None, k: int = 4) -> WideBVH:
    """Collapse a binary flattened BVH (preorder, left child = i+1, right
    child = skip[i+1]) into a K-wide one."""
    n = bmin.shape[0]
    if kind is None:
        kind = np.zeros(n, np.int32)
    is_leaf = count > 0

    def wide_children(b: int) -> list[int]:
        kids = [b + 1, skip[b + 1]]
        while len(kids) < k:
            # split the internal child with the largest surface area
            best, best_a = -1, -1.0
            for j, c in enumerate(kids):
                if not is_leaf[c]:
                    a = _area(bmin[c], bmax[c])
                    if a > best_a:
                        best, best_a = j, a
            if best < 0:
                break
            c = kids.pop(best)
            kids[best:best] = [c + 1, skip[c + 1]]
        return kids

    wide_slot_of = np.full(n, -1, np.int64)
    stack = [0]
    order: list[int] = []  # binary node id per wide slot, preorder
    children_of: dict[int, list[int]] = {}
    while stack:
        b = stack.pop()
        wide_slot_of[b] = len(order)
        order.append(b)
        if not is_leaf[b]:
            kids = wide_children(b)
            children_of[b] = kids
            for c in reversed(kids):
                stack.append(c)

    nw = len(order)
    w_bmin = bmin[order].astype(np.float32)
    w_bmax = bmax[order].astype(np.float32)
    w_first = first[order].astype(np.int32)
    w_count = count[order].astype(np.int32)
    w_kind = kind[order].astype(np.int32)
    w_src = np.asarray(order, np.int32)
    w_cb_min = np.full((nw, k, 3), np.float32(np.inf))
    w_cb_max = np.full((nw, k, 3), np.float32(-np.inf))
    w_cidx = np.zeros((nw, k), np.int32)

    sizes = np.ones(nw, np.int64)
    for slot in range(nw - 1, -1, -1):
        kids = children_of.get(order[slot])
        if kids:
            for j, c in enumerate(kids):
                cs = wide_slot_of[c]
                sizes[slot] += sizes[cs]
                w_cb_min[slot, j] = bmin[c]
                w_cb_max[slot, j] = bmax[c]
                w_cidx[slot, j] = cs
    w_skip = (np.arange(nw, dtype=np.int64) + sizes).astype(np.int32)

    return WideBVH(w_bmin, w_bmax, w_first, w_count, w_kind, w_skip,
                   w_cb_min, w_cb_max, w_cidx, w_src, k)


def row_width(k: int) -> int:
    """Packed row float32 slots: 6 own box + 3 meta + 6K child boxes +
    K child indices, padded up to a multiple of 8."""
    w = 9 + 7 * k
    return -(-w // 8) * 8


def pack_rows(w: WideBVH, node_offset: int = 0) -> np.ndarray:
    """Pack a WideBVH into (Nw, row_width) float32 rows; node_offset is
    added to skip and child indices.

    Row layout (float32 slots; ints bit-cast):
      [0:3]  own bmin        [3:6] own bmax
      [6]    first (bits)    [7]   kind<<8 | min(count,255) (bits)
      [8]    skip  (bits)
      [9 : 9+6K]    child boxes, (bmin3, bmax3) per child
      [9+6K: 9+7K]  child preorder indices (bits)
    """
    k = w.k
    nw = w.bmin.shape[0]
    rows = np.zeros((nw, row_width(k)), np.float32)
    rows[:, 0:3] = w.bmin
    rows[:, 3:6] = w.bmax
    rows[:, 6] = w.first.astype(np.int32).view(np.float32)
    meta = ((w.kind.astype(np.int64) << 8)
            | np.minimum(w.count, 255).astype(np.int64)).astype(np.int32)
    rows[:, 7] = meta.view(np.float32)
    rows[:, 8] = (w.skip + node_offset).astype(np.int32).view(np.float32)
    cb = np.concatenate([w.child_bmin, w.child_bmax], axis=2)  # (Nw, K, 6)
    rows[:, 9:9 + 6 * k] = cb.reshape(nw, 6 * k)
    present = np.isfinite(w.child_bmin[:, :, 0])
    cidx = np.where(present, w.child_idx + node_offset, 0).astype(np.int32)
    rows[:, 9 + 6 * k:9 + 7 * k] = cidx.view(np.float32)
    return rows
