"""Host-side packing of the traversal table the two CUDA kernels read.

Numpy copies of the JAX package's packers, gathered in one module:
`pack_flat_tables` and `_pack_rows_128` (pallas/wide_kernel.py),
`pack_fat` (pallas/hbm_kernel.py) and `max_stack_bound`
(pallas/ordered_kernel.py). The port's scenes keep one table form, the
fat interleave: row pair (2i, 2i+1) = [node i's wide row; node i's leaf
block], 128 float32 columns each, int fields bit-cast, child indices at
columns 9+6K. Closest-hit and any-hit both walk it. `split_fat` gives
back the node and leaf tables it interleaves, which the split-table
kernels walk; `pad_rows` pads them to the block-cache kernel's 64-row
blocks.
"""

from __future__ import annotations

import numpy as np

from ptsharp_tpu_torch.accel import bvh as bvh_mod
from ptsharp_tpu_torch.accel import wide as wide_mod

ROW = 128  # float32 columns per table row


def _pack_rows_128(w: wide_mod.WideBVH, node_offset: int) -> np.ndarray:
    """accel/wide.pack_rows layout, zero-padded to 128 columns."""
    base = wide_mod.pack_rows(w, node_offset)
    rows = np.zeros((base.shape[0], ROW), np.float32)
    rows[:, :base.shape[1]] = base
    return rows


def pack_flat_tables(tri_v0, tri_e1, tri_e2, instances,
                     leaf_size: int, k: int):
    """Flatten all mesh instances into ONE world-space wide BVH + leaf
    table, so one kernel launch serves every instance.

    tri_v0/e1/e2: (S, 3) scene-slot-ordered arrays (padding slots are
    degenerate zeros). instances: list of (slot_lo, slot_hi, world34,
    inst_id); each instance's mesh occupies scene slots [lo, hi).

    Returns (rows, leaf, slot_tri, slot_inst, builder):
      rows (Nw, 128) f32 node rows, leaf (NL, 128) f32 leaf blocks;
      slot_tri (NL*leaf_size,) i32 kernel slot -> scene slot (-1 pad);
      slot_inst (NL*leaf_size,) i32 kernel slot -> instance id (-1 pad);
      builder: which BVH builder made the tree.
    """
    if leaf_size * 9 > ROW or 9 + 7 * k > ROW:
        raise ValueError("leaf_size <= 14 and wide_k <= 17 fit a 128 row")
    wv0_l, we1_l, we2_l, src_l, inst_l = [], [], [], [], []
    for lo, hi, world, iid in instances:
        v0 = np.asarray(tri_v0[lo:hi], np.float32)
        e1 = np.asarray(tri_e1[lo:hi], np.float32)
        e2 = np.asarray(tri_e2[lo:hi], np.float32)
        # drop padding slots (degenerate zero triangles)
        real = (np.abs(e1).sum(1) + np.abs(e2).sum(1)) > 0
        idx = np.nonzero(real)[0]
        lin = np.asarray(world, np.float32)[:, :3]
        off = np.asarray(world, np.float32)[:, 3]
        wv0_l.append(v0[idx] @ lin.T + off)
        we1_l.append(e1[idx] @ lin.T)
        we2_l.append(e2[idx] @ lin.T)
        src_l.append(idx.astype(np.int64) + lo)
        inst_l.append(np.full(idx.shape[0], iid, np.int32))
    if not wv0_l:
        return (np.zeros((0, ROW), np.float32), np.zeros((0, ROW), np.float32),
                np.zeros(0, np.int32), np.zeros(0, np.int32), "none")
    wv0 = np.concatenate(wv0_l)
    we1 = np.concatenate(we1_l)
    we2 = np.concatenate(we2_l)
    src = np.concatenate(src_l)
    iid = np.concatenate(inst_l)

    bmin_t = np.minimum(wv0, np.minimum(wv0 + we1, wv0 + we2))
    bmax_t = np.maximum(wv0, np.maximum(wv0 + we1, wv0 + we2))
    tree = bvh_mod.build(bmin_t, bmax_t, leaf_size=leaf_size)
    order = tree.order

    # every leaf owns exactly leaf_size slots; slot j of leaf l holds
    # sorted-triangle first[l] + j when j < count[l]
    leaf_ids = np.where(tree.count > 0)[0]
    nl = leaf_ids.shape[0]
    firsts = tree.first[leaf_ids].astype(np.int64)
    counts = tree.count[leaf_ids].astype(np.int64)
    lanes = np.arange(leaf_size, dtype=np.int64)
    sidx = firsts[:, None] + lanes[None, :]          # (nl, leaf)
    valid = lanes[None, :] < counts[:, None]
    tri = order[np.where(valid, sidx, 0)]            # (nl, leaf) global tri
    vm = valid[..., None]
    tri9 = np.stack([
        np.where(vm, wv0[tri], 0.0),
        np.where(vm, we1[tri], 0.0),
        np.where(vm, we2[tri], 0.0),
    ], axis=2)                                        # (nl, leaf, 3, 3)
    leaf_rows = np.zeros((nl, ROW), np.float32)
    leaf_rows[:, :leaf_size * 9] = tri9.reshape(nl, leaf_size * 9)
    slot_tri = np.where(valid, src[tri], -1).astype(np.int32).reshape(-1)
    slot_inst = np.where(valid, iid[tri], -1).astype(np.int32).reshape(-1)
    new_first = tree.first.copy()
    new_first[leaf_ids] = (np.arange(nl, dtype=np.int64)
                           * leaf_size).astype(new_first.dtype)
    w = wide_mod.collapse(tree.bmin, tree.bmax, new_first,
                          np.minimum(tree.count, leaf_size), tree.skip, k=k)
    rows = _pack_rows_128(w, 0)
    return rows, leaf_rows, slot_tri, slot_inst, tree.builder


def pack_fat(rows, leaf, leaf_size: int) -> np.ndarray:
    """Interleave node rows with their leaf blocks: fat row 2i = node i's
    wide row, 2i+1 = its leaf block (zeros for internal nodes).

    rows (Nw, 128), leaf (NL, 128) -> (2*Nw, 128) float32."""
    rows = np.asarray(rows)
    leaf = np.asarray(leaf)
    nw = rows.shape[0]
    fat = np.zeros((2 * nw, ROW), np.float32)
    fat[0::2] = rows
    meta = rows[:, 7].view(np.int32)
    cnt = meta & 0xFF
    first = rows[:, 6].view(np.int32)
    lj = np.where(cnt > 0, first // leaf_size, 0)
    lj = np.clip(lj, 0, max(leaf.shape[0] - 1, 0))
    if leaf.shape[0]:
        fat[1::2] = np.where((cnt > 0)[:, None], leaf[lj], 0.0)
    return fat


def split_fat(fat, leaf_size: int):
    """The inverse of pack_fat: (rows, leaf) with rows = fat[0::2] and
    leaf row first // leaf_size = fat[2j+1] for each leaf node j, where
    the split-table walks look a leaf block up.

    fat (2*Nw, 128) -> rows (Nw, 128), leaf (NL, 128) float32, NL one
    more than the largest leaf row."""
    fat = np.asarray(fat, np.float32)
    rows = np.ascontiguousarray(fat[0::2])
    bits = rows.view(np.int32)
    leaf_nodes = np.nonzero((bits[:, 7] & 0xFF) > 0)[0]
    lj = bits[leaf_nodes, 6] // leaf_size
    leaf = np.zeros((int(lj.max()) + 1 if lj.size else 0, ROW), np.float32)
    leaf[lj] = fat[2 * leaf_nodes + 1]
    return rows, leaf


def pad_rows(x, multiple: int) -> np.ndarray:
    """A (N, 128) table with zero rows appended up to a multiple of
    `multiple` rows; `x` itself when N already is one. The block-cache
    kernel over the split tables reads whole 64-row blocks of both; pad
    once per scene, not per launch."""
    x = np.asarray(x, np.float32)
    extra = (-x.shape[0]) % multiple
    if not extra:
        return x
    return np.concatenate([x, np.zeros((extra, x.shape[1]), np.float32)])


def check_child_boxes(rows, k: int) -> None:
    """Raise ValueError unless every child box in the node rows of an
    internal node equals that child's own box bit for bit. The ordered
    kernels (csrc/closest_hit.cu, any_hit.cu) test a node's box only
    once, as a child box of its parent row, and carry the entry distance
    on the stack; that is the walk that re-tests each node's own box only
    where the two boxes agree. The K-wide collapse copies both from one
    float32 value (accel/wide.py), so a table this package builds passes.
    `rows` are node rows, the even rows of a fat table."""
    bits = np.ascontiguousarray(rows, np.float32).view(np.int32)
    internal = (bits[:, 7] & 0xFF) == 0
    cidx = bits[:, 9 + 6 * k:9 + 7 * k]
    parent, slot = np.nonzero((cidx > 0) & internal[:, None])
    child = cidx[parent, slot]
    if child.size and child.max() >= bits.shape[0]:
        raise ValueError("a child index lies past the node rows")
    cols = 9 + 6 * slot[:, None] + np.arange(6)
    bad = np.nonzero(np.any(bits[parent[:, None], cols] != bits[child, 0:6],
                            axis=1))[0]
    if bad.size:
        i = bad[0]
        raise ValueError(
            f"child box {slot[i]} of node {parent[i]} differs from the own "
            f"box of node {child[i]} on {bad.size} child slots: the ordered "
            f"walk needs them equal bit for bit")


def max_stack_bound(rows: np.ndarray, k: int, base: int = 0,
                    end: int | None = None) -> int:
    """Worst-case stack entries of an ordered walk over wide node rows
    [base, end): (K-1) pushes per level x tree depth, + 1, computed by a
    host DFS over the packed child indices. `rows` are node rows (the
    even rows of a fat table)."""
    rows = np.asarray(rows)
    if end is None:
        end = rows.shape[0]
    if end <= base:
        return 0
    bits = rows.view(np.int32)
    cnt = bits[:, 7] & 0xFF
    best = 0
    stack = [(base, 0)]
    cidx_cols = [9 + 6 * k + c for c in range(k)]
    while stack:
        n, d = stack.pop()
        best = max(best, d)
        if cnt[n] > 0:
            continue
        for col in cidx_cols:
            c = bits[n, col]
            if c > 0:
                stack.append((int(c), d + 1))
    return (k - 1) * best + 1
