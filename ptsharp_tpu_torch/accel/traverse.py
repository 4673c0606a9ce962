"""The XLA walks of the JAX package over its row tables, in plain PyTorch.

Counterpart of ptsharp_tpu/accel/traverse.py. Every ray walks the
flattened BVH along skip links with one cursor: advance to the next node
where the node's box is hit, else to its skip link (the first node after
its subtree); leaves run Moller-Trumbore over their fixed-width block.

  `traverse_packed`  the binary walk over u_rows (N, 10) and leaf_rows
                     (NL, leaf_size * 9): a hit internal node goes to j + 1,
                     its left child in preorder. The plain version of
                     kernels.traverse.closest_hit_binary.
  `traverse_wide`    the K-wide walk over w_rows (Nw, row_width(K)): a hit
                     internal node goes to its hit child of smallest
                     preorder index. The plain version of
                     kernels.traverse.closest_hit_wide_rows.
  `traverse`         the binary walk over MeshArrays (separate node and
                     triangle arrays).

The JAX functions step every ray of the batch in lockstep under masks,
gathering a (R, leaf, 9) block each step. These walks take only the
active lanes each step and run Moller-Trumbore only on lanes at a hit
leaf (kernels/traverse.py, `_Walk`); each ray's walk, and so its result,
is the same. The arithmetic is kernels/traverse.py's (`_safe_inv`, `_slab`,
`_mt`), in the order of operations of csrc/bvh_common.cuh, so the CUDA
kernels equal these walks bit for bit. The lockstep loop's `max_iters`
caps each ray's steps, since every active ray takes one step an iteration.

The `*_chunked` wrappers keep the JAX signatures: `lax.map` over chunks
bounds the lockstep waste of a TPU loop, and no ray's result depends on
its chunk, so these walk unchunked.

Returns (t, slot, u, v): t = INF and slot = -1 on a miss; slot indexes the
scene's slot-ordered triangles.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ptsharp_tpu_torch.kernels.traverse import (
    INF,
    MAX_ITERS,
    _box_hit,
    _first_min,
    _mt,
    _safe_inv,
    _SkipWalk,
    _slab,
    _Table,
    _walk_closest,
)


class MeshArrays(NamedTuple):
    """Flattened binary BVH and BVH-sorted triangles of one or more meshes;
    a walk covers the node slice [node_base, node_end) and triangle
    indices are global."""

    node_bmin: torch.Tensor   # (N, 3)
    node_bmax: torch.Tensor   # (N, 3)
    node_first: torch.Tensor  # (N,) leaf -> first sorted triangle
    node_count: torch.Tensor  # (N,) 0 = internal
    node_skip: torch.Tensor   # (N,)
    v0: torch.Tensor          # (T + pad, 3)
    e1: torch.Tensor          # (T + pad, 3) v1 - v0
    e2: torch.Tensor          # (T + pad, 3) v2 - v0
    max_leaf: int


def _rays_t(t_max, org):
    """t_max as a fresh (R,) float32 tensor (a scalar is broadcast)."""
    t = torch.as_tensor(t_max, dtype=torch.float32, device=org.device)
    return torch.broadcast_to(t, (org.shape[0],)).clone()


def traverse(mesh: MeshArrays, org, dirn, t_max, node_base, node_end,
             max_iters: int = 8192):
    """Closest hit against nodes [node_base, node_end) of `mesh`. org/dirn
    (R, 3) may be unnormalised (object space): t is parametric in the
    given direction. tri indexes the sorted triangle arrays."""
    r = org.shape[0]
    dev = org.device
    inv = _safe_inv(dirn)
    bt = _rays_t(t_max, org)
    bs = torch.full((r,), -1, dtype=torch.int32, device=dev)
    bu = torch.zeros(r, dtype=torch.float32, device=dev)
    bv = torch.zeros(r, dtype=torch.float32, device=dev)
    cur = torch.full((r,), int(node_base), dtype=torch.int64, device=dev)
    end = int(node_end)
    n_tri = mesh.v0.shape[0]
    lanes = torch.arange(mesh.max_leaf, device=dev)
    for _ in range(max_iters):
        act = torch.nonzero(cur < end).squeeze(1)
        if act.numel() == 0:
            break
        j = cur[act]
        box = torch.cat([mesh.node_bmin[j], mesh.node_bmax[j]], dim=1)
        tmin, tmax = _slab(box, org[act], inv[act])
        hit = _box_hit(tmin, tmax, bt[act])
        count = mesh.node_count[j]
        is_leaf = count > 0
        nxt = torch.where(hit & ~is_leaf, j + 1, mesh.node_skip[j].long())
        leaf = hit & is_leaf
        if bool(leaf.any()):
            la = act[leaf]
            start = mesh.node_first[j[leaf]].long()
            idx = torch.clamp(start[:, None] + lanes, 0, n_tri - 1)
            tri = torch.cat([mesh.v0[idx], mesh.e1[idx], mesh.e2[idx]], -1)
            ok, tt, uu, vv = _mt(tri, org[la], dirn[la])
            ok = ok & (lanes[None, :] < count[leaf][:, None])
            lane, tbest = _first_min(ok, tt)
            got = tbest < bt[la]
            g = la[got]
            bt[g] = tbest[got]
            bs[g] = (start + lane.squeeze(1))[got].to(torch.int32)
            bu[g] = torch.gather(uu, 1, lane).squeeze(1)[got]
            bv[g] = torch.gather(vv, 1, lane).squeeze(1)[got]
        cur[act] = nxt
    t = torch.where(bs >= 0, bt, torch.full_like(bt, INF))
    return t, bs, bu, bv


def unpack_bits(rows):
    """(first, skip, kind, count) of packed binary node rows (the scene
    packer's layout: [6] first, [7] kind << 8 | count, [8] skip, as int
    bits)."""
    bits = rows[..., 6:9].contiguous().view(torch.int32)
    first, meta, skip = bits[..., 0], bits[..., 1], bits[..., 2]
    return first, skip, (meta >> 8) & 0xF, meta & 0xFF


def unpack_wide_bits(rows, k: int):
    """(first, kind, count, skip, child_idx (..., K)) of K-wide rows
    (accel/wide.py pack_rows)."""
    first, skip, kind, count = unpack_bits(rows)
    cidx = rows[..., 9 + 6 * k:9 + 7 * k].contiguous().view(torch.int32)
    return first, kind, count, skip, cidx


def leaf_intersect(leaf_rows, blk_id, o, d, best_t, leaf_size: int, active):
    """Moller-Trumbore of each ray against ONE leaf block, leaf_rows
    [blk_id] (clipped to the table), where `active`: (t, slot lane, u, v)
    of the first slot of least t below best_t (t = INF where none)."""
    blk = leaf_rows[torch.clamp(blk_id.long(), 0, leaf_rows.shape[0] - 1)]
    ok, tt, uu, vv = _mt(blk[:, :leaf_size * 9].reshape(-1, leaf_size, 9),
                         o, d)
    ok = ok & active[:, None] & (tt < best_t[:, None])
    lane, t_lane = _first_min(ok, tt, INF)
    return (t_lane, lane.squeeze(1).to(torch.int32),
            torch.gather(uu, 1, lane).squeeze(1),
            torch.gather(vv, 1, lane).squeeze(1))


def wide_child_step(nrow, k, org, inv_d, bt, cidx, skip):
    """Slab-test the K child boxes of K-wide rows: (the hit child of
    smallest preorder index, else `skip`; whether a child was hit).
    Absent children carry index 0 and are never taken."""
    cb = nrow[:, 9:9 + 6 * k].reshape(-1, k, 6)
    ctmin, ctmax = _slab(cb, org[:, None, :], inv_d[:, None, :])
    chit = _box_hit(ctmin, ctmax, bt[:, None]) & (cidx > 0)
    big = torch.iinfo(torch.int32).max
    target = torch.where(chit, cidx, big).amin(dim=1)
    has_child = target < big
    return torch.where(has_child, target, skip), has_child


class _BinaryWalk(_SkipWalk):
    """The binary skip-link walk: a hit internal node's next node is the
    next row, j + 1 (its left child in preorder)."""

    def descend(self, lanes, node):
        return node + 1


def traverse_packed(rows, leaf_rows, org, dirn, t_max, base, end,
                    leaf_size: int, max_iters: int = MAX_ITERS,
                    return_iters: bool = False):
    """Closest hit by the binary skip-link walk over packed node rows
    (N, 10) and leaf_rows (NL, leaf_size * 9), nodes [base, end); with
    return_iters, also each ray's step count (int32 (R,)), the steps
    kernels.traverse.closest_hit_binary takes."""
    base, end = int(base), int(end)
    walk = _BinaryWalk(_Table(rows, leaf_rows, leaf_size), org, dirn,
                       _rays_t(t_max, org), base, end, 0,
                       torch.ones(org.shape[0], dtype=torch.bool,
                                  device=org.device), max_iters,
                       count=return_iters)
    out = _walk_closest(walk, leaf_size)
    return (*out, walk.steps) if return_iters else out


def traverse_wide(rows, leaf_rows, org, dirn, t_max, base, end,
                  leaf_size: int, k: int, max_iters: int = MAX_ITERS,
                  return_iters: bool = False):
    """Closest hit by the K-wide preorder walk over w_rows (Nw,
    row_width(K)) and leaf_rows (NL, leaf_size * 9), nodes [base, end);
    with return_iters, also each ray's step count (int32 (R,)), the steps
    kernels.traverse.closest_hit_wide_rows takes."""
    base, end = int(base), int(end)
    walk = _SkipWalk(_Table(rows, leaf_rows, leaf_size), org, dirn,
                     _rays_t(t_max, org), base, end, k,
                     torch.ones(org.shape[0], dtype=torch.bool,
                                device=org.device), max_iters,
                     count=return_iters)
    out = _walk_closest(walk, leaf_size)
    return (*out, walk.steps) if return_iters else out


def traverse_wide_chunked(rows, leaf_rows, org, dirn, t_max, base, end,
                          leaf_size: int, k: int, chunk: int = 1 << 12):
    """traverse_wide; `chunk` is the JAX package's lax.map width."""
    del chunk
    return traverse_wide(rows, leaf_rows, org, dirn, t_max, base, end,
                         leaf_size, k)


def traverse_packed_chunked(rows, leaf_rows, org, dirn, t_max, base, end,
                            leaf_size: int, chunk: int = 1 << 14):
    """traverse_packed; `chunk` is the JAX package's lax.map width."""
    del chunk
    return traverse_packed(rows, leaf_rows, org, dirn, t_max, base, end,
                           leaf_size)
