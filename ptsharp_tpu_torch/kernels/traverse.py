"""Closest-hit and any-hit over the BVH tables: the wrappers of the CUDA
kernels in csrc/ (sixteen entry points).

Over the fat table (the render path):
  `closest_hit` and `any_hit` walk near to far with a per-ray stack (the
  ordered walk, csrc/closest_hit.cu and csrc/any_hit.cu, in persistent
  warps that refill their idle lanes from a ray counter);
  `closest_hit_preorder` and `any_hit_preorder` walk the tree in preorder
  along its skip links, with no stack (csrc/closest_hit_preorder.cu and
  csrc/any_hit_preorder.cu, persistent warps too). intersect.py calls
  these four.
Over the split tables `rows` + `leaf` (the kernel-level entry points,
`accel.tables.split_fat` makes them from the fat table):
  `closest_hit_split` and `any_hit_split`, the ordered walk of
  closest_hit and any_hit over the split tables, closest-hit in either
  push order and with an optional count of each ray's steps
  (csrc/closest_hit.cu, csrc/any_hit.cu, in persistent warps);
  `closest_hit_packet`, the persistent preorder walk of
  closest_hit_preorder over the split tables (csrc/closest_hit_preorder.cu;
  its TPU kernel walks a packet with one shared cursor, this one does not).
Memory schedules of the same two walks (kernel-level entry points too):
  `closest_hit_dual`, the ordered walk of closest_hit over the fat table
  with two rays a lane, in persistent warps that refill their idle slots
  (csrc/closest_hit_dual.cu);
  `closest_hit_fat_cache` (fat table), `closest_hit_block_cache` (split
  tables, both a multiple of 64 rows, `accel.tables.pad_rows`) and
  `closest_hit_row_stage` (split tables of any length), the preorder walk
  in warp packets of 32 rays with one cursor a packet, in persistent
  warps, reading rows from shared memory that TMA bulk copies fill: rings
  of two cache blocks, the next block copied while the warp tests the
  current one, one of fat row pairs or one of node rows and one of leaf
  blocks (csrc/closest_hit_fat_cache.cu, closest_hit_block_cache.cu), or
  one-row stages of node rows and leaf blocks, a row copied when the
  cursor needs another (csrc/closest_hit_row_stage.cu);
  `accel.traverse.warp_packet_plain` models the schedule and its counts.
Over the XLA walks' row tables (intersect.py, intersector "walk", "wide"
and "cluster"; node rows of any width, leaf blocks (NL, leaf_size * 9)):
  `closest_hit_binary`, the binary skip-link walk over u_rows (N, 10) in
  persistent warps (csrc/closest_hit_binary.cu; float2 loads of the node
  rows, float4 or scalar loads of the leaf blocks, `row_loads(leaf)`; its
  plain version is accel.traverse.traverse_packed);
  `closest_hit_wide_rows` and `any_hit_wide_rows`, the preorder walks of
  closest_hit_preorder and any_hit_preorder over the K-wide w_rows
  (csrc/closest_hit_preorder.cu, csrc/any_hit_preorder.cu; their plain
  versions are accel.traverse.traverse_wide and any_hit_wide_rows_plain),
  with float4 loads where both tables are 16-byte strides from 16-byte
  aligned bases (`row_loads(rows, leaf)`), else scalar loads.
Over the whole scene (intersect.py, a `use_tlas` scene):
  `closest_hit_tlas` and `any_hit_tlas`, one walk of the TLAS at the head
  of the XLA walks' node rows (w_rows, or u_rows for "walk") whose
  analytic leaves are tested in place and whose instance leaves re-enter
  the instance's BLAS with the ray in its object space
  (csrc/tlas_walk.cu, persistent warps; K at compile time, float4 rows
  (float2 for binary rows) and leaves, the instance `tlas_instance(tabs)`
  picks; accel.traverse.TlasTables names what they read).
On a CUDA tensor each wrapper checks its inputs and launches its
hand-written kernel on the current stream through kernels/build.py
`launch`, which adds one to the wrapper's `launches` count and the
launch's rays to its `rays`; on a CPU tensor it runs its plain version,
`accel.traverse.<name>_plain` unless named otherwise above; any other
device raises. There is no fallback from a kernel to a plain version.
Traversal is not differentiable (the JAX package detaches its inputs, and
no pallas_call has a VJP rule): every wrapper raises where a table or ray
input requires grad.

Contract (the JAX package's kernels):
  fat (2*Nw, 128) f32, or rows (Nw, 128) and leaf (NL, 128) f32;
  org, dirn (R, 3) f32; t_max / t_cut (R,) f32; [base, end) the node
  range; leaf_size triangles per leaf; K children.
  closest hit -> t (R,) f32 (INF where slot < 0), slot (R,) i32 kernel
                 slot, u, v (R,) f32 [, steps (R,) i32];
  any hit     -> (R,) bool, True where a triangle lies at t in
                 (1e-4, t_cut); False where t_cut <= 0.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import NamedTuple

import torch

from ptsharp_tpu_torch.accel import traverse as walks
from ptsharp_tpu_torch.kernels import build

ROW = 128
KERNEL_K = (4, 8)  # the kernels' template instances
# the push order of any_hit_split's kernel, whatever order_mode names (the
# occlusion is the same in both; "near" measured faster there)
SPLIT_ANY_HIT_ORDER = "near"
# the block-cache kernel's tables are multiples of this many rows, the JAX
# kernel's block (BLK)
CACHE_BLOCK_ROWS = 64


def _check_table(name, x, rows_even=False):
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != ROW \
            or (rows_even and x.shape[0] % 2) or not x.is_contiguous():
        shape = "(2*Nw, 128)" if rows_even else "(N, 128)"
        raise ValueError(f"{name} must be a contiguous {shape} float32 "
                         f"table")


def _check(nodes, org, dirn, t, base, end, leaf_size, k, leaf=None):
    """The wrappers' contract. `nodes` is the fat table, or with `leaf`
    the node rows of the split tables."""
    if leaf is None:
        _check_table("fat", nodes, rows_even=True)
        n_nodes = nodes.shape[0] // 2
    else:
        _check_table("rows", nodes)
        _check_table("leaf", leaf)
        if leaf.device != nodes.device:
            raise ValueError(f"leaf is on {leaf.device}, rows on "
                             f"{nodes.device}")
        n_nodes = nodes.shape[0]
    _check_rays(nodes, org, dirn, t, base, end, n_nodes, leaf)
    if not (1 <= leaf_size and leaf_size * 9 <= ROW) \
            or not (2 <= k and 9 + 7 * k <= ROW):
        raise ValueError(f"leaf_size={leaf_size}, k={k} do not fit a row")


def _check_detached(**tensors):
    """A launch reads raw pointers, so autograd cannot follow it: raise
    where an input requires grad instead of cutting the graph without a
    word (intersect.py detaches every traversal input)."""
    live = [name for name, x in tensors.items()
            if x is not None and x.requires_grad]
    if live:
        raise ValueError(f"{', '.join(live)} require grad: traversal is "
                         f"not differentiable, pass detached tensors")


def _check_rays(nodes, org, dirn, t, base, end, n_nodes, leaf=None):
    _check_detached(nodes=nodes, leaf=leaf, org=org, dirn=dirn, t=t)
    r = org.shape[0]
    for name, x, shape in (("org", org, (r, 3)), ("dirn", dirn, (r, 3)),
                           ("t", t, (r,))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 {shape}")
        if x.device != nodes.device:
            raise ValueError(f"{name} is on {x.device}, the tables on "
                             f"{nodes.device}")
    if not 0 <= base <= end <= n_nodes:
        raise ValueError(f"node range [{base}, {end}) outside the table")


def _check_row_tables(rows, leaf, org, dirn, t, base, end, leaf_size, k):
    """The contract of the XLA walks' row tables: node rows (N, W) with
    W >= 9 + 7k (k = 0: the binary rows), leaf blocks (NL, L) with
    L >= leaf_size * 9, float32 and contiguous, on one device."""
    if leaf_size < 1:
        raise ValueError(f"leaf_size={leaf_size}")
    for name, x, cols in (("rows", rows, 9 + 7 * k),
                          ("leaf", leaf, 9 * leaf_size)):
        if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] < cols \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 table "
                             f"of at least {cols} columns")
    if leaf.device != rows.device:
        raise ValueError(f"leaf is on {leaf.device}, rows on {rows.device}")
    _check_rays(rows, org, dirn, t, base, end, rows.shape[0], leaf)


def _check_card(x, k=None):
    """Raise unless a kernel runs over tables on `x.device` at K (None: a
    walk with no K)."""
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if k is not None and k not in KERNEL_K:
        raise ValueError(f"the CUDA kernels are built for K in {KERNEL_K}")


def _ptr(x):
    return x.data_ptr()


def _hit_outputs(r, device):
    t = torch.empty(r, dtype=torch.float32, device=device)
    return (t, torch.empty(r, dtype=torch.int32, device=device),
            torch.empty_like(t), torch.empty_like(t))


def _aligned(nbytes, *tables):
    """Raise unless every table starts on an nbytes boundary, as the
    kernels' wide loads and 16-byte copies need."""
    if any(x.data_ptr() % nbytes for x in tables):
        raise ValueError(f"the tables must start on a {nbytes}-byte "
                         f"boundary")


def _staged_tables(*tables):
    """The C entry's table arguments for a kernel that copies rows into
    shared memory (16 bytes at a time or more, from 16-byte boundaries):
    the pointers, then the tables' row counts, which bound its copies."""
    _aligned(16, *tables)
    return (*map(_ptr, tables), *(x.shape[0] for x in tables))


def _persistent(wrapper, entry, x, lead, org, dirn, t, base, end, tail,
                counts, out, n_counts=2):
    """Launch a persistent walk (csrc/closest_hit.cu, any_hit.cu,
    closest_hit_dual.cu, closest_hit_preorder.cu, any_hit_preorder.cu,
    closest_hit_binary.cu, and the warp packets of closest_hit_fat_cache.cu,
    closest_hit_block_cache.cu and closest_hit_row_stage.cu) over the rays,
    writing `out` (an output of None passes a null pointer): its warps
    take rays from the ray counter of the current stream (build.launch).
    `x` is a table (its device), `lead` the C entry's arguments before the
    rays (the tables and their geometry), `tail` those after the node
    range; `counts`, if given, an (n_counts,) int64 tensor the kernel adds
    to."""
    if counts is not None and (counts.dtype != torch.int64
                               or tuple(counts.shape) != (n_counts,)
                               or counts.device != x.device
                               or not counts.is_contiguous()):
        raise ValueError(f"counts must be a contiguous ({n_counts},) int64 "
                         f"tensor on the tables' device")
    r = org.shape[0]
    if r:
        build.launch(wrapper, entry, x.device, *lead, _ptr(org), _ptr(dirn),
                     _ptr(t), r, base, end, *tail,
                     *(None if o is None else _ptr(o) for o in out),
                     persistent=True, counts=counts, rays=r)
    return out


def _persistent_fat(wrapper, entry, fat, org, dirn, t, base, end, k, counts,
                    out):
    """A persistent walk over the fat table, which it reads with float4
    loads."""
    _check_card(fat, k)
    _aligned(16, fat)
    return _persistent(wrapper, entry, fat, (_ptr(fat),), org, dirn, t, base,
                       end, (k,), counts, out)


def row_loads(*tables) -> str:
    """How the kernels read the XLA walk's row tables: "float4" where
    every table given starts on a 16-byte boundary and is a stride of a
    multiple of 4 floats (w_rows at any K; leaf_rows at leaf 4, 8, 12,
    ...), else "scalar". The K-wide walks ask of w_rows and leaf_rows, the
    binary walk of leaf_rows alone (it reads u_rows with float2 loads)."""
    aligned = all(x.data_ptr() % 16 == 0 and x.shape[1] % 4 == 0
                  for x in tables)
    return "float4" if aligned else "scalar"


def _persistent_rows(wrapper, entry, rows, leaf, org, dirn, t, base, end,
                     leaf_size, k, counts, out):
    """A persistent preorder walk over w_rows and leaf_rows, each ray
    capped at MAX_ITERS steps, in the load width row_loads names."""
    _check_card(rows, k)
    lead = (_ptr(rows), _ptr(leaf), rows.shape[1], leaf.shape[1],
            int(row_loads(rows, leaf) == "float4"))
    return _persistent(wrapper, entry, rows, lead, org, dirn, t, base, end,
                       (leaf_size, k, walks.MAX_ITERS), counts, out)


def _plain_counts(counts):
    if counts is not None:
        raise ValueError("counts are kept by the CUDA kernels; the plain "
                         "versions give each ray's steps (return_iters)")


def closest_hit(fat, org, dirn, t_max, base: int, end: int, leaf_size: int,
                k: int, counts=None):
    """Closest hit per ray by the ordered walk: (t, slot, u, v).
    csrc/closest_hit.cu on CUDA tensors, closest_hit_plain on CPU
    tensors. `counts`, a (2,) int64 tensor on the card, if given: the
    kernel adds the steps its rays took and the lane slots its warps ran
    (32 a loop turn); their ratio is its lane use."""
    _check(fat, org, dirn, t_max, base, end, leaf_size, k)
    if fat.device.type == "cpu":
        _plain_counts(counts)
        return walks.closest_hit_plain(fat, org, dirn, t_max, base, end,
                                       leaf_size, k)
    return _persistent_fat(closest_hit, "pt_closest_hit", fat, org, dirn,
                           t_max, base, end, k, counts,
                           _hit_outputs(org.shape[0], fat.device))


def closest_hit_preorder(fat, org, dirn, t_max, base: int, end: int,
                         leaf_size: int, k: int, counts=None):
    """Closest hit per ray by the preorder walk: (t, slot, u, v).
    csrc/closest_hit_preorder.cu on CUDA tensors,
    closest_hit_preorder_plain on CPU tensors; `counts` as in
    closest_hit."""
    _check(fat, org, dirn, t_max, base, end, leaf_size, k)
    if fat.device.type == "cpu":
        _plain_counts(counts)
        return walks.closest_hit_preorder_plain(fat, org, dirn, t_max, base,
                                                end, leaf_size, k)
    return _persistent_fat(closest_hit_preorder, "pt_closest_hit_preorder",
                           fat, org, dirn, t_max, base, end, k, counts,
                           _hit_outputs(org.shape[0], fat.device))


def any_hit(fat, org, dirn, t_cut, base: int, end: int, leaf_size: int,
            k: int, counts=None):
    """Occlusion per ray by the ordered walk: (R,) bool.
    csrc/any_hit.cu on CUDA tensors, any_hit_plain on CPU tensors;
    `counts` as in closest_hit."""
    _check(fat, org, dirn, t_cut, base, end, leaf_size, k)
    if fat.device.type == "cpu":
        _plain_counts(counts)
        return walks.any_hit_plain(fat, org, dirn, t_cut, base, end,
                                   leaf_size, k)
    occ = torch.empty(org.shape[0], dtype=torch.bool, device=fat.device)
    return _persistent_fat(any_hit, "pt_any_hit", fat, org, dirn, t_cut,
                           base, end, k, counts, (occ,))[0]


def any_hit_preorder(fat, org, dirn, t_cut, base: int, end: int,
                     leaf_size: int, k: int, counts=None):
    """Occlusion per ray by the preorder walk: (R,) bool.
    csrc/any_hit_preorder.cu on CUDA tensors, any_hit_preorder_plain on
    CPU tensors; `counts` as in closest_hit."""
    _check(fat, org, dirn, t_cut, base, end, leaf_size, k)
    if fat.device.type == "cpu":
        _plain_counts(counts)
        return walks.any_hit_preorder_plain(fat, org, dirn, t_cut, base, end,
                                            leaf_size, k)
    occ = torch.empty(org.shape[0], dtype=torch.bool, device=fat.device)
    return _persistent_fat(any_hit_preorder, "pt_any_hit_preorder", fat, org,
                           dirn, t_cut, base, end, k, counts, (occ,))[0]


def closest_hit_split(rows, leaf, org, dirn, t_max, base: int, end: int,
                      leaf_size: int, k: int, order_mode: str = "full",
                      return_iters: bool = False, counts=None):
    """Closest hit per ray by the ordered walk over the split tables:
    (t, slot, u, v), and with return_iters each ray's step count (int32
    (R,); the JAX kernel's count is its packet's, broadcast over the
    tile). order_mode "full" pushes the hit children far to near, "near"
    in static reverse order; in "near" the result is closest_hit's on the
    fat table they split, steps included. The walk tests a node's box
    only as a child box of its parent row, so every child box must equal
    the child's own box bit for bit (accel.tables.check_child_boxes,
    which a scene build runs on the fat table that split_fat splits).
    The persistent ordered walk of csrc/closest_hit.cu over the split
    tables (both on 16-byte boundaries) on CUDA tensors,
    closest_hit_split_plain on CPU tensors. `counts` as in closest_hit."""
    _check(rows, org, dirn, t_max, base, end, leaf_size, k, leaf)
    walks.check_order(order_mode)
    if rows.device.type == "cpu":
        _plain_counts(counts)
        return walks.closest_hit_split_plain(rows, leaf, org, dirn, t_max,
                                             base, end, leaf_size, k,
                                             order_mode, return_iters)
    _check_card(rows, k)
    _aligned(16, rows, leaf)
    r = org.shape[0]
    steps = (torch.empty(r, dtype=torch.int32, device=rows.device)
             if return_iters else None)
    out = _persistent(closest_hit_split, "pt_closest_hit_split", rows,
                      (_ptr(rows), _ptr(leaf)), org, dirn, t_max, base, end,
                      (leaf_size, k, int(order_mode == "near")), counts,
                      (*_hit_outputs(r, rows.device), steps))
    return out if return_iters else out[:4]


def any_hit_split(rows, leaf, org, dirn, t_cut, base: int, end: int,
                  leaf_size: int, k: int, order_mode: str = "full",
                  counts=None):
    """Occlusion per ray by the ordered walk over the split tables: (R,)
    bool, any_hit's on the fat table they split. order_mode is checked
    and changes no result on this walk, which visits each node at most
    once: the kernel pushes SPLIT_ANY_HIT_ORDER whatever it names. Every
    child box must equal the child's own box bit for bit, as in
    closest_hit_split.
    The persistent ordered walk of csrc/any_hit.cu over the split tables
    (both on 16-byte boundaries) on CUDA tensors, any_hit_split_plain (in
    the order given) on CPU tensors. `counts` as in closest_hit."""
    _check(rows, org, dirn, t_cut, base, end, leaf_size, k, leaf)
    walks.check_order(order_mode)
    if rows.device.type == "cpu":
        _plain_counts(counts)
        return walks.any_hit_split_plain(rows, leaf, org, dirn, t_cut, base,
                                         end, leaf_size, k, order_mode)
    _check_card(rows, k)
    _aligned(16, rows, leaf)
    occ = torch.empty(org.shape[0], dtype=torch.bool, device=rows.device)
    return _persistent(any_hit_split, "pt_any_hit_split", rows,
                       (_ptr(rows), _ptr(leaf)), org, dirn, t_cut, base, end,
                       (leaf_size, k), counts, (occ,))[0]


def closest_hit_packet(rows, leaf, org, dirn, t_max, base: int, end: int,
                       leaf_size: int, k: int, counts=None):
    """Closest hit per ray by the preorder walk over the split tables:
    (t, slot, u, v), equal to closest_hit_preorder's on the fat table they
    split. The JAX kernel (pallas_traverse_wide) walks a packet of `tile`
    rays with one shared cursor, and every lane gets its own walk's
    result; no packet is walked here (the persistent preorder walk of
    csrc/closest_hit_preorder.cu over the split tables, float4 loads, both
    tables on 16-byte boundaries) on CUDA tensors; closest_hit_packet_plain
    on CPU tensors. `counts` as in closest_hit."""
    _check(rows, org, dirn, t_max, base, end, leaf_size, k, leaf)
    if rows.device.type == "cpu":
        _plain_counts(counts)
        return walks.closest_hit_packet_plain(rows, leaf, org, dirn, t_max,
                                              base, end, leaf_size, k)
    _check_card(rows, k)
    _aligned(16, rows, leaf)
    return _persistent(closest_hit_packet, "pt_closest_hit_packet", rows,
                       (_ptr(rows), _ptr(leaf)), org, dirn, t_max, base, end,
                       (leaf_size, k), counts,
                       _hit_outputs(org.shape[0], rows.device))


def closest_hit_dual(fat, org, dirn, t_max, base: int, end: int,
                     leaf_size: int, k: int, counts=None):
    """Closest hit per ray by the ordered walk, two rays a lane in
    persistent warps: (t, slot, u, v), equal to closest_hit's on every
    lane. The JAX kernel's `mt_gate` and `max_iters` change no result and
    are not taken. csrc/closest_hit_dual.cu on CUDA tensors,
    closest_hit_dual_plain on CPU tensors. `counts` as in closest_hit:
    the steps its rays took (closest_hit's) and the slots its warps ran
    (64 a loop turn)."""
    _check(fat, org, dirn, t_max, base, end, leaf_size, k)
    if fat.device.type == "cpu":
        _plain_counts(counts)
        return walks.closest_hit_dual_plain(fat, org, dirn, t_max, base, end,
                                            leaf_size, k)
    return _persistent_fat(closest_hit_dual, "pt_closest_hit_dual", fat, org,
                           dirn, t_max, base, end, k, counts,
                           _hit_outputs(org.shape[0], fat.device))


def closest_hit_fat_cache(fat, org, dirn, t_max, base: int, end: int,
                          leaf_size: int, k: int, counts=None):
    """Closest hit per ray by the preorder walk in warp packets of 32 rays
    (one cursor a packet, persistent warps) through a ring of two blocks
    of fat row pairs in shared memory, filled by TMA bulk copies:
    (t, slot, u, v), equal to closest_hit_preorder's on every lane. The
    table is not padded: the kernel copies the last block up to the
    table's end. csrc/closest_hit_fat_cache.cu on CUDA tensors,
    closest_hit_fat_cache_plain on CPU tensors. `counts`, a (5,) int64
    tensor on the card, if given: the kernel adds its PACKET_COUNTS, which
    warp_packet_plain gives per packet."""
    _check(fat, org, dirn, t_max, base, end, leaf_size, k)
    if fat.device.type == "cpu":
        _plain_counts(counts)
        return walks.closest_hit_fat_cache_plain(fat, org, dirn, t_max, base,
                                                 end, leaf_size, k)
    _check_card(fat, k)
    return _persistent(closest_hit_fat_cache, "pt_closest_hit_fat_cache",
                       fat, _staged_tables(fat), org, dirn, t_max, base, end,
                       (leaf_size, k), counts,
                       _hit_outputs(org.shape[0], fat.device),
                       len(walks.PACKET_COUNTS))


def closest_hit_block_cache(rows, leaf, org, dirn, t_max, base: int,
                            end: int, leaf_size: int, k: int, counts=None):
    """Closest hit per ray by the preorder walk in warp packets of 32 rays
    (one cursor a packet, persistent warps) through two rings of two
    blocks in shared memory, node rows and leaf blocks, filled by TMA bulk
    copies: (t, slot, u, v), equal to closest_hit_preorder's on every
    lane. Both tables must be multiples of 64 rows (accel.tables.pad_rows),
    as the JAX kernel asserts. Its `leaf_mode` changes no result and is
    not taken. csrc/closest_hit_block_cache.cu on CUDA tensors,
    closest_hit_block_cache_plain on CPU tensors; `counts` as in
    closest_hit_fat_cache, both rings' copies summed."""
    for name, x in (("rows", rows), ("leaf", leaf)):
        if x.dim() != 2 or x.shape[0] % CACHE_BLOCK_ROWS:
            raise ValueError(f"{name} must hold a multiple of "
                             f"{CACHE_BLOCK_ROWS} rows (tables.pad_rows)")
    _check(rows, org, dirn, t_max, base, end, leaf_size, k, leaf)
    if rows.device.type == "cpu":
        _plain_counts(counts)
        return walks.closest_hit_block_cache_plain(rows, leaf, org, dirn,
                                                   t_max, base, end,
                                                   leaf_size, k)
    _check_card(rows, k)
    return _persistent(closest_hit_block_cache, "pt_closest_hit_block_cache",
                       rows, _staged_tables(rows, leaf), org, dirn, t_max,
                       base, end, (leaf_size, k), counts,
                       _hit_outputs(org.shape[0], rows.device),
                       len(walks.PACKET_COUNTS))


def cache_layout(wrapper):
    """(table rows a ring buffer holds, dynamic shared memory a launch asks
    for in bytes, whether the rings prefetch) of a warp-packet kernel,
    closest_hit_fat_cache, closest_hit_block_cache or
    closest_hit_row_stage, from the built library: the block_rows and
    prefetch that warp_packet_plain takes to model it. Needs the card's
    toolchain."""
    lib = build.load()
    name = f"pt_{wrapper.__name__}"
    return (getattr(lib, f"{name}_block_rows")(),
            getattr(lib, f"{name}_smem")(),
            bool(getattr(lib, f"{name}_prefetch")()))


def closest_hit_row_stage(rows, leaf, org, dirn, t_max, base: int, end: int,
                          leaf_size: int, k: int, counts=None):
    """Closest hit per ray by the preorder walk in warp packets of 32 rays
    (one cursor a packet, persistent warps) through one-row stages in
    shared memory, node rows and leaf blocks, filled by TMA bulk copies:
    (t, slot, u, v), equal to closest_hit_preorder's on every lane, on
    split tables of any length. csrc/closest_hit_row_stage.cu on CUDA
    tensors, closest_hit_row_stage_plain on CPU tensors; `counts` as in
    closest_hit_fat_cache, both stages' copies summed."""
    _check(rows, org, dirn, t_max, base, end, leaf_size, k, leaf)
    if rows.device.type == "cpu":
        _plain_counts(counts)
        return walks.closest_hit_row_stage_plain(rows, leaf, org, dirn, t_max,
                                                 base, end, leaf_size, k)
    _check_card(rows, k)
    return _persistent(closest_hit_row_stage, "pt_closest_hit_row_stage",
                       rows, _staged_tables(rows, leaf), org, dirn, t_max,
                       base, end, (leaf_size, k), counts,
                       _hit_outputs(org.shape[0], rows.device),
                       len(walks.PACKET_COUNTS))


def closest_hit_binary(rows, leaf, org, dirn, t_max, base: int, end: int,
                       leaf_size: int, counts=None):
    """Closest hit per ray by the binary skip-link walk over u_rows
    (N, 10) and leaf_rows (NL, leaf_size * 9): (t, slot, u, v), slot
    indexing the scene's slot-ordered triangles, each ray capped at
    MAX_ITERS steps. The JAX kernel (pallas_traverse) walks a 1,024-ray
    tile with one cursor; every lane gets this per-ray walk's result, so
    the tile changes nothing. csrc/closest_hit_binary.cu on CUDA tensors
    (u_rows an 8-byte stride from an 8-byte aligned base, read with float2
    loads; leaf_rows with the loads row_loads(leaf) names); on CPU tensors
    its plain version, accel.traverse.traverse_packed. `counts` as in
    closest_hit."""
    base, end = int(base), int(end)
    _check_row_tables(rows, leaf, org, dirn, t_max, base, end, leaf_size, 0)
    if rows.device.type == "cpu":
        _plain_counts(counts)
        return walks.traverse_packed(rows, leaf, org, dirn, t_max, base, end,
                                     leaf_size)
    _check_card(rows)
    if rows.shape[1] % 2:
        raise ValueError("rows must be a stride of an even number of floats "
                         "(float2 loads)")
    _aligned(8, rows)
    lead = (_ptr(rows), _ptr(leaf), rows.shape[1], leaf.shape[1],
            int(row_loads(leaf) == "float4"))
    return _persistent(closest_hit_binary, "pt_closest_hit_binary", rows,
                       lead, org, dirn, t_max, base, end,
                       (leaf_size, walks.MAX_ITERS), counts,
                       _hit_outputs(org.shape[0], rows.device))


def _check_wide_rows(rows, leaf, org, dirn, t, base, end, leaf_size, k):
    if k < 2:
        raise ValueError(f"k={k}")
    _check_row_tables(rows, leaf, org, dirn, t, base, end, leaf_size, k)


def closest_hit_wide_rows(rows, leaf, org, dirn, t_max, base: int, end: int,
                          leaf_size: int, k: int, counts=None):
    """Closest hit per ray by the K-wide preorder walk over w_rows
    (Nw, row_width(K)) and leaf_rows (NL, leaf_size * 9): (t, slot, u, v).
    The walk of closest_hit_preorder over another table view, each ray
    capped at MAX_ITERS steps. csrc/closest_hit_preorder.cu (K in
    KERNEL_K; float4 or scalar loads, row_loads) on CUDA tensors; on CPU
    tensors its plain version, accel.traverse.traverse_wide (any K).
    `counts` as in closest_hit."""
    base, end = int(base), int(end)
    _check_wide_rows(rows, leaf, org, dirn, t_max, base, end, leaf_size, k)
    if rows.device.type == "cpu":
        _plain_counts(counts)
        return walks.traverse_wide(rows, leaf, org, dirn, t_max, base, end,
                                   leaf_size, k)
    return _persistent_rows(closest_hit_wide_rows, "pt_closest_hit_wide_rows",
                            rows, leaf, org, dirn, t_max, base, end,
                            leaf_size, k, counts,
                            _hit_outputs(org.shape[0], rows.device))


def any_hit_wide_rows(rows, leaf, org, dirn, t_cut, base: int, end: int,
                      leaf_size: int, k: int, counts=None):
    """Occlusion per ray by the K-wide preorder walk over w_rows and
    leaf_rows: (R,) bool, True where a triangle lies at t in (1e-4, t_cut),
    each ray capped at MAX_ITERS steps; the same boolean as
    closest_hit_wide_rows(..., t_cut).t < INF wherever t_cut <= INF.
    csrc/any_hit_preorder.cu (K in KERNEL_K; row_loads) on CUDA tensors;
    on CPU tensors its plain version, any_hit_wide_rows_plain (any K).
    `counts` as in closest_hit."""
    base, end = int(base), int(end)
    _check_wide_rows(rows, leaf, org, dirn, t_cut, base, end, leaf_size, k)
    if rows.device.type == "cpu":
        _plain_counts(counts)
        return walks.any_hit_wide_rows_plain(rows, leaf, org, dirn, t_cut,
                                             base, end, leaf_size, k)
    occ = torch.empty(org.shape[0], dtype=torch.bool, device=rows.device)
    return _persistent_rows(any_hit_wide_rows, "pt_any_hit_wide_rows", rows,
                            leaf, org, dirn, t_cut, base, end, leaf_size, k,
                            counts, (occ,))[0]


def _check_tlas(tabs: walks.TlasTables, org, dirn, t):
    """The TLAS walk's contract: the row tables as the XLA walks' (node
    rows of at least 9 + 7K columns, K = tabs.k, 0 for binary rows; leaf
    blocks of at least leaf_size * 9), the TLAS head [0, tlas_end) and
    every instance's BLAS range inside the node rows; the instance and
    primitive tables float32 (the ranges int32), contiguous, of matching
    lengths, on the tables' device and not requiring grad; the affine
    tables on 16-byte boundaries and the ranges on an 8-byte one."""
    if tabs.k != 0 and not 2 <= tabs.k <= 17:
        raise ValueError(f"k={tabs.k}: 0 (binary rows) or 2..17")
    if tabs.tlas_end < 1:
        raise ValueError("the scene has no TLAS")
    _check_row_tables(tabs.rows, tabs.leaf, org, dirn, t, 0, tabs.tlas_end,
                      tabs.leaf_size, tabs.k)
    n_inst = tabs.inst_inv.shape[0]
    n_sph = tabs.sphere_center.shape[0]
    n_cube = tabs.cube_min.shape[0]
    n_cyl = tabs.cyl_radius.shape[0]
    shapes = {"inst_inv": (n_inst, 3, 4), "inst_range": (n_inst, 2),
              "sphere_center": (n_sph, 3), "sphere_radius": (n_sph,),
              "sphere_inv": (n_sph, 3, 4), "cube_min": (n_cube, 3),
              "cube_max": (n_cube, 3), "cube_inv": (n_cube, 3, 4),
              "cyl_radius": (n_cyl,), "cyl_z0": (n_cyl,), "cyl_z1": (n_cyl,),
              "cyl_inv": (n_cyl, 3, 4)}
    for name, shape in shapes.items():
        x = getattr(tabs, name)
        dtype = torch.int32 if name == "inst_range" else torch.float32
        if x.dtype != dtype or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} {shape}")
        if x.device != tabs.rows.device:
            raise ValueError(f"{name} is on {x.device}, the tables on "
                             f"{tabs.rows.device}")
    _check_detached(**{name: getattr(tabs, name) for name in shapes})
    # the kernel reads each world->object affine (48-byte rows) with float4
    # loads and each instance's BLAS range as an int2
    _aligned(16, tabs.inst_inv, tabs.sphere_inv, tabs.cube_inv, tabs.cyl_inv)
    _aligned(8, tabs.inst_range)
    if n_inst:
        _check_ranges(tabs.inst_range, tabs.rows.shape[0])


# id(inst_range) -> (a weak reference to it, its version, the node rows
# it was checked against)
_CHECKED_RANGES = {}


def _check_ranges(rng, n_rows: int):
    """Raise unless every instance's node range lies inside n_rows node
    rows. Reading the ranges waits for the card, so a range table is
    checked once, and again only after it is written to (its version
    counter) or against other node rows: a render passes the scene's
    same tensors to every traversal call, which then waits for nothing."""
    seen = _CHECKED_RANGES.get(id(rng))
    if seen is not None and seen[0]() is rng \
            and seen[1:] == (rng._version, n_rows):
        return
    if not bool(((rng[:, 0] >= 0) & (rng[:, 0] <= rng[:, 1])
                 & (rng[:, 1] <= n_rows)).all()):
        raise ValueError("an instance's node range lies outside the table")
    key = id(rng)
    _CHECKED_RANGES[key] = (
        weakref.ref(rng, lambda _ref: _CHECKED_RANGES.pop(key, None)),
        rng._version, n_rows)


class TlasInstance(NamedTuple):
    """The instance of csrc/tlas_walk.cu that a launch over given tables
    runs: its K (4 or 8 over w_rows; 0 over binary u_rows; -1 reads K
    from the tables at run time) and how it reads the node rows
    ("float4", "float2" or "scalar") and the leaf blocks ("float4" or
    "scalar")."""

    k: int
    rows: str
    leaf: str

    def __str__(self):
        k = {0: "binary", -1: "run-time K"}.get(self.k, f"K={self.k}")
        return f"{k}, {self.rows} rows, {self.leaf} leaves"


def tlas_instance(tabs: walks.TlasTables) -> TlasInstance:
    """The tlas_walk.cu instance closest_hit_tlas and any_hit_tlas launch
    over `tabs`: K = 4 or 8 with float4 row loads where the node rows are
    a stride of a multiple of 4 floats from a 16-byte aligned base (w_rows
    are); binary rows with float2 loads where they are a stride of an
    even number of floats from an 8-byte aligned base (u_rows are);
    leaves with float4 loads where row_loads(leaf) says so. Any other
    tables (another K, or a base off those boundaries) take the instance
    that reads K at run time, with scalar loads of rows and leaves."""
    rows, ptr = tabs.rows, tabs.rows.data_ptr()
    leaf = row_loads(tabs.leaf)
    if tabs.k in KERNEL_K and ptr % 16 == 0 and rows.shape[1] % 4 == 0:
        return TlasInstance(tabs.k, "float4", leaf)
    if tabs.k == 0 and ptr % 8 == 0 and rows.shape[1] % 2 == 0:
        return TlasInstance(0, "float2", leaf)
    return TlasInstance(-1, "scalar", "scalar")


class _TlasScene(ctypes.Structure):
    """csrc/tlas_walk.cu's TlasScene: the tables' pointers, then their
    geometry."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "rows", "leaves", "inst_inv", "inst_range", "sph_center",
        "sph_radius", "sph_inv", "cube_min", "cube_max", "cube_inv",
        "cyl_radius", "cyl_z0", "cyl_z1", "cyl_inv")] + [
        (name, ctypes.c_int) for name in (
            "node_stride", "leaf_stride", "leaf_size", "k", "n_inst",
            "n_sph", "n_cube", "n_cyl", "sph_xform", "cube_xform",
            "cyl_xform")]


def _tlas_launch(wrapper, entry, tabs: walks.TlasTables, org, dirn, t,
                 counts, out):
    """Launch the instance tlas_instance(tabs) names and record it as
    wrapper.instance."""
    _check_card(tabs.rows)
    inst = tlas_instance(tabs)
    scene = _TlasScene(
        *(_ptr(x) for x in (
            tabs.rows, tabs.leaf, tabs.inst_inv, tabs.inst_range,
            tabs.sphere_center, tabs.sphere_radius, tabs.sphere_inv,
            tabs.cube_min, tabs.cube_max, tabs.cube_inv, tabs.cyl_radius,
            tabs.cyl_z0, tabs.cyl_z1, tabs.cyl_inv)),
        tabs.rows.shape[1], tabs.leaf.shape[1], tabs.leaf_size, tabs.k,
        tabs.inst_inv.shape[0], tabs.sphere_center.shape[0],
        tabs.cube_min.shape[0], tabs.cyl_radius.shape[0],
        int(tabs.sphere_xform), int(tabs.cube_xform), int(tabs.cyl_xform))
    # the launch copies the struct into the kernel's parameters
    out = _persistent(wrapper, entry, tabs.rows,
                      (ctypes.addressof(scene), inst.k,
                       int(inst.leaf == "float4")),
                      org, dirn, t, 0, tabs.tlas_end, (walks.MAX_ITERS,),
                      counts, out)
    wrapper.instance = inst
    return out


def closest_hit_tlas(tabs: walks.TlasTables, org, dirn, t_max, counts=None):
    """Closest hit per ray over the whole scene by one walk of the TLAS
    (ptsharp_tpu/intersect.py traverse_scene): (t, kind, index, inst, u,
    v), as closest_hit_tlas_plain gives them, each ray capped at
    MAX_ITERS steps. csrc/tlas_walk.cu (the instance tlas_instance(tabs)
    names, recorded as closest_hit_tlas.instance) on CUDA tensors,
    closest_hit_tlas_plain on CPU tensors; `counts` as in closest_hit."""
    _check_tlas(tabs, org, dirn, t_max)
    if tabs.rows.device.type == "cpu":
        _plain_counts(counts)
        return walks.closest_hit_tlas_plain(tabs, org, dirn, t_max)
    r = org.shape[0]
    dev = tabs.rows.device
    t, index, u, v = _hit_outputs(r, dev)
    kind = torch.empty(r, dtype=torch.int32, device=dev)
    inst = torch.empty_like(kind)
    return _tlas_launch(closest_hit_tlas, "pt_closest_hit_tlas", tabs, org,
                        dirn, t_max, counts, (t, kind, index, inst, u, v))


def any_hit_tlas(tabs: walks.TlasTables, org, dirn, t_cut, counts=None):
    """Occlusion per ray over the whole scene by the TLAS walk: (R,) bool,
    True where a primitive lies at t in (1e-4, t_cut); a lane with
    t_cut <= 0 is never occluded. The same boolean as closest_hit_tlas
    bounded by t_cut, kind != PT_NONE. csrc/tlas_walk.cu (recorded as
    any_hit_tlas.instance) on CUDA tensors, any_hit_tlas_plain on CPU
    tensors; `counts` as in closest_hit."""
    _check_tlas(tabs, org, dirn, t_cut)
    if tabs.rows.device.type == "cpu":
        _plain_counts(counts)
        return walks.any_hit_tlas_plain(tabs, org, dirn, t_cut)
    occ = torch.empty(org.shape[0], dtype=torch.bool, device=tabs.rows.device)
    return _tlas_launch(any_hit_tlas, "pt_any_hit_tlas", tabs, org, dirn,
                        t_cut, counts, (occ,))[0]


WRAPPERS = (closest_hit, any_hit, closest_hit_preorder, any_hit_preorder,
            closest_hit_split, any_hit_split, closest_hit_packet,
            closest_hit_dual, closest_hit_fat_cache, closest_hit_block_cache,
            closest_hit_row_stage, closest_hit_binary, closest_hit_wide_rows,
            any_hit_wide_rows, closest_hit_tlas, any_hit_tlas)
for _w in WRAPPERS:
    _w.launches = _w.rays = 0
# the tlas_walk.cu instance of the last launch (TlasInstance), None before
closest_hit_tlas.instance = any_hit_tlas.instance = None


def reset_launch_counts() -> None:
    """Set every wrapper's `launches` and `rays` (the rays of its
    launches, summed) to 0."""
    for w in WRAPPERS:
        w.launches = w.rays = 0
