"""Closest-hit and any-hit over the BVH tables: wrappers and plain
versions of the CUDA kernels in csrc/ (sixteen entry points).

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
  `warp_packet_plain` models the schedule and its counts.
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
  picks; `TlasTables` names what they read; their plain versions are the
  torch counterpart of ptsharp_tpu/intersect.py traverse_scene,
  `_TlasWalk`).
On a CUDA tensor each wrapper launches its hand-written kernel on the
current stream, adds one to its `launches` count and the launch's rays
to its `rays`; on a CPU tensor it runs its plain version below; any
other device raises. There is no fallback from a kernel to a plain
version. Traversal is not differentiable (the JAX package detaches its
inputs, and no pallas_call has a VJP rule): every wrapper raises where a
table or ray input requires grad.

The plain versions compute the same functions in tensor ops: every ray
walks the tree with its own cursor, in lockstep with the others, one node
per loop step: gather the node rows, test the node box against the ray's
best t, run Moller-Trumbore over the leaf block at leaves, and at
internal nodes pick the next node.
  ordered  (`*_plain`, `*_split_plain`, _StackWalk): take the nearest
           hit child next and push the others on the ray's row of an
           (R, S) stack, far to near ("full") or in static reverse child
           order ("near"), each entry with its entry distance; pop the
           stack where nothing is hit, dropping the entries no longer
           nearer than the best t. Only the root's box is tested as a
           node's own box; the parent's child test decides every other
           node (exact where each child box equals the child's own box
           bit for bit, accel.tables.check_child_boxes). closest_hit_plain
           pushes "near", any_hit_plain "full".
  preorder (`*_preorder_plain`, `closest_hit_packet_plain` and the
           staged walks' plain versions): go to the hit child of smallest
           preorder index, or follow the node's skip link where nothing
           is hit. The cursor only grows, so [base, end) bounds the walk.
           `warp_packet_plain` runs it in packets: a step moves only the
           lanes at their packet's cursor, the least of its lanes'
           cursors, so each lane takes its own walk's steps.
A table view (`_Table`) says where a node row and its leaf block are, so
one walk runs over either table form and gives the same results on both.
The kernels follow the same steps in the same order, so each gives the
same slots as its plain version even where two triangles tie. The two
orders find the same t; their slots differ only where triangles tie.

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

import contextlib
import ctypes
import weakref
from typing import NamedTuple

import torch

from ptsharp_tpu_torch.core import vec

INF = 1e9
ROW = 128
# traversal stack entries per ray of the ordered walk, as the JAX ordered
# kernels hold per group (ordered_kernel.py:34-37); ordered scene builds
# check max_stack_bound against it (the full bunny needs 43)
STACK_CAPACITY = 128
KERNEL_K = (4, 8)  # the kernels' template instances
ORDER_MODES = ("full", "near")  # the ordered walk's push orders
# the push order of any_hit_split's kernel, whatever order_mode names (the
# occlusion is the same in both; "near" measured faster there)
SPLIT_ANY_HIT_ORDER = "near"
# the block-cache kernel's tables are multiples of this many rows, the JAX
# kernel's block (BLK)
CACHE_BLOCK_ROWS = 64
PACKET_WIDTH = 32  # rays a warp packet of #10, #11 and #12
# the warp packets' counters, in the order of their `counts`: packet steps,
# the lanes' own steps, demand block copies, prefetches used and discarded
PACKET_COUNTS = ("packet_steps", "lane_steps", "demand", "used", "discarded")
# each ray's step cap on the XLA walks' row tables, as max_iters caps the
# JAX package's lockstep loops (accel/traverse.py: every active ray takes
# one step an iteration, so the cap is per ray)
MAX_ITERS = 65536
_NO_CHILD = torch.iinfo(torch.int64).max


class Work:
    """What the walks' function needs, counted on the plain walks, for a
    kernel's least time on the card (chip_smoke.py): box tests (each
    visit's own box and, at a hit K-wide internal node, its K children's),
    Moller-Trumbore tests (a leaf's `count` triangles, not its padding
    slots; an any-hit's up to its first accepted one), the TLAS walk's
    analytic leaf tests by primitive type code, its affine transforms of
    a ray (into an instance's or a transformed primitive's object space)
    and its instance entries, and the distinct table rows they read with
    the float32 columns a read uses (a row read twice counts its widest
    read)."""

    def __init__(self):
        self.boxes = 0
        self.triangles = 0
        self.analytic = {}  # primitive type code -> leaf tests
        self.affine = 0
        self.instances = 0
        self._cols = {}  # (table, what) -> columns read per row

    def touch(self, table, what, rows, cols):
        """Rows `rows` of `table` read, `cols` columns each (an int, or a
        tensor beside `rows`)."""
        key = (table.data_ptr(), what)
        if key not in self._cols:
            self._cols[key] = torch.zeros(table.shape[0], dtype=torch.int64,
                                          device=table.device)
        rows = rows.to(torch.int64)
        cols = torch.as_tensor(cols, dtype=torch.int64,
                               device=table.device).expand(rows.shape)
        self._cols[key].scatter_reduce_(0, rows, cols, "amax")

    @property
    def table_bytes(self) -> int:
        return sum(int(cols.sum()) * 4 for cols in self._cols.values())


_work: Work | None = None


@contextlib.contextmanager
def count_work():
    """Count the work of the plain walks run inside the block."""
    global _work
    outer, _work = _work, Work()
    try:
        yield _work
    finally:
        _work = outer


# ---- shared arithmetic (the order of operations of bvh_common.cuh) -------


def _safe_inv(d):
    tiny = torch.where(d < 0, -1e-30, 1e-30)
    return 1.0 / torch.where(torch.abs(d) < 1e-30, tiny, d)


def _slab(box, o, inv):
    """box (..., 6) = lo3, hi3; o, inv broadcast to (..., 3)."""
    lo = (box[..., 0:3] - o) * inv
    hi = (box[..., 3:6] - o) * inv
    mn = torch.minimum(lo, hi)
    mx = torch.maximum(lo, hi)
    tmin = torch.maximum(torch.maximum(mn[..., 0], mn[..., 1]), mn[..., 2])
    tmax = torch.minimum(torch.minimum(mx[..., 0], mx[..., 1]), mx[..., 2])
    return tmin, tmax


def _box_hit(tmin, tmax, bt):
    return (tmax >= torch.clamp(tmin, min=0.0)) & (tmin < bt)


def _mt(tri, o, d):
    """tri (A, L, 9) = (v0, e1, e2) per slot; o, d (A, 3).
    Returns (ok, tt, uu, vv), each (A, L)."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    v0x, v0y, v0z = tri[..., 0], tri[..., 1], tri[..., 2]
    e1x, e1y, e1z = tri[..., 3], tri[..., 4], tri[..., 5]
    e2x, e2y, e2z = tri[..., 6], tri[..., 7], tri[..., 8]
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    det = e1x * hx + e1y * hy + e1z * hz
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    sx = ox - v0x
    sy = oy - v0y
    sz = oz - v0z
    uu = (sx * hx + sy * hy + sz * hz) * inv_det
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    vv = (dx * qx + dy * qy + dz * qz) * inv_det
    tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = ((torch.abs(det) > 1e-12) & (uu >= 0.0) & (uu <= 1.0)
          & (vv >= 0.0) & (uu + vv <= 1.0) & (tt > 1e-4))
    return ok, tt, uu, vv


# ---- the two walks ---------------------------------------------------------


class _Table:
    """Where a walk reads node j's row and its leaf block: the fat
    interleave (rows 2j and 2j+1 of `nodes`) or, with `leaf`, separate
    node and leaf tables (rows[j], and leaf[first // leaf_size], where
    pack_fat takes it from): the split tables, or the XLA walks' u_rows
    or w_rows with leaf_rows. Columns are read by index, so rows of any
    width serve."""

    def __init__(self, nodes, leaf=None, leaf_size: int = 1):
        self.nodes = nodes
        self.bits = nodes.view(torch.int32)
        self.leaf, self.leaf_size = leaf, leaf_size

    def row(self, j):
        """The node-table rows of nodes j."""
        return j if self.leaf is not None else 2 * j

    def leaf_at(self, node):
        """(table, row indices) of the leaf blocks of the leaf nodes at
        node-table rows `node`."""
        if self.leaf is None:
            return self.nodes, node + 1
        first = self.bits[node, 6].to(torch.int64)
        return self.leaf, first // self.leaf_size


class _Walk:
    """Lockstep per-ray walk state over a table view: the cursors, the
    best t, each ray's step count if asked, and the node loads and box
    tests that both walk orders share. A subclass says where a ray goes
    next."""

    own_box = True  # whether a visit tests the node's own box

    def __init__(self, tab, org, dirn, bt, base, end, k, start,
                 count=False):
        self.tab, self.org, self.dirn, self.k = tab, org, dirn, k
        self.nodes, self.bits = tab.nodes, tab.bits
        self.inv = _safe_inv(dirn)
        self.bt = bt
        self.end = end
        self.cur = torch.where(start, base, end).to(torch.int64)
        self.steps = (torch.zeros(org.shape[0], dtype=torch.int32,
                                  device=org.device) if count else None)

    def active(self):
        """The lanes that take a step now: every lane not yet at the end."""
        return torch.nonzero(self.cur < self.end).squeeze(1)

    def visit(self):
        """Load the active lanes' nodes and test their boxes. Returns
        (lanes, node, leaf_lanes_mask, inner_lanes_mask) or None when no
        lane is active; `node` holds node-table rows."""
        act = self.active()
        if act.numel() == 0:
            return None
        if self.steps is not None:
            self.steps[act] += 1
        node = self.tab.row(self.cur[act])
        is_leaf = (self.bits[node, 7] & 0xFF) > 0
        if self.own_box:
            tmin, tmax = _slab(self.nodes[node, 0:6], self.org[act],
                               self.inv[act])
            hit = _box_hit(tmin, tmax, self.bt[act])
        else:
            hit = torch.ones_like(is_leaf)
        inner = hit & ~is_leaf
        if _work is not None:
            _work.boxes += (act.numel() * self.own_box
                            + self.k * int(inner.sum()))
            _work.touch(self.nodes, "node", node, 9 + 7 * self.k)
        return act, node, hit & is_leaf, inner

    def leaf_block(self, lanes, node, leaf_size, t_cut=None):
        """MT of the lanes' rays over the leaf blocks of nodes `node`, all
        leaf_size slots: (ok, tt, uu, vv), each (A, leaf_size). The padding
        slots past a leaf's count hold zero triangles, which MT rejects.
        With t_cut (an any-hit), the work counted stops at each lane's
        first slot accepted at tt < t_cut."""
        table, rows = self.tab.leaf_at(node)
        blk = table[rows, :leaf_size * 9]
        out = _mt(blk.reshape(-1, leaf_size, 9), self.org[lanes],
                  self.dirn[lanes])
        if _work is not None:
            tested = (self.bits[node, 7] & 0xFF).to(torch.int64)
            if t_cut is not None:
                ok, tt = out[0], out[1]
                hit = ok & (tt < t_cut[lanes][:, None])
                first = torch.argmax(hit.to(torch.int8), dim=1) + 1
                tested = torch.where(hit.any(dim=1),
                                     torch.minimum(first, tested), tested)
            _work.triangles += int(tested.sum())
            _work.touch(table, "leaf", rows, tested * 9)
        return out

    def child_hits(self, lanes, node):
        """Slab tests of the K child boxes against the lanes' best t:
        (hit, entry t, child index), each (A, K)."""
        k = self.k
        cb = self.nodes[node, 9:9 + 6 * k].reshape(-1, k, 6)
        cidx = self.bits[node, 9 + 6 * k:9 + 7 * k].to(torch.int64)
        ctmin, ctmax = _slab(cb, self.org[lanes][:, None, :],
                             self.inv[lanes][:, None, :])
        chit = _box_hit(ctmin, ctmax, self.bt[lanes][:, None]) & (cidx > 0)
        return chit, ctmin, cidx


class _StackWalk(_Walk):
    """The ordered walk: each ray keeps a row of an (R, S) stack and
    pushes in the order `order` names (ORDER_MODES). Each entry carries
    the entry distance of its box, which the parent's child test
    computed; a pop drops the entries the ray no longer enters before the
    best t, and no visit tests its own box, since the child test decided
    it (the parent row holds each child's box bit for bit,
    accel.tables.check_child_boxes). Only the root's box is tested, once,
    where the walk starts: a ray that misses it takes no step. The walk
    of #1, #2, #5, #8 and #9."""

    own_box = False

    def __init__(self, tab, org, dirn, bt, base, end, k, start,
                 order="full", count=False):
        _check_order(order)
        if base < end:
            root = tab.nodes[tab.row(base), 0:6]
            tmin, tmax = _slab(root, org, _safe_inv(dirn))
            start = start & _box_hit(tmin, tmax, bt)
            if _work is not None:
                _work.boxes += org.shape[0]
        super().__init__(tab, org, dirn, bt, base, end, k, start, count)
        r = org.shape[0]
        self.order = order
        self.stack = torch.zeros((r, STACK_CAPACITY), dtype=torch.int32,
                                 device=org.device)
        self.stack_t = torch.zeros((r, STACK_CAPACITY), device=org.device)
        self.sp = torch.zeros(r, dtype=torch.int64, device=org.device)
        self.max_iters = end - base + 2

    def no_target(self, node):
        """Next node where the box misses or no child is hit: -1, which
        `advance` turns into a pop."""
        return torch.full_like(node, -1)

    def _push(self, lanes, do, val, key):
        """Push val (entered at `key`) on the stacks of lanes where `do`,
        while they have room (an ordered build checks max_stack_bound <=
        the capacity)."""
        sp = self.sp[lanes]
        do = do & (sp < STACK_CAPACITY)
        put = lanes[do]
        self.stack[put, sp[do]] = val[do].to(torch.int32)
        self.stack_t[put, sp[do]] = key[do]
        self.sp[put] += 1

    def descend(self, lanes, node):
        """Push the hit children other than the nearest ("full": far to
        near; "near": static reverse order, so they pop in child order);
        returns each lane's nearest hit child (-1 where none is hit)."""
        chit, ctmin, cidx = self.child_hits(lanes, node)
        key = torch.where(chit, ctmin, torch.full_like(ctmin, float("inf")))
        order = torch.argsort(key, dim=1, stable=True)
        shit = torch.gather(chit, 1, order)
        sidx = torch.gather(cidx, 1, order)
        if self.order == "full":
            skey = torch.gather(ctmin, 1, order)
            for j in range(self.k - 1, 0, -1):
                self._push(lanes, shit[:, j], sidx[:, j], skey[:, j])
        else:
            child = torch.arange(self.k, device=lanes.device)
            rest = chit & (child[None, :] != order[:, 0:1])
            for c in range(self.k - 1, -1, -1):
                self._push(lanes, rest[:, c], cidx[:, c], ctmin[:, c])
        return torch.where(shit[:, 0], sidx[:, 0], -1)

    def advance(self, lanes, nxt):
        """Set each lane's next node; lanes with nxt < 0 pop their stack,
        past the entries no longer nearer than the best t, or finish when
        it runs out."""
        pop = torch.nonzero(nxt < 0).squeeze(1)
        while pop.numel():
            pl = lanes[pop]
            sp = self.sp[pl]
            has = sp > 0
            pop, pl, sp = pop[has], pl[has], sp[has]
            top = self.stack[pl, sp - 1].to(torch.int64)
            self.sp[pl] = sp - 1
            take = self.stack_t[pl, sp - 1] < self.bt[pl]
            nxt[pop[take]] = top[take]
            pop = pop[~take]
        nxt = torch.where(nxt < 0, self.end, nxt)
        self.cur[lanes] = nxt


class _SkipWalk(_Walk):
    """The preorder walk: no stack. Skip links and child indices point
    forward in preorder, so each ray's cursor only grows and end - base
    steps bound the walk (and `max_iters`, where given, caps it)."""

    def __init__(self, tab, org, dirn, bt, base, end, k, start,
                 max_iters=None, count=False):
        super().__init__(tab, org, dirn, bt, base, end, k, start, count)
        self.max_iters = (end - base if max_iters is None
                          else min(end - base, max_iters))

    def no_target(self, node):
        """Next node where the box misses or no child is hit: the skip
        link, the first node after this one's subtree."""
        return self.bits[node, 8].to(torch.int64)

    def descend(self, lanes, node):
        """The hit child of smallest preorder index (-1 where none is
        hit), as first_hit_child in bvh_common.cuh picks it."""
        chit, _ctmin, cidx = self.child_hits(lanes, node)
        target = torch.where(chit, cidx, _NO_CHILD).amin(dim=1)
        return torch.where(target < _NO_CHILD, target, -1)

    def advance(self, lanes, nxt):
        self.cur[lanes] = nxt


class _PacketWalk(_SkipWalk):
    """The preorder walk in packets of `width` consecutive lanes, one cursor
    a packet: the least of its lanes' own cursors (a segment minimum). A
    step moves only the lanes at their packet's cursor, each by its own
    preorder step, so every lane takes exactly its own walk's steps and
    gets its result; the packet visits the union of its lanes' nodes in
    node order. Records the rows each packet reads, step by step: its
    cursor's node row, and with a separate leaf table the leaf row where
    some lane at the cursor enters a leaf's box (the kernel reads a leaf
    block only then; a fat pair holds it beside the node row)."""

    def __init__(self, tab, org, dirn, bt, base, end, k, width):
        super().__init__(tab, org, dirn, bt, base, end, k, _all_lanes(org),
                         count=True)
        self.packet = torch.arange(org.shape[0], device=org.device) // width
        self.n_packets = -(-org.shape[0] // width)
        self.node_reads = []  # (packets, node-table rows) a step
        self.leaf_reads = []  # (packets, leaf-table rows) a step

    def active(self):
        cursor = torch.full((self.n_packets,), self.end, dtype=torch.int64,
                            device=self.cur.device)
        cursor.scatter_reduce_(0, self.packet, self.cur, "amin")
        at = torch.nonzero(cursor < self.end).squeeze(1)
        self.node_reads.append((at, self.tab.row(cursor[at])))
        return torch.nonzero((self.cur < self.end)
                             & (self.cur == cursor[self.packet])).squeeze(1)

    def visit(self):
        v = super().visit()
        if v is not None and self.tab.leaf is not None:
            act, node, leaf, _inner = v
            # every lane at a packet's cursor reads the same leaf row; act
            # is in lane order, so a packet's lanes are adjacent
            pk, node = self.packet[act[leaf]], node[leaf]
            first = torch.ones_like(pk, dtype=torch.bool)
            first[1:] = pk[1:] != pk[:-1]
            self.leaf_reads.append((pk[first],
                                    self.tab.leaf_at(node[first])[1]))
        return v


def _ring_counts(reads, block_rows: int, limit: int, n_packets: int,
                 prefetch: bool = True, device="cpu"):
    """Demand copies, prefetches used and prefetches discarded, per packet,
    of a ring of two buffers of `block_rows` table rows (TmaRing in
    csrc/bvh_common.cuh) over `reads`, the (packets, rows) each step read.
    The ring holds the block in use and, in its other buffer, a prefetch of
    the next block, issued when the block came into use unless that block
    starts at or past `limit`. A read of another block takes the prefetch
    when it is that block (used), else copies it on demand and discards the
    prefetch; so does a packet's first read, into an empty ring. The
    prefetch left at a packet's end is discarded. Without `prefetch` the
    ring is one buffer (a stage): every read of another block than the one
    it holds, and a packet's first read, is a demand copy. The counts lie
    on `device`, the reads' device."""
    zero = torch.zeros(n_packets, dtype=torch.int64, device=device)
    if not reads:
        return zero, zero.clone(), zero.clone()
    packet = torch.cat([p for p, _r in reads])
    blk = torch.cat([r for _p, r in reads]).to(torch.int64) // block_rows
    order = torch.sort(packet, stable=True).indices  # step order a packet
    packet, blk = packet[order], blk[order]
    change = torch.ones_like(packet, dtype=torch.bool)
    change[1:] = (packet[1:] != packet[:-1]) | (blk[1:] != blk[:-1])
    packet, blk = packet[change], blk[change]
    used = torch.zeros(packet.shape[0], dtype=torch.bool, device=device)
    if prefetch:
        used[1:] = (packet[1:] == packet[:-1]) & (blk[1:] == blk[:-1] + 1)
    issued = ((blk + 1) * block_rows < limit) & prefetch

    def per_packet(mask):
        return torch.bincount(packet[mask], minlength=n_packets)

    n_used = per_packet(used)
    return per_packet(~used), n_used, per_packet(issued) - n_used


def warp_packet_plain(nodes, leaf, org, dirn, t_max, base: int, end: int,
                      leaf_size: int, k: int, block_rows: int,
                      width: int = PACKET_WIDTH, prefetch: bool = True):
    """Plain model of the warp-packet schedule of closest_hit_fat_cache
    (leaf None: `nodes` is the fat table, one ring of fat pairs),
    closest_hit_block_cache and closest_hit_row_stage (`nodes`, `leaf` the
    split tables, a ring or a stage each): the preorder walk in packets of
    `width` lanes with one cursor a packet (_PacketWalk), and each ring's
    copies for buffers of `block_rows` table rows, with or without
    `prefetch` (_ring_counts; the kernels' constants, `cache_layout`).
    Returns (t, slot, u, v, counts): each lane's result, equal to the
    per-lane preorder walk's, and counts, PACKET_COUNTS -> (packets,)
    int64, the numbers the kernels add to their `counts`."""
    tab = _Table(nodes) if leaf is None else _Table(nodes, leaf, leaf_size)
    walk = _PacketWalk(tab, org, dirn, t_max.clone(), base, end, k, width)
    t, slot, u, v = _walk_closest(walk, leaf_size)
    n = walk.n_packets
    steps = torch.bincount(torch.cat([p for p, _r in walk.node_reads]),
                           minlength=n)
    lane_steps = torch.zeros(n, dtype=torch.int64, device=org.device)
    lane_steps.scatter_add_(0, walk.packet, walk.steps.to(torch.int64))
    # node rows are read below row `limit`: 2 end of the fat table, end of
    # the split node rows; leaf rows anywhere in the leaf table
    rings = [_ring_counts(walk.node_reads, block_rows,
                          end * (2 if leaf is None else 1), n, prefetch,
                          org.device)]
    if leaf is not None:
        rings.append(_ring_counts(walk.leaf_reads, block_rows,
                                  leaf.shape[0], n, prefetch, org.device))
    copies = [sum(c) for c in zip(*rings)]
    return t, slot, u, v, dict(zip(PACKET_COUNTS,
                                   (steps, lane_steps, *copies)))


def _first_min(ok, tt, fill=float("inf")):
    """Per row, the first slot of least accepted t and that t (`fill`
    where none is accepted), as jnp.argmin and jnp.min pick them. The
    walks fill with inf, so that no t_max accepts a rejected slot."""
    t_ok = torch.where(ok, tt, torch.full_like(tt, fill))
    lane = torch.argmin(t_ok, dim=1, keepdim=True)
    return lane, torch.gather(t_ok, 1, lane).squeeze(1)


def _walk_closest(walk, leaf_size: int):
    """Run a walk to its end, keeping the closest accepted hit: strict
    tt < best t, the first slot of a leaf among equal t."""
    bt = walk.bt
    r = bt.shape[0]
    dev = bt.device
    bs = torch.full((r,), -1, dtype=torch.int32, device=dev)
    bu = torch.zeros(r, dtype=torch.float32, device=dev)
    bv = torch.zeros(r, dtype=torch.float32, device=dev)
    for _ in range(walk.max_iters):
        v = walk.visit()
        if v is None:
            break
        act, node, leaf, inner = v
        nxt = walk.no_target(node)
        if bool(leaf.any()):
            la = act[leaf]
            ok, tt, uu, vv = walk.leaf_block(la, node[leaf], leaf_size)
            l, tbest = _first_min(ok, tt)
            got = tbest < bt[la]
            g = la[got]
            first = walk.bits[node[leaf], 6][got]
            bt[g] = tbest[got]
            bs[g] = first + l.squeeze(1)[got].to(torch.int32)
            bu[g] = torch.gather(uu, 1, l).squeeze(1)[got]
            bv[g] = torch.gather(vv, 1, l).squeeze(1)[got]
        if bool(inner.any()):
            d = walk.descend(act[inner], node[inner])
            nxt[inner] = torch.where(d >= 0, d, nxt[inner])
        walk.advance(act, nxt)
    t = torch.where(bs >= 0, bt, torch.full_like(bt, INF))
    return t, bs, bu, bv


def _walk_any(walk, t_cut, leaf_size: int):
    """Run a walk with best t fixed at t_cut; a lane finishes on its
    first accepted hit."""
    occ = torch.zeros(t_cut.shape[0], dtype=torch.bool, device=t_cut.device)
    for _ in range(walk.max_iters):
        v = walk.visit()
        if v is None:
            break
        act, node, leaf, inner = v
        nxt = walk.no_target(node)
        if bool(leaf.any()):
            la = act[leaf]
            ok, tt, _uu, _vv = walk.leaf_block(la, node[leaf], leaf_size,
                                               t_cut)
            got = torch.any(ok & (tt < t_cut[la][:, None]), dim=1)
            occ[la[got]] = True
            # an occluded lane is finished: where it would go next no
            # longer matters
            done = torch.zeros_like(leaf)
            done[torch.nonzero(leaf).squeeze(1)[got]] = True
            nxt[done] = walk.end
        if bool(inner.any()):
            d = walk.descend(act[inner], node[inner])
            nxt[inner] = torch.where(d >= 0, d, nxt[inner])
        walk.advance(act, nxt)
    return occ


def _all_lanes(org):
    return torch.ones(org.shape[0], dtype=torch.bool, device=org.device)


def closest_hit_plain(fat, org, dirn, t_max, base: int, end: int,
                      leaf_size: int, k: int, return_iters: bool = False):
    """Plain PyTorch ordered closest-hit, "near" push order (the order
    the JAX package asks of its kernel), with stack entries that carry
    their entry distance (see the module docstring); with return_iters,
    also each ray's step count (int32 (R,)), the steps
    csrc/closest_hit.cu takes."""
    walk = _StackWalk(_Table(fat), org, dirn, t_max.clone(), base, end, k,
                      _all_lanes(org), order="near", count=return_iters)
    out = _walk_closest(walk, leaf_size)
    return (*out, walk.steps) if return_iters else out


def closest_hit_preorder_plain(fat, org, dirn, t_max, base: int, end: int,
                               leaf_size: int, k: int,
                               return_iters: bool = False):
    """Plain PyTorch preorder closest-hit (see the module docstring); with
    return_iters, also each ray's step count (int32 (R,)), the steps
    csrc/closest_hit_preorder.cu takes."""
    walk = _SkipWalk(_Table(fat), org, dirn, t_max.clone(), base, end, k,
                     _all_lanes(org), count=return_iters)
    out = _walk_closest(walk, leaf_size)
    return (*out, walk.steps) if return_iters else out


def any_hit_plain(fat, org, dirn, t_cut, base: int, end: int,
                  leaf_size: int, k: int, return_iters: bool = False):
    """Plain PyTorch ordered any-hit, the walk of closest_hit_plain with
    best t fixed at t_cut, in "full" push order (see the module
    docstring); with return_iters, also each ray's step count (int32
    (R,))."""
    walk = _StackWalk(_Table(fat), org, dirn, t_cut, base, end, k,
                      t_cut > 0.0, count=return_iters)
    occ = _walk_any(walk, t_cut, leaf_size)
    return (occ, walk.steps) if return_iters else occ


def any_hit_preorder_plain(fat, org, dirn, t_cut, base: int, end: int,
                           leaf_size: int, k: int,
                           return_iters: bool = False):
    """Plain PyTorch preorder any-hit (see the module docstring); with
    return_iters, also each ray's step count (int32 (R,))."""
    walk = _SkipWalk(_Table(fat), org, dirn, t_cut, base, end, k,
                     t_cut > 0.0, count=return_iters)
    occ = _walk_any(walk, t_cut, leaf_size)
    return (occ, walk.steps) if return_iters else occ


def any_hit_wide_rows_plain(rows, leaf, org, dirn, t_cut, base: int,
                            end: int, leaf_size: int, k: int,
                            return_iters: bool = False):
    """Plain PyTorch preorder any-hit over the XLA walk's w_rows and
    leaf_rows, each ray capped at MAX_ITERS steps as traverse_wide caps
    it; with return_iters, also each ray's step count (int32 (R,)).
    Equal to traverse_wide(..., t_cut).t < INF wherever t_cut <= INF."""
    walk = _SkipWalk(_Table(rows, leaf, leaf_size), org, dirn, t_cut,
                     int(base), int(end), k, t_cut > 0.0, MAX_ITERS,
                     count=return_iters)
    occ = _walk_any(walk, t_cut, leaf_size)
    return (occ, walk.steps) if return_iters else occ


def closest_hit_split_plain(rows, leaf, org, dirn, t_max, base: int,
                            end: int, leaf_size: int, k: int,
                            order_mode: str = "full",
                            return_iters: bool = False):
    """Plain PyTorch ordered closest-hit over the split tables, the walk
    of closest_hit_plain in the push order `order_mode` names (in "near"
    equal to closest_hit_plain over the fat table they split, steps
    included); with return_iters, also each ray's step count (int32
    (R,)), the steps csrc/closest_hit.cu takes over them."""
    walk = _StackWalk(_Table(rows, leaf, leaf_size), org, dirn,
                      t_max.clone(), base, end, k, _all_lanes(org),
                      order_mode, count=return_iters)
    out = _walk_closest(walk, leaf_size)
    return (*out, walk.steps) if return_iters else out


def any_hit_split_plain(rows, leaf, org, dirn, t_cut, base: int, end: int,
                        leaf_size: int, k: int, order_mode: str = "full",
                        return_iters: bool = False):
    """Plain PyTorch ordered any-hit over the split tables, the walk of
    any_hit_plain in the push order `order_mode` names (the occlusion is
    the same in both; in SPLIT_ANY_HIT_ORDER so are the steps that
    any_hit_split's kernel takes); with return_iters, also each ray's
    step count (int32 (R,))."""
    walk = _StackWalk(_Table(rows, leaf, leaf_size), org, dirn, t_cut, base,
                      end, k, t_cut > 0.0, order_mode, count=return_iters)
    occ = _walk_any(walk, t_cut, leaf_size)
    return (occ, walk.steps) if return_iters else occ


def closest_hit_packet_plain(rows, leaf, org, dirn, t_max, base: int,
                             end: int, leaf_size: int, k: int,
                             return_iters: bool = False):
    """Plain PyTorch preorder closest-hit over the split tables, which
    gives every lane of the JAX kernel's shared-cursor packet the slot the
    packet gives it; with return_iters, also each ray's step count (int32
    (R,)), the steps closest_hit_packet's kernel takes."""
    walk = _SkipWalk(_Table(rows, leaf, leaf_size), org, dirn,
                     t_max.clone(), base, end, k, _all_lanes(org),
                     count=return_iters)
    out = _walk_closest(walk, leaf_size)
    return (*out, walk.steps) if return_iters else out


def closest_hit_dual_plain(fat, org, dirn, t_max, base: int, end: int,
                           leaf_size: int, k: int,
                           return_iters: bool = False):
    """Plain PyTorch version of the two-rays-a-lane ordered walk: per ray
    closest_hit_plain's walk, "near" push order (the only order of the JAX
    kernel) with stack entries that carry their entry distance, which is
    each slot's walk in csrc/closest_hit_dual.cu; with return_iters, also
    each ray's step count (int32 (R,)), the steps that kernel takes."""
    return closest_hit_plain(fat, org, dirn, t_max, base, end, leaf_size, k,
                             return_iters)


def closest_hit_fat_cache_plain(fat, org, dirn, t_max, base: int, end: int,
                                leaf_size: int, k: int):
    """Plain PyTorch version of the block-cached packet walk over the fat
    table: per lane the preorder walk, which gives every lane the slot
    the packet gives it (csrc/closest_hit_fat_cache.cu)."""
    return _walk_closest(_SkipWalk(_Table(fat), org, dirn, t_max.clone(),
                                   base, end, k, _all_lanes(org)), leaf_size)


def closest_hit_block_cache_plain(rows, leaf, org, dirn, t_max, base: int,
                                  end: int, leaf_size: int, k: int):
    """Plain PyTorch version of the two-cache packet walk over the split
    tables: per lane the preorder walk (csrc/closest_hit_block_cache.cu).
    Padding rows past the tables' ends change nothing."""
    return closest_hit_packet_plain(rows, leaf, org, dirn, t_max, base, end,
                                    leaf_size, k)


def closest_hit_row_stage_plain(rows, leaf, org, dirn, t_max, base: int,
                                end: int, leaf_size: int, k: int):
    """Plain PyTorch version of the row-staged warp packet over the split
    tables: per lane the preorder walk, leaf block leaf[first //
    leaf_size] on a leaf table of any length
    (csrc/closest_hit_row_stage.cu)."""
    return closest_hit_packet_plain(rows, leaf, org, dirn, t_max, base, end,
                                    leaf_size, k)


# ---- the TLAS walk: the whole scene in one walk ----------------------------

# the scene's primitive type codes in node rows and hit records
# (ptsharp_tpu_torch/scene.py)
PT_NONE, PT_SPHERE, PT_CUBE, PT_CYLINDER, PT_TRIANGLE = 0, 1, 3, 4, 5
PT_INSTANCE = 9
EPS_T = 1e-4  # least t of an analytic hit (geometry/primitives.py)


class TlasTables(NamedTuple):
    """What the TLAS walk reads: the unified node rows (the TLAS head
    [0, tlas_end), then each mesh's BLAS in object space), binary u_rows
    (k = 0) or K-wide w_rows; the scene's leaf_rows; each instance's
    world->object affine and BLAS node range [base, end); and the analytic
    primitives the TLAS leaves name, in object space with their
    world->object affines (applied where the `*_xform` flag is set).
    intersect.scene_tlas makes it from a scene."""

    rows: torch.Tensor           # (N, 10) u_rows or (Nw, 9 + 7K) w_rows
    leaf: torch.Tensor           # (NL, leaf_size * 9) leaf_rows
    inst_inv: torch.Tensor       # (I, 3, 4)
    inst_range: torch.Tensor     # (I, 2) int32
    sphere_center: torch.Tensor  # (S, 3)
    sphere_radius: torch.Tensor  # (S,)
    sphere_inv: torch.Tensor     # (S, 3, 4)
    cube_min: torch.Tensor       # (C, 3)
    cube_max: torch.Tensor       # (C, 3)
    cube_inv: torch.Tensor       # (C, 3, 4)
    cyl_radius: torch.Tensor     # (Y,)
    cyl_z0: torch.Tensor         # (Y,)
    cyl_z1: torch.Tensor         # (Y,)
    cyl_inv: torch.Tensor        # (Y, 3, 4)
    tlas_end: int
    leaf_size: int
    k: int                       # children a row; 0: binary rows
    sphere_xform: bool
    cube_xform: bool
    cyl_xform: bool


def _safe_den(b):
    """b with |b| < 1e-30 moved to +/-1e-30 (primitives._safe_div)."""
    return torch.where(torch.abs(b) < 1e-30,
                       torch.where(b < 0, -1e-30, 1e-30), b)


def _affine(m, p, point: bool):
    """m (A, 3, 4) applied to p (A, 3), summed left to right as
    csrc/tlas_walk.cu sums it: the translation (of a point) added last."""
    out = []
    for i in range(3):
        x = (m[:, i, 0] * p[:, 0] + m[:, i, 1] * p[:, 1]) + m[:, i, 2] * p[:, 2]
        out.append(x + m[:, i, 3] if point else x)
    return torch.stack(out, dim=1)


def _sphere_t(o, d, c, rad):
    """Nearest hit t > EPS_T of rays (A, 3) on spheres (A, 3), (A,), INF
    where none: ptsharp_tpu/intersect.py _sphere_t1 in the order of
    operations of csrc/tlas_walk.cu."""
    ocx, ocy, ocz = o[:, 0] - c[:, 0], o[:, 1] - c[:, 1], o[:, 2] - c[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    a = (dx * dx + dy * dy) + dz * dz
    b = 2.0 * ((ocx * dx + ocy * dy) + ocz * dz)
    cq = ((ocx * ocx + ocy * ocy) + ocz * ocz) - rad * rad
    disc = b * b - (4.0 * a) * cq
    sq = vec.sqrt(torch.clamp(disc, min=0.0))
    inv2a = 0.5 / torch.clamp(a, min=1e-30)
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    inf = torch.full_like(t0, INF)
    t = torch.where(t0 > EPS_T, t0, torch.where(t1 > EPS_T, t1, inf))
    return torch.where(disc > 0.0, t, inf)


def _cube_t(o, d, lo, hi):
    """Entry t > EPS_T of rays on boxes [lo, hi] (_cube_t1)."""
    inv = 1.0 / _safe_den(d)
    n = (lo - o) * inv
    f = (hi - o) * inv
    mn, mx = torch.minimum(n, f), torch.maximum(n, f)
    t0 = torch.maximum(torch.maximum(mn[:, 0], mn[:, 1]), mn[:, 2])
    t1 = torch.minimum(torch.minimum(mx[:, 0], mx[:, 1]), mx[:, 2])
    ok = (t0 > EPS_T) & (t0 < t1)
    return torch.where(ok, t0, torch.full_like(t0, INF))


def _cyl_t(o, d, rad, z0, z1):
    """Nearest hit t > EPS_T of rays on capped z-cylinders (_cyl_t1)."""
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    den = _safe_den(dz)
    tz0 = (z0 - oz) / den
    tz1 = (z1 - oz) / den
    inf = torch.full_like(tz0, INF)
    r2 = rad * rad

    def cap(tc):
        px = ox + dx * tc
        py = oy + dy * tc
        return torch.where((tc > EPS_T) & (px * px + py * py <= r2), tc, inf)

    a = dx * dx + dy * dy
    b = 2.0 * (ox * dx + oy * dy)
    c = (ox * ox + oy * oy) - r2
    disc = b * b - (4.0 * a) * c
    sq = vec.sqrt(torch.clamp(disc, min=0.0))
    inv2a = 0.5 / torch.clamp(a, min=1e-30)
    tl0 = (-b - sq) * inv2a
    tl1 = (-b + sq) * inv2a

    def lat(tl):
        z = oz + dz * tl
        return (tl > EPS_T) & (z >= z0) & (z <= z1) & (disc >= 0.0)

    t_lat = torch.where(lat(tl0), tl0, torch.where(lat(tl1), tl1, inf))
    return torch.minimum(torch.minimum(cap(tz1), cap(tz0)), t_lat)


class _TlasWalk:
    """The lockstep state of ptsharp_tpu/intersect.py traverse_scene, a
    row a ray, stepped on the active lanes only: the cursor, the return
    slot and the instance with its BLAS end, the ray in the current space
    (world, or an instance's object space: unnormalised, so t stays the
    world ray's) and the best hit."""

    def __init__(self, tabs: TlasTables, org, dirn, bt, start, count):
        r = org.shape[0]
        dev = org.device
        self.tabs, self.org, self.dirn = tabs, org, dirn
        self.bits = tabs.rows.view(torch.int32)
        self.cur = torch.where(start, 0, tabs.tlas_end).to(torch.int64)
        self.ret = torch.full((r,), tabs.tlas_end, dtype=torch.int64,
                              device=dev)
        self.inst = torch.full((r,), -1, dtype=torch.int64, device=dev)
        self.bend = torch.zeros(r, dtype=torch.int64, device=dev)
        self.o, self.d = org.clone(), dirn.clone()
        self.inv = _safe_inv(dirn)
        self.bt = bt
        self.bk = torch.zeros(r, dtype=torch.int32, device=dev)
        self.bi = torch.full((r,), -1, dtype=torch.int32, device=dev)
        self.binst = torch.full((r,), -1, dtype=torch.int32, device=dev)
        self.bu = torch.zeros(r, dtype=torch.float32, device=dev)
        self.bv = torch.zeros(r, dtype=torch.float32, device=dev)
        self.steps = (torch.zeros(r, dtype=torch.int32, device=dev)
                      if count else None)

    def active(self):
        return torch.nonzero((self.inst >= 0)
                             | (self.cur < self.tabs.tlas_end)).squeeze(1)

    def take(self, lanes, t, kind, index, inst, u=None, v=None):
        """Keep each lane's hit (already known to be below its best t)."""
        self.bt[lanes] = t
        self.bk[lanes] = kind
        self.bi[lanes] = index.to(torch.int32)
        self.binst[lanes] = inst.to(torch.int32)
        if u is not None:
            self.bu[lanes] = u
            self.bv[lanes] = v

    def triangles(self, lanes, first, any_hit):
        """MT of the lanes' rays over the leaf blocks at `first`: the lanes
        that accepted a hit below their best t (and, closest-hit, keep
        it: the first slot of least t)."""
        tabs = self.tabs
        ls = tabs.leaf_size
        rows = (first // ls).to(torch.int64)
        blk = tabs.leaf[rows, :ls * 9].reshape(-1, ls, 9)
        ok, tt, uu, vv = _mt(blk, self.o[lanes], self.d[lanes])
        ok = ok & (tt < self.bt[lanes][:, None])
        got = ok.any(dim=1)
        if _work is not None:
            count = (self.bits[self.cur[lanes], 7] & 0xFF).to(torch.int64)
            if any_hit:
                hit1 = torch.argmax(ok.to(torch.int8), dim=1) + 1
                count = torch.where(got, torch.minimum(hit1, count), count)
            _work.triangles += int(count.sum())
            _work.touch(tabs.leaf, "leaf", rows, count * 9)
        if not any_hit:
            lane, t = _first_min(ok, tt)
            g = lanes[got]
            lane = lane[got]
            self.take(g, t[got], PT_TRIANGLE, first[got] + lane.squeeze(1),
                      self.inst[g], torch.gather(uu[got], 1, lane).squeeze(1),
                      torch.gather(vv[got], 1, lane).squeeze(1))
        return lanes[got]

    def analytic(self, lanes, kind, first, any_hit):
        """The analytic leaves of type `kind` at `first`, tested in their
        object space where the scene transforms that type: the lanes that
        hit below their best t (and, closest-hit, keep it)."""
        tabs = self.tabs
        o, d = self.o[lanes], self.d[lanes]
        if kind == PT_SPHERE:
            params = (tabs.sphere_center, tabs.sphere_radius)
            inv, xform, test = tabs.sphere_inv, tabs.sphere_xform, _sphere_t
        elif kind == PT_CUBE:
            params = (tabs.cube_min, tabs.cube_max)
            inv, xform, test = tabs.cube_inv, tabs.cube_xform, _cube_t
        else:
            params = (tabs.cyl_radius, tabs.cyl_z0, tabs.cyl_z1)
            inv, xform, test = tabs.cyl_inv, tabs.cyl_xform, _cyl_t
        pi = torch.clamp(first.to(torch.int64), 0, params[0].shape[0] - 1)
        if xform:
            m = inv[pi]
            o, d = _affine(m, o, True), _affine(m, d, False)
        t = test(o, d, *(p[pi] for p in params))
        got = t < self.bt[lanes]
        if _work is not None:
            _work.analytic[kind] = _work.analytic.get(kind, 0) + lanes.numel()
            _work.affine += lanes.numel() * xform
            for p in params + ((inv,) if xform else ()):
                _work.touch(p, "prim", pi, p[0].numel() if p.dim() > 1 else 1)
        if not any_hit:
            g = lanes[got]
            self.take(g, t[got], kind, first[got], torch.full_like(g, -1))
        return lanes[got]

    def child_step(self, lanes, node, bt):
        """The hit child of smallest preorder index of K-wide rows `node`
        (ptsharp_tpu/accel/traverse.py wide_child_step), -1 where none."""
        k = self.tabs.k
        cb = self.tabs.rows[node, 9:9 + 6 * k].reshape(-1, k, 6)
        cidx = self.bits[node, 9 + 6 * k:9 + 7 * k].to(torch.int64)
        ctmin, ctmax = _slab(cb, self.o[lanes][:, None, :],
                             self.inv[lanes][:, None, :])
        chit = _box_hit(ctmin, ctmax, bt[:, None]) & (cidx > 0)
        target = torch.where(chit, cidx, _NO_CHILD).amin(dim=1)
        return torch.where(target < _NO_CHILD, target, -1)

    def step(self, any_hit):
        """One step of every active lane (traverse_scene's loop body).
        Returns the active lanes, or None when none is left, and (any-hit)
        the lanes that found a blocker."""
        act = self.active()
        if act.numel() == 0:
            return None, None
        tabs = self.tabs
        if self.steps is not None:
            self.steps[act] += 1
        j = self.cur[act]
        bits = self.bits[j]
        first, skip = bits[:, 6], bits[:, 8].to(torch.int64)
        kind = (bits[:, 7] >> 8) & 0xF
        tmin, tmax = _slab(tabs.rows[j, 0:6], self.o[act], self.inv[act])
        hit = _box_hit(tmin, tmax, self.bt[act])
        inner = hit & (kind == PT_NONE)
        if _work is not None:
            _work.boxes += act.numel() + tabs.k * int(inner.sum())
            _work.touch(tabs.rows, "node", j, 9 + 7 * tabs.k if tabs.k
                        else tabs.rows.shape[1])
        blocked = []
        for code in (PT_TRIANGLE, PT_SPHERE, PT_CUBE, PT_CYLINDER):
            m = hit & (kind == code)
            if bool(m.any()):
                if code == PT_TRIANGLE:
                    blocked.append(self.triangles(act[m], first[m], any_hit))
                else:
                    blocked.append(self.analytic(act[m], code, first[m],
                                                 any_hit))
        nxt = skip.clone()
        if bool(inner.any()):
            if tabs.k:
                target = self.child_step(act[inner], j[inner],
                                         self.bt[act[inner]])
                nxt[inner] = torch.where(target >= 0, target, skip[inner])
            else:
                nxt[inner] = j[inner] + 1
        enter = hit & (kind == PT_INSTANCE)
        if bool(enter.any()):
            la = act[enter]
            ii = torch.clamp(first[enter].to(torch.int64), 0,
                             tabs.inst_inv.shape[0] - 1)
            rng = tabs.inst_range[ii].to(torch.int64)
            m = tabs.inst_inv[ii]
            nxt[enter] = rng[:, 0]
            self.ret[la] = skip[enter]
            self.bend[la] = rng[:, 1]
            self.inst[la] = ii
            self.o[la] = _affine(m, self.org[la], True)
            self.d[la] = _affine(m, self.dirn[la], False)
            self.inv[la] = _safe_inv(self.d[la])
            if _work is not None:
                _work.instances += la.numel()
                _work.affine += la.numel()
                _work.touch(tabs.inst_inv, "prim", ii, 12)
                _work.touch(tabs.inst_range, "prim", ii, 2)
        pop = (self.inst[act] >= 0) & (nxt >= self.bend[act])
        if bool(pop.any()):
            la = act[pop]
            nxt[pop] = self.ret[la]
            self.inst[la] = -1
            self.o[la] = self.org[la]
            self.d[la] = self.dirn[la]
            self.inv[la] = _safe_inv(self.dirn[la])
        self.cur[act] = nxt
        if not any_hit:
            return act, None
        blocked = (torch.cat(blocked) if blocked
                   else act.new_zeros(0))
        # a blocked lane is finished
        self.cur[blocked] = tabs.tlas_end
        self.inst[blocked] = -1
        return act, blocked


def closest_hit_tlas_plain(tabs: TlasTables, org, dirn, t_max,
                           return_iters: bool = False):
    """Plain PyTorch version of ptsharp_tpu/intersect.py traverse_scene:
    the closest hit over the whole scene by one walk of the TLAS that
    re-enters each instance's BLAS, each ray capped at MAX_ITERS steps.
    Returns (t, kind, index, inst, u, v): t INF and kind PT_NONE where
    nothing beat t_max; index the scene slot of a triangle or the
    primitive's index; inst the instance of a triangle, else -1; u, v of
    the last triangle kept (an analytic hit keeps them as they were, as
    traverse_scene does). With return_iters, also each ray's step count
    (int32 (R,)), the steps csrc/tlas_walk.cu takes."""
    walk = _TlasWalk(tabs, org, dirn, t_max.clone(), _all_lanes(org),
                     return_iters)
    for _ in range(MAX_ITERS):
        if walk.step(False)[0] is None:
            break
    t = torch.where(walk.bk == PT_NONE, torch.full_like(walk.bt, INF),
                    walk.bt)
    out = (t, walk.bk, walk.bi, walk.binst, walk.bu, walk.bv)
    return (*out, walk.steps) if return_iters else out


def any_hit_tlas_plain(tabs: TlasTables, org, dirn, t_cut,
                       return_iters: bool = False):
    """Plain PyTorch any-hit over the whole scene by the TLAS walk with
    best t fixed at t_cut: (R,) bool, True where a primitive lies at t in
    (1e-4, t_cut); a lane ends on its first accepted hit, and a lane with
    t_cut <= 0 is never occluded and takes no step. The same boolean as
    closest_hit_tlas_plain(..., t_cut) kind != PT_NONE
    (ptsharp_tpu/intersect.py:624-626): until its first accepted hit the
    bounded closest-hit walks with best t = t_cut too. With
    return_iters, also each ray's step count (int32 (R,))."""
    walk = _TlasWalk(tabs, org, dirn, t_cut.clone(), t_cut > 0.0,
                     return_iters)
    occ = torch.zeros(org.shape[0], dtype=torch.bool, device=org.device)
    for _ in range(MAX_ITERS):
        act, blocked = walk.step(True)
        if act is None:
            break
        occ[blocked] = True
    return (occ, walk.steps) if return_iters else occ


# ---- wrappers -------------------------------------------------------------


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


def _check_order(order_mode):
    if order_mode not in ORDER_MODES:
        raise ValueError(f"order_mode must be one of {ORDER_MODES}")


def _kernel_lib(fat, k=None):
    """The kernel library for a launch over tables on `fat.device` at K
    (None: a walk with no K)."""
    if fat.device.type != "cuda":
        raise ValueError(f"no kernel for device {fat.device}")
    if k is not None and k not in KERNEL_K:
        raise ValueError(f"the CUDA kernels are built for K in {KERNEL_K}")
    from ptsharp_tpu_torch.kernels import build

    return build.load()


def _ptr(x):
    return x.data_ptr()


def _launch(wrapper, entry, lib, *args, rays: int):
    """Call a kernel's C entry on the current stream and count the launch
    and its rays."""
    err = getattr(lib, entry)(*args)
    if err:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
    wrapper.launches += 1
    wrapper.rays += rays


def _hit_outputs(r, device):
    t = torch.empty(r, dtype=torch.float32, device=device)
    return (t, torch.empty(r, dtype=torch.int32, device=device),
            torch.empty_like(t), torch.empty_like(t))


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


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


# (device index, stream) -> the two ints of the persistent walks' ray
# counter on that stream: zeroed once here, and by the kernel's last warp
# at the end of each launch, so a launch fills nothing first
_RAY_COUNTERS = {}


@contextlib.contextmanager
def ray_counter(device, stream):
    """The persistent walks' ray counter of `stream` on `device` (also
    kernels/sdf_march.py's), made at first use; a launch inside the block
    that raises RuntimeError drops it, since a failed launch may leave it
    set."""
    key = (device.index, stream)
    if key not in _RAY_COUNTERS:
        _RAY_COUNTERS[key] = torch.zeros(2, dtype=torch.int32, device=device)
    try:
        yield _RAY_COUNTERS[key]
    except RuntimeError:
        del _RAY_COUNTERS[key]
        raise


def _persistent(wrapper, entry, x, lead, org, dirn, t, base, end, tail,
                counts, out, n_counts=2):
    """Launch a persistent walk (csrc/closest_hit.cu, any_hit.cu,
    closest_hit_dual.cu, closest_hit_preorder.cu, any_hit_preorder.cu,
    closest_hit_binary.cu, and the warp packets of closest_hit_fat_cache.cu,
    closest_hit_block_cache.cu and closest_hit_row_stage.cu) over the rays,
    writing `out` (an output of None passes a null pointer): its warps
    take rays from the counter of the current stream, which is at 0
    between launches. `x` is a table (its device and stream), `lead` the
    C entry's arguments before the rays (the tables and their geometry),
    `tail` those after the node range; `counts`, if given, an (n_counts,)
    int64 tensor the kernel adds to."""
    if counts is not None and (counts.dtype != torch.int64
                               or tuple(counts.shape) != (n_counts,)
                               or counts.device != x.device
                               or not counts.is_contiguous()):
        raise ValueError(f"counts must be a contiguous ({n_counts},) int64 "
                         f"tensor on the tables' device")
    r = org.shape[0]
    if r:
        stream = _stream(x)
        with ray_counter(x.device, stream) as next_ray:
            _launch(wrapper, entry, _kernel_lib(x), *lead, _ptr(org),
                    _ptr(dirn), _ptr(t), r, base, end, *tail,
                    *(None if o is None else _ptr(o) for o in out),
                    _ptr(next_ray),
                    None if counts is None else _ptr(counts), stream, rays=r)
    return out


def _persistent_fat(wrapper, entry, fat, org, dirn, t, base, end, k, counts,
                    out):
    """A persistent walk over the fat table, which it reads with float4
    loads."""
    _kernel_lib(fat, k)
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
    _kernel_lib(rows, k)
    lead = (_ptr(rows), _ptr(leaf), rows.shape[1], leaf.shape[1],
            int(row_loads(rows, leaf) == "float4"))
    return _persistent(wrapper, entry, rows, lead, org, dirn, t, base, end,
                       (leaf_size, k, MAX_ITERS), counts, out)


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
        return closest_hit_plain(fat, org, dirn, t_max, base, end,
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
        return closest_hit_preorder_plain(fat, org, dirn, t_max, base, end,
                                          leaf_size, k)
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
        return any_hit_plain(fat, org, dirn, t_cut, base, end, leaf_size, k)
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
        return any_hit_preorder_plain(fat, org, dirn, t_cut, base, end,
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
    _check_order(order_mode)
    if rows.device.type == "cpu":
        _plain_counts(counts)
        return closest_hit_split_plain(rows, leaf, org, dirn, t_max, base,
                                       end, leaf_size, k, order_mode,
                                       return_iters)
    _kernel_lib(rows, k)
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
    _check_order(order_mode)
    if rows.device.type == "cpu":
        _plain_counts(counts)
        return any_hit_split_plain(rows, leaf, org, dirn, t_cut, base, end,
                                   leaf_size, k, order_mode)
    _kernel_lib(rows, k)
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
        return closest_hit_packet_plain(rows, leaf, org, dirn, t_max, base,
                                        end, leaf_size, k)
    _kernel_lib(rows, k)
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
        return closest_hit_dual_plain(fat, org, dirn, t_max, base, end,
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
        return closest_hit_fat_cache_plain(fat, org, dirn, t_max, base, end,
                                           leaf_size, k)
    _kernel_lib(fat, k)
    return _persistent(closest_hit_fat_cache, "pt_closest_hit_fat_cache",
                       fat, _staged_tables(fat), org, dirn, t_max, base, end,
                       (leaf_size, k), counts,
                       _hit_outputs(org.shape[0], fat.device),
                       len(PACKET_COUNTS))


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
        return closest_hit_block_cache_plain(rows, leaf, org, dirn, t_max,
                                             base, end, leaf_size, k)
    _kernel_lib(rows, k)
    return _persistent(closest_hit_block_cache, "pt_closest_hit_block_cache",
                       rows, _staged_tables(rows, leaf), org, dirn, t_max,
                       base, end, (leaf_size, k), counts,
                       _hit_outputs(org.shape[0], rows.device),
                       len(PACKET_COUNTS))


def cache_layout(wrapper):
    """(table rows a ring buffer holds, dynamic shared memory a launch asks
    for in bytes, whether the rings prefetch) of a warp-packet kernel,
    closest_hit_fat_cache, closest_hit_block_cache or
    closest_hit_row_stage, from the built library: the block_rows and
    prefetch that warp_packet_plain takes to model it. Needs the card's
    toolchain."""
    from ptsharp_tpu_torch.kernels import build

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
        return closest_hit_row_stage_plain(rows, leaf, org, dirn, t_max,
                                           base, end, leaf_size, k)
    _kernel_lib(rows, k)
    return _persistent(closest_hit_row_stage, "pt_closest_hit_row_stage",
                       rows, _staged_tables(rows, leaf), org, dirn, t_max,
                       base, end, (leaf_size, k), counts,
                       _hit_outputs(org.shape[0], rows.device),
                       len(PACKET_COUNTS))


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
    from ptsharp_tpu_torch.accel import traverse as walks

    base, end = int(base), int(end)
    _check_row_tables(rows, leaf, org, dirn, t_max, base, end, leaf_size, 0)
    if rows.device.type == "cpu":
        _plain_counts(counts)
        return walks.traverse_packed(rows, leaf, org, dirn, t_max, base, end,
                                     leaf_size)
    _kernel_lib(rows)
    if rows.shape[1] % 2:
        raise ValueError("rows must be a stride of an even number of floats "
                         "(float2 loads)")
    _aligned(8, rows)
    lead = (_ptr(rows), _ptr(leaf), rows.shape[1], leaf.shape[1],
            int(row_loads(leaf) == "float4"))
    return _persistent(closest_hit_binary, "pt_closest_hit_binary", rows,
                       lead, org, dirn, t_max, base, end,
                       (leaf_size, MAX_ITERS), counts,
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
    from ptsharp_tpu_torch.accel import traverse as walks

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
        return any_hit_wide_rows_plain(rows, leaf, org, dirn, t_cut, base,
                                       end, leaf_size, k)
    occ = torch.empty(org.shape[0], dtype=torch.bool, device=rows.device)
    return _persistent_rows(any_hit_wide_rows, "pt_any_hit_wide_rows", rows,
                            leaf, org, dirn, t_cut, base, end, leaf_size, k,
                            counts, (occ,))[0]


def _check_tlas(tabs: TlasTables, org, dirn, t):
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


def tlas_instance(tabs: TlasTables) -> TlasInstance:
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


def _tlas_launch(wrapper, entry, tabs: TlasTables, org, dirn, t, counts,
                 out):
    """Launch the instance tlas_instance(tabs) names and record it as
    wrapper.instance."""
    _kernel_lib(tabs.rows)
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
                      org, dirn, t, 0, tabs.tlas_end, (MAX_ITERS,), counts,
                      out)
    wrapper.instance = inst
    return out


def closest_hit_tlas(tabs: TlasTables, org, dirn, t_max, counts=None):
    """Closest hit per ray over the whole scene by one walk of the TLAS
    (ptsharp_tpu/intersect.py traverse_scene): (t, kind, index, inst, u,
    v), as closest_hit_tlas_plain gives them, each ray capped at
    MAX_ITERS steps. csrc/tlas_walk.cu (the instance tlas_instance(tabs)
    names, recorded as closest_hit_tlas.instance) on CUDA tensors,
    closest_hit_tlas_plain on CPU tensors; `counts` as in closest_hit."""
    _check_tlas(tabs, org, dirn, t_max)
    if tabs.rows.device.type == "cpu":
        _plain_counts(counts)
        return closest_hit_tlas_plain(tabs, org, dirn, t_max)
    r = org.shape[0]
    dev = tabs.rows.device
    t, index, u, v = _hit_outputs(r, dev)
    kind = torch.empty(r, dtype=torch.int32, device=dev)
    inst = torch.empty_like(kind)
    return _tlas_launch(closest_hit_tlas, "pt_closest_hit_tlas", tabs, org,
                        dirn, t_max, counts, (t, kind, index, inst, u, v))


def any_hit_tlas(tabs: TlasTables, org, dirn, t_cut, counts=None):
    """Occlusion per ray over the whole scene by the TLAS walk: (R,) bool,
    True where a primitive lies at t in (1e-4, t_cut); a lane with
    t_cut <= 0 is never occluded. The same boolean as closest_hit_tlas
    bounded by t_cut, kind != PT_NONE. csrc/tlas_walk.cu (recorded as
    any_hit_tlas.instance) on CUDA tensors, any_hit_tlas_plain on CPU
    tensors; `counts` as in closest_hit."""
    _check_tlas(tabs, org, dirn, t_cut)
    if tabs.rows.device.type == "cpu":
        _plain_counts(counts)
        return any_hit_tlas_plain(tabs, org, dirn, t_cut)
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
