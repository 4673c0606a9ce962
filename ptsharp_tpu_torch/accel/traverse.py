"""The plain walks over the BVH tables, in PyTorch: the JAX package's XLA
walks, and the plain version of every CUDA kernel that kernels/traverse.py
wraps. kernels/traverse.py runs these on CPU tensors, and the tests hold
each kernel to its plain version bit for bit. Nothing here imports
kernels/.

The XLA walks (counterpart of ptsharp_tpu/accel/traverse.py): every ray
walks the flattened BVH along skip links with one cursor: advance to the
next node where the node's box is hit, else to its skip link (the first
node after its subtree); leaves run Moller-Trumbore over their
fixed-width block.

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
leaf (`_Walk`); each ray's walk, and so its result, is the same. The
lockstep loop's `max_iters` caps each ray's steps, since every active ray
takes one step an iteration. The `*_chunked` wrappers keep the JAX
signatures: `lax.map` over chunks bounds the lockstep waste of a TPU
loop, and no ray's result depends on its chunk, so these walk unchunked.

The kernels' plain versions (`*_plain`) compute the same functions in
tensor ops: every ray walks the tree with its own cursor, in lockstep
with the others, one node per loop step: gather the node rows, test the
node box against the ray's best t, run Moller-Trumbore over the leaf
block at leaves, and at internal nodes pick the next node.
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
           staged walks' plain versions, SkipWalk): go to the hit child of
           smallest preorder index, or follow the node's skip link where
           nothing is hit. The cursor only grows, so [base, end) bounds
           the walk. `warp_packet_plain` runs it in packets (PacketWalk):
           a step moves only the lanes at their packet's cursor, the least
           of its lanes' cursors, so each lane takes its own walk's steps.
  TLAS     (`closest_hit_tlas_plain`, `any_hit_tlas_plain`, _TlasWalk):
           the torch counterpart of ptsharp_tpu/intersect.py
           traverse_scene over `TlasTables`, its analytic leaves tested by
           `sphere_t`, `cube_t` and `cyl_t`.
A table view (`Table`) says where a node row and its leaf block are, so
one walk runs over either table form and gives the same results on both.
The shared arithmetic (`safe_inv`, `slab`, `box_hit`, `mt`) and the
analytic tests keep the order of operations of csrc/bvh_common.cuh and
csrc/tlas_walk.cu, and the kernels follow the same steps in the same
order, so each kernel gives the same slots as its plain version even
where two triangles tie. The two orders find the same t; their slots
differ only where triangles tie. `count_work` counts what the plain walks
do (`Work`).

Closest-hit walks return (t, slot, u, v): t = INF and slot = -1 on a
miss; slot indexes the scene's slot-ordered triangles for the XLA walks
and the kernel's slots for the plain versions. Any-hit walks return an
(R,) bool.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from ptsharp_tpu_torch.core import vec

INF = 1e9
# traversal stack entries per ray of the ordered walk, as the JAX ordered
# kernels hold per group (ordered_kernel.py:34-37): the kernels' stack,
# kernels/build.py STACK_CAPACITY, which nvcc gets as PT_STACK_CAP
STACK_CAPACITY = 128
ORDER_MODES = ("full", "near")  # the ordered walk's push orders
PACKET_WIDTH = 32  # rays a warp packet of #10, #11 and #12
# the warp packets' counters, in the order of their `counts`: packet steps,
# the lanes' own steps, demand block copies, prefetches used and discarded
PACKET_COUNTS = ("packet_steps", "lane_steps", "demand", "used", "discarded")
# each ray's step cap on the XLA walks' row tables, as max_iters caps the
# JAX package's lockstep loops (every active ray takes one step an
# iteration, so the cap is per ray)
MAX_ITERS = 65536
_NO_CHILD = torch.iinfo(torch.int64).max


def check_order(order_mode):
    if order_mode not in ORDER_MODES:
        raise ValueError(f"order_mode must be one of {ORDER_MODES}")


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


def safe_inv(d):
    tiny = torch.where(d < 0, -1e-30, 1e-30)
    return 1.0 / torch.where(torch.abs(d) < 1e-30, tiny, d)


def slab(box, o, inv):
    """box (..., 6) = lo3, hi3; o, inv broadcast to (..., 3)."""
    lo = (box[..., 0:3] - o) * inv
    hi = (box[..., 3:6] - o) * inv
    mn = torch.minimum(lo, hi)
    mx = torch.maximum(lo, hi)
    tmin = torch.maximum(torch.maximum(mn[..., 0], mn[..., 1]), mn[..., 2])
    tmax = torch.minimum(torch.minimum(mx[..., 0], mx[..., 1]), mx[..., 2])
    return tmin, tmax


def box_hit(tmin, tmax, bt):
    return (tmax >= torch.clamp(tmin, min=0.0)) & (tmin < bt)


def mt(tri, o, d):
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


class Table:
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
        self.inv = safe_inv(dirn)
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
            tmin, tmax = slab(self.nodes[node, 0:6], self.org[act],
                               self.inv[act])
            hit = box_hit(tmin, tmax, self.bt[act])
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
        out = mt(blk.reshape(-1, leaf_size, 9), self.org[lanes],
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
        ctmin, ctmax = slab(cb, self.org[lanes][:, None, :],
                             self.inv[lanes][:, None, :])
        chit = box_hit(ctmin, ctmax, self.bt[lanes][:, None]) & (cidx > 0)
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
        check_order(order)
        if base < end:
            root = tab.nodes[tab.row(base), 0:6]
            tmin, tmax = slab(root, org, safe_inv(dirn))
            start = start & box_hit(tmin, tmax, bt)
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


class SkipWalk(_Walk):
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


class PacketWalk(SkipWalk):
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


def ring_counts(reads, block_rows: int, limit: int, n_packets: int,
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
    `width` lanes with one cursor a packet (PacketWalk), and each ring's
    copies for buffers of `block_rows` table rows, with or without
    `prefetch` (ring_counts; the kernels' constants, `cache_layout`).
    Returns (t, slot, u, v, counts): each lane's result, equal to the
    per-lane preorder walk's, and counts, PACKET_COUNTS -> (packets,)
    int64, the numbers the kernels add to their `counts`."""
    tab = Table(nodes) if leaf is None else Table(nodes, leaf, leaf_size)
    walk = PacketWalk(tab, org, dirn, t_max.clone(), base, end, k, width)
    t, slot, u, v = walk_closest(walk, leaf_size)
    n = walk.n_packets
    steps = torch.bincount(torch.cat([p for p, _r in walk.node_reads]),
                           minlength=n)
    lane_steps = torch.zeros(n, dtype=torch.int64, device=org.device)
    lane_steps.scatter_add_(0, walk.packet, walk.steps.to(torch.int64))
    # node rows are read below row `limit`: 2 end of the fat table, end of
    # the split node rows; leaf rows anywhere in the leaf table
    rings = [ring_counts(walk.node_reads, block_rows,
                          end * (2 if leaf is None else 1), n, prefetch,
                          org.device)]
    if leaf is not None:
        rings.append(ring_counts(walk.leaf_reads, block_rows,
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


def walk_closest(walk, leaf_size: int):
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
    walk = _StackWalk(Table(fat), org, dirn, t_max.clone(), base, end, k,
                      _all_lanes(org), order="near", count=return_iters)
    out = walk_closest(walk, leaf_size)
    return (*out, walk.steps) if return_iters else out


def closest_hit_preorder_plain(fat, org, dirn, t_max, base: int, end: int,
                               leaf_size: int, k: int,
                               return_iters: bool = False):
    """Plain PyTorch preorder closest-hit (see the module docstring); with
    return_iters, also each ray's step count (int32 (R,)), the steps
    csrc/closest_hit_preorder.cu takes."""
    walk = SkipWalk(Table(fat), org, dirn, t_max.clone(), base, end, k,
                     _all_lanes(org), count=return_iters)
    out = walk_closest(walk, leaf_size)
    return (*out, walk.steps) if return_iters else out


def any_hit_plain(fat, org, dirn, t_cut, base: int, end: int,
                  leaf_size: int, k: int, return_iters: bool = False):
    """Plain PyTorch ordered any-hit, the walk of closest_hit_plain with
    best t fixed at t_cut, in "full" push order (see the module
    docstring); with return_iters, also each ray's step count (int32
    (R,))."""
    walk = _StackWalk(Table(fat), org, dirn, t_cut, base, end, k,
                      t_cut > 0.0, count=return_iters)
    occ = _walk_any(walk, t_cut, leaf_size)
    return (occ, walk.steps) if return_iters else occ


def any_hit_preorder_plain(fat, org, dirn, t_cut, base: int, end: int,
                           leaf_size: int, k: int,
                           return_iters: bool = False):
    """Plain PyTorch preorder any-hit (see the module docstring); with
    return_iters, also each ray's step count (int32 (R,))."""
    walk = SkipWalk(Table(fat), org, dirn, t_cut, base, end, k,
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
    walk = SkipWalk(Table(rows, leaf, leaf_size), org, dirn, t_cut,
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
    walk = _StackWalk(Table(rows, leaf, leaf_size), org, dirn,
                      t_max.clone(), base, end, k, _all_lanes(org),
                      order_mode, count=return_iters)
    out = walk_closest(walk, leaf_size)
    return (*out, walk.steps) if return_iters else out


def any_hit_split_plain(rows, leaf, org, dirn, t_cut, base: int, end: int,
                        leaf_size: int, k: int, order_mode: str = "full",
                        return_iters: bool = False):
    """Plain PyTorch ordered any-hit over the split tables, the walk of
    any_hit_plain in the push order `order_mode` names (the occlusion is
    the same in both; in kernels.traverse.SPLIT_ANY_HIT_ORDER so are the
    steps that any_hit_split's kernel takes); with return_iters, also each
    ray's step count (int32 (R,))."""
    walk = _StackWalk(Table(rows, leaf, leaf_size), org, dirn, t_cut, base,
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
    walk = SkipWalk(Table(rows, leaf, leaf_size), org, dirn,
                     t_max.clone(), base, end, k, _all_lanes(org),
                     count=return_iters)
    out = walk_closest(walk, leaf_size)
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
    return walk_closest(SkipWalk(Table(fat), org, dirn, t_max.clone(),
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


def sphere_t(o, d, c, rad):
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


def cube_t(o, d, lo, hi):
    """Entry t > EPS_T of rays on boxes [lo, hi] (_cube_t1)."""
    inv = 1.0 / _safe_den(d)
    n = (lo - o) * inv
    f = (hi - o) * inv
    mn, mx = torch.minimum(n, f), torch.maximum(n, f)
    t0 = torch.maximum(torch.maximum(mn[:, 0], mn[:, 1]), mn[:, 2])
    t1 = torch.minimum(torch.minimum(mx[:, 0], mx[:, 1]), mx[:, 2])
    ok = (t0 > EPS_T) & (t0 < t1)
    return torch.where(ok, t0, torch.full_like(t0, INF))


def cyl_t(o, d, rad, z0, z1):
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
        self.inv = safe_inv(dirn)
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
        ok, tt, uu, vv = mt(blk, self.o[lanes], self.d[lanes])
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
            inv, xform, test = tabs.sphere_inv, tabs.sphere_xform, sphere_t
        elif kind == PT_CUBE:
            params = (tabs.cube_min, tabs.cube_max)
            inv, xform, test = tabs.cube_inv, tabs.cube_xform, cube_t
        else:
            params = (tabs.cyl_radius, tabs.cyl_z0, tabs.cyl_z1)
            inv, xform, test = tabs.cyl_inv, tabs.cyl_xform, cyl_t
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
        ctmin, ctmax = slab(cb, self.o[lanes][:, None, :],
                             self.inv[lanes][:, None, :])
        chit = box_hit(ctmin, ctmax, bt[:, None]) & (cidx > 0)
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
        tmin, tmax = slab(tabs.rows[j, 0:6], self.o[act], self.inv[act])
        hit = box_hit(tmin, tmax, self.bt[act])
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
            self.inv[la] = safe_inv(self.d[la])
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
            self.inv[la] = safe_inv(self.dirn[la])
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


# ---- the XLA walks ---------------------------------------------------------


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
    inv = safe_inv(dirn)
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
        tmin, tmax = slab(box, org[act], inv[act])
        hit = box_hit(tmin, tmax, bt[act])
        count = mesh.node_count[j]
        is_leaf = count > 0
        nxt = torch.where(hit & ~is_leaf, j + 1, mesh.node_skip[j].long())
        leaf = hit & is_leaf
        if bool(leaf.any()):
            la = act[leaf]
            start = mesh.node_first[j[leaf]].long()
            idx = torch.clamp(start[:, None] + lanes, 0, n_tri - 1)
            tri = torch.cat([mesh.v0[idx], mesh.e1[idx], mesh.e2[idx]], -1)
            ok, tt, uu, vv = mt(tri, org[la], dirn[la])
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
    ok, tt, uu, vv = mt(blk[:, :leaf_size * 9].reshape(-1, leaf_size, 9),
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
    ctmin, ctmax = slab(cb, org[:, None, :], inv_d[:, None, :])
    chit = box_hit(ctmin, ctmax, bt[:, None]) & (cidx > 0)
    big = torch.iinfo(torch.int32).max
    target = torch.where(chit, cidx, big).amin(dim=1)
    has_child = target < big
    return torch.where(has_child, target, skip), has_child


class _BinaryWalk(SkipWalk):
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
    walk = _BinaryWalk(Table(rows, leaf_rows, leaf_size), org, dirn,
                       _rays_t(t_max, org), base, end, 0,
                       torch.ones(org.shape[0], dtype=torch.bool,
                                  device=org.device), max_iters,
                       count=return_iters)
    out = walk_closest(walk, leaf_size)
    return (*out, walk.steps) if return_iters else out


def traverse_wide(rows, leaf_rows, org, dirn, t_max, base, end,
                  leaf_size: int, k: int, max_iters: int = MAX_ITERS,
                  return_iters: bool = False):
    """Closest hit by the K-wide preorder walk over w_rows (Nw,
    row_width(K)) and leaf_rows (NL, leaf_size * 9), nodes [base, end);
    with return_iters, also each ray's step count (int32 (R,)), the steps
    kernels.traverse.closest_hit_wide_rows takes."""
    base, end = int(base), int(end)
    walk = SkipWalk(Table(rows, leaf_rows, leaf_size), org, dirn,
                     _rays_t(t_max, org), base, end, k,
                     torch.ones(org.shape[0], dtype=torch.bool,
                                device=org.device), max_iters,
                     count=return_iters)
    out = walk_closest(walk, leaf_size)
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
