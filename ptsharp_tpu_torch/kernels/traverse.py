"""Closest-hit and any-hit over the fat BVH table: wrappers and plain
versions of the four CUDA kernels in csrc/, two walk orders each.

`closest_hit` and `any_hit` walk near to far with a per-ray stack (the
ordered walk, csrc/closest_hit.cu and csrc/any_hit.cu);
`closest_hit_preorder` and `any_hit_preorder` walk the tree in preorder
along its skip links, with no stack (csrc/closest_hit_preorder.cu and
csrc/any_hit_preorder.cu). These four are what the rest of the port
calls. On a CUDA tensor each launches its hand-written kernel on the
current stream and adds one to its `launches` count; on a CPU tensor it
runs its plain version below; any other device raises. There is no
fallback from a kernel to a plain version.

The plain versions compute the same functions in tensor ops: every ray
walks the tree with its own cursor, in lockstep with the others, one node
per loop step: gather the node rows, test the node box against the ray's
best t, run Moller-Trumbore over the leaf block at leaves, and at
internal nodes pick the next node.
  ordered  (`*_plain`): push the hit children far to near on the ray's
           row of an (R, S) stack and continue with the nearest; pop the
           stack where nothing is hit.
  preorder (`*_preorder_plain`): go to the hit child of smallest preorder
           index, or follow the node's skip link where nothing is hit.
           The cursor only grows, so [base, end) bounds the walk.
The kernels follow the same steps in the same order, so each gives the
same slots as its plain version even where two triangles tie. The two
orders find the same t; their slots differ only where triangles tie.

Contract (the JAX package's fat-table kernels):
  fat (2*Nw, 128) f32; org, dirn (R, 3) f32; t_max / t_cut (R,) f32;
  [base, end) the node range; leaf_size triangles per leaf; K children.
  closest hit -> t (R,) f32 (INF where slot < 0), slot (R,) i32 kernel
                 slot, u, v (R,) f32;
  any hit     -> (R,) bool, True where a triangle lies at t in
                 (1e-4, t_cut); False where t_cut <= 0.
"""

from __future__ import annotations

import torch

INF = 1e9
ROW = 128
# traversal stack entries per ray of the ordered walk; ordered scene
# builds check max_stack_bound against it (the full bunny needs 43)
STACK_CAPACITY = 64
KERNEL_K = (4, 8)  # the kernels' template instances
_NO_CHILD = torch.iinfo(torch.int64).max


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


class _Walk:
    """Lockstep per-ray walk state over a fat table: the cursors, the
    best t, and the node loads and box tests that both walk orders share.
    A subclass says where a ray goes next."""

    def __init__(self, fat, org, dirn, bt, base, end, k, start):
        self.fat, self.org, self.dirn, self.k = fat, org, dirn, k
        self.bits = fat.view(torch.int32)
        self.inv = _safe_inv(dirn)
        self.bt = bt
        self.end = end
        self.cur = torch.where(start, base, end).to(torch.int64)

    def visit(self):
        """Load the active lanes' nodes and test their boxes. Returns
        (lanes, node, leaf_lanes_mask, inner_lanes_mask) or None when no
        lane is active."""
        act = torch.nonzero(self.cur < self.end).squeeze(1)
        if act.numel() == 0:
            return None
        node = 2 * self.cur[act]
        tmin, tmax = _slab(self.fat[node, 0:6], self.org[act], self.inv[act])
        hit = _box_hit(tmin, tmax, self.bt[act])
        is_leaf = (self.bits[node, 7] & 0xFF) > 0
        return act, node, hit & is_leaf, hit & ~is_leaf

    def leaf_block(self, lanes, node, leaf_size):
        blk = self.fat[node + 1, :leaf_size * 9].reshape(-1, leaf_size, 9)
        return _mt(blk, self.org[lanes], self.dirn[lanes])

    def child_hits(self, lanes, node):
        """Slab tests of the K child boxes against the lanes' best t:
        (hit, entry t, child index), each (A, K)."""
        k = self.k
        cb = self.fat[node, 9:9 + 6 * k].reshape(-1, k, 6)
        cidx = self.bits[node, 9 + 6 * k:9 + 7 * k].to(torch.int64)
        ctmin, ctmax = _slab(cb, self.org[lanes][:, None, :],
                             self.inv[lanes][:, None, :])
        chit = _box_hit(ctmin, ctmax, self.bt[lanes][:, None]) & (cidx > 0)
        return chit, ctmin, cidx


class _StackWalk(_Walk):
    """The ordered walk: each ray keeps a row of an (R, S) stack."""

    def __init__(self, fat, org, dirn, bt, base, end, k, start):
        super().__init__(fat, org, dirn, bt, base, end, k, start)
        r = org.shape[0]
        self.stack = torch.zeros((r, STACK_CAPACITY), dtype=torch.int64,
                                 device=org.device)
        self.sp = torch.zeros(r, dtype=torch.int64, device=org.device)
        self.max_iters = end - base + 2

    def no_target(self, node):
        """Next node where the box misses or no child is hit: -1, which
        `advance` turns into a pop."""
        return torch.full_like(node, -1)

    def descend(self, lanes, node):
        """Push the hit children far to near; returns each lane's next
        node (-1 where no child is hit)."""
        chit, ctmin, cidx = self.child_hits(lanes, node)
        key = torch.where(chit, ctmin, torch.full_like(ctmin, float("inf")))
        order = torch.argsort(key, dim=1, stable=True)
        shit = torch.gather(chit, 1, order)
        sidx = torch.gather(cidx, 1, order)
        for j in range(self.k - 1, 0, -1):
            sp = self.sp[lanes]
            do = shit[:, j] & (sp < STACK_CAPACITY)
            put = lanes[do]
            self.stack[put, sp[do]] = sidx[do, j]
            self.sp[put] += 1
        return torch.where(shit[:, 0], sidx[:, 0], -1)

    def advance(self, lanes, nxt):
        """Set each lane's next node; lanes with nxt < 0 pop their stack
        (or finish when it is empty)."""
        pop = nxt < 0
        pl = lanes[pop]
        sp = self.sp[pl]
        has = sp > 0
        top = self.stack[pl, torch.clamp(sp - 1, min=0)]
        nxt = nxt.clone()
        nxt[pop] = torch.where(has, top, self.end)
        self.sp[pl] = sp - has.to(sp.dtype)
        self.cur[lanes] = nxt


class _SkipWalk(_Walk):
    """The preorder walk: no stack. Skip links and child indices point
    forward in preorder, so each ray's cursor only grows and end - base
    steps bound the walk."""

    def __init__(self, fat, org, dirn, bt, base, end, k, start):
        super().__init__(fat, org, dirn, bt, base, end, k, start)
        self.max_iters = end - base

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
            tt_ok = torch.where(ok, tt, torch.full_like(tt, float("inf")))
            l = torch.argmin(tt_ok, dim=1, keepdim=True)
            tbest = torch.gather(tt_ok, 1, l).squeeze(1)
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
            ok, tt, _uu, _vv = walk.leaf_block(la, node[leaf], leaf_size)
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
                      leaf_size: int, k: int):
    """Plain PyTorch ordered closest-hit (see the module docstring)."""
    return _walk_closest(_StackWalk(fat, org, dirn, t_max.clone(), base, end,
                                    k, _all_lanes(org)), leaf_size)


def closest_hit_preorder_plain(fat, org, dirn, t_max, base: int, end: int,
                               leaf_size: int, k: int):
    """Plain PyTorch preorder closest-hit (see the module docstring)."""
    return _walk_closest(_SkipWalk(fat, org, dirn, t_max.clone(), base, end,
                                   k, _all_lanes(org)), leaf_size)


def any_hit_plain(fat, org, dirn, t_cut, base: int, end: int,
                  leaf_size: int, k: int):
    """Plain PyTorch ordered any-hit (see the module docstring)."""
    return _walk_any(_StackWalk(fat, org, dirn, t_cut, base, end, k,
                                t_cut > 0.0), t_cut, leaf_size)


def any_hit_preorder_plain(fat, org, dirn, t_cut, base: int, end: int,
                           leaf_size: int, k: int):
    """Plain PyTorch preorder any-hit (see the module docstring)."""
    return _walk_any(_SkipWalk(fat, org, dirn, t_cut, base, end, k,
                               t_cut > 0.0), t_cut, leaf_size)


# ---- wrappers -------------------------------------------------------------


def _check(fat, org, dirn, t, base, end, leaf_size, k):
    if fat.dtype != torch.float32 or fat.dim() != 2 or fat.shape[1] != ROW \
            or fat.shape[0] % 2 or not fat.is_contiguous():
        raise ValueError("fat must be a contiguous (2*Nw, 128) float32 table")
    r = org.shape[0]
    for name, x, shape in (("org", org, (r, 3)), ("dirn", dirn, (r, 3)),
                           ("t", t, (r,))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 {shape}")
        if x.device != fat.device:
            raise ValueError(f"{name} is on {x.device}, fat on {fat.device}")
    if not 0 <= base <= end <= fat.shape[0] // 2:
        raise ValueError(f"node range [{base}, {end}) outside the table")
    if not (1 <= leaf_size and leaf_size * 9 <= ROW) \
            or not (2 <= k and 9 + 7 * k <= ROW):
        raise ValueError(f"leaf_size={leaf_size}, k={k} do not fit a row")


def _kernel_lib(fat, k):
    if fat.device.type != "cuda":
        raise ValueError(f"no kernel for device {fat.device}")
    if k not in KERNEL_K:
        raise ValueError(f"the CUDA kernels are built for K in {KERNEL_K}")
    from ptsharp_tpu_torch.kernels import build

    return build.load()


def _ptr(x):
    return x.data_ptr()


def _closest(wrapper, entry, plain, fat, org, dirn, t_max, base, end,
             leaf_size, k):
    _check(fat, org, dirn, t_max, base, end, leaf_size, k)
    if fat.device.type == "cpu":
        return plain(fat, org, dirn, t_max, base, end, leaf_size, k)
    lib = _kernel_lib(fat, k)
    r = org.shape[0]
    t = torch.empty(r, dtype=torch.float32, device=fat.device)
    slot = torch.empty(r, dtype=torch.int32, device=fat.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    if r == 0:
        return t, slot, u, v
    stream = torch.cuda.current_stream(fat.device).cuda_stream
    err = getattr(lib, entry)(_ptr(fat), _ptr(org), _ptr(dirn), _ptr(t_max),
                              r, base, end, leaf_size, k, _ptr(t),
                              _ptr(slot), _ptr(u), _ptr(v), stream)
    if err:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
    wrapper.launches += 1
    return t, slot, u, v


def _any(wrapper, entry, plain, fat, org, dirn, t_cut, base, end, leaf_size,
         k):
    _check(fat, org, dirn, t_cut, base, end, leaf_size, k)
    if fat.device.type == "cpu":
        return plain(fat, org, dirn, t_cut, base, end, leaf_size, k)
    lib = _kernel_lib(fat, k)
    r = org.shape[0]
    occ = torch.empty(r, dtype=torch.bool, device=fat.device)
    if r == 0:
        return occ
    stream = torch.cuda.current_stream(fat.device).cuda_stream
    err = getattr(lib, entry)(_ptr(fat), _ptr(org), _ptr(dirn), _ptr(t_cut),
                              r, base, end, leaf_size, k, _ptr(occ), stream)
    if err:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
    wrapper.launches += 1
    return occ


def closest_hit(fat, org, dirn, t_max, base: int, end: int, leaf_size: int,
                k: int):
    """Closest hit per ray by the ordered walk: (t, slot, u, v).
    csrc/closest_hit.cu on CUDA tensors, closest_hit_plain on CPU
    tensors."""
    return _closest(closest_hit, "pt_closest_hit", closest_hit_plain, fat,
                    org, dirn, t_max, base, end, leaf_size, k)


def closest_hit_preorder(fat, org, dirn, t_max, base: int, end: int,
                         leaf_size: int, k: int):
    """Closest hit per ray by the preorder walk: (t, slot, u, v).
    csrc/closest_hit_preorder.cu on CUDA tensors,
    closest_hit_preorder_plain on CPU tensors."""
    return _closest(closest_hit_preorder, "pt_closest_hit_preorder",
                    closest_hit_preorder_plain, fat, org, dirn, t_max, base,
                    end, leaf_size, k)


def any_hit(fat, org, dirn, t_cut, base: int, end: int, leaf_size: int,
            k: int):
    """Occlusion per ray by the ordered walk: (R,) bool.
    csrc/any_hit.cu on CUDA tensors, any_hit_plain on CPU tensors."""
    return _any(any_hit, "pt_any_hit", any_hit_plain, fat, org, dirn, t_cut,
                base, end, leaf_size, k)


def any_hit_preorder(fat, org, dirn, t_cut, base: int, end: int,
                     leaf_size: int, k: int):
    """Occlusion per ray by the preorder walk: (R,) bool.
    csrc/any_hit_preorder.cu on CUDA tensors, any_hit_preorder_plain on
    CPU tensors."""
    return _any(any_hit_preorder, "pt_any_hit_preorder",
                any_hit_preorder_plain, fat, org, dirn, t_cut, base, end,
                leaf_size, k)


WRAPPERS = (closest_hit, any_hit, closest_hit_preorder, any_hit_preorder)
for _w in WRAPPERS:
    _w.launches = 0


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0
