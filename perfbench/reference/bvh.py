"""A plain bounding-volume hierarchy and its closest-hit and any-hit
walks, in PyTorch tensors on any device.

The tree is a complete binary tree over the triangles in Morton order of
their centroids (leaves of LEAF triangles, padded with empty slots to a
power of two), laid out as a heap: node i has children 2i+1 and 2i+2.
The walk keeps a stack a ray and advances every ray with a non-empty
stack by one node an iteration, near child first, over whatever device
the tensors live on. It finds the nearest triangle with t in (1e-4,
t_max) by the Moller-Trumbore test below, whatever the tree's shape.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

LEAF = 4
STACK = 64
T_MIN = 1e-4  # least accepted hit distance


@dataclass
class Tree:
    lo: torch.Tensor      # (N, 3) node boxes
    hi: torch.Tensor
    slot_tri: torch.Tensor  # (n_leaf * LEAF,) triangle of a leaf slot, -1
    n_leaf: int


def _spread10(x):
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def build(v0, e1, e2) -> Tree:
    """The tree over triangles (v0, v0 + e1, v0 + e2)."""
    dev, dt = v0.device, v0.dtype
    t = v0.shape[0]
    corners = torch.stack([v0, v0 + e1, v0 + e2], dim=1).float()
    c = corners.mean(dim=1)
    lo, hi = c.amin(dim=0), c.amax(dim=0)
    q = ((c - lo) / torch.clamp(hi - lo, min=1e-12) * 1023.0).long()
    code = (_spread10(q[:, 0]) << 2) | (_spread10(q[:, 1]) << 1) \
        | _spread10(q[:, 2])
    order = torch.argsort(code, stable=True)
    n_leaf = 1
    while n_leaf * LEAF < t:
        n_leaf *= 2
    slot_tri = torch.full((n_leaf * LEAF,), -1, dtype=torch.int64,
                          device=dev)
    slot_tri[:t] = order
    tlo = corners.amin(dim=1)
    thi = corners.amax(dim=1)
    # pad each box by a margin, so that rounding in the test never puts a
    # hit outside its box
    pad = 1e-5 * torch.clamp(torch.abs(tlo).amax() + torch.abs(thi).amax(),
                             min=1.0)
    inf = torch.full((n_leaf * LEAF - t, 3), float("inf"), device=dev)
    slo = torch.cat([tlo[order] - pad, inf]).reshape(n_leaf, LEAF, 3)
    shi = torch.cat([thi[order] + pad, -inf]).reshape(n_leaf, LEAF, 3)
    levels_lo, levels_hi = [slo.amin(dim=1)], [shi.amax(dim=1)]
    while levels_lo[-1].shape[0] > 1:
        a, b = levels_lo[-1], levels_hi[-1]
        levels_lo.append(torch.minimum(a[0::2], a[1::2]))
        levels_hi.append(torch.maximum(b[0::2], b[1::2]))
    return Tree(lo=torch.cat(levels_lo[::-1]).to(dt),
                hi=torch.cat(levels_hi[::-1]).to(dt), slot_tri=slot_tri,
                n_leaf=n_leaf)


def moller_trumbore(o, d, v0, e1, e2):
    """(t, u, v, ok) of rays o, d (A, 1, 3) against triangles (A, L, 3),
    with the determinant clamped at 1e-12; ok where the ray meets the
    triangle at t > 1e-4."""
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    e1x, e1y, e1z = e1[..., 0], e1[..., 1], e1[..., 2]
    e2x, e2y, e2z = e2[..., 0], e2[..., 1], e2[..., 2]
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    det = e1x * hx + e1y * hy + e1z * hz
    small = torch.abs(det) < 1e-12
    inv_det = 1.0 / torch.where(small, torch.full_like(det, 1e-12), det)
    s = o - v0
    sx, sy, sz = s[..., 0], s[..., 1], s[..., 2]
    u = (sx * hx + sy * hy + sz * hz) * inv_det
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = (~small & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > T_MIN))
    return t, u, v, ok


def _boxes(tree, node, o, inv):
    """Entry and exit distances of the rays through the nodes' boxes; an
    empty node (its box inverted) is never entered."""
    lo, hi = tree.lo[node], tree.hi[node]
    n = (lo - o) * inv
    f = (hi - o) * inv
    tmin = torch.amax(torch.minimum(n, f), dim=-1)
    tmax = torch.amin(torch.maximum(n, f), dim=-1)
    empty = lo[..., 0] > hi[..., 0]
    return tmin, torch.where(empty, torch.full_like(tmax, -1.0), tmax)


def walk(tree: Tree, v0, e1, e2, org, dirn, t_max, any_hit: bool = False):
    """Closest hit: (t, tri, u, v), tri -1 and t = t_max where no triangle
    lies in (1e-4, t_max). Any hit (any_hit=True): a bool, whether one
    does."""
    dev = org.device
    r = org.shape[0]
    tiny = torch.where(dirn < 0, -1e-30, 1e-30).to(dirn.dtype)
    inv = 1.0 / torch.where(torch.abs(dirn) < 1e-30, tiny, dirn)
    best_t = t_max.clone()
    best_tri = torch.full((r,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    stack = torch.zeros((r, STACK), dtype=torch.int64, device=dev)
    root = torch.zeros(r, dtype=torch.int64, device=dev)
    tmin, tmax = _boxes(tree, root, org, inv)
    sp = ((tmax >= torch.clamp(tmin, min=0.0)) & (tmin < best_t)).long()
    first_leaf = tree.n_leaf - 1
    lanes = torch.arange(LEAF, device=dev)
    active = torch.nonzero(sp > 0).squeeze(1)
    while active.numel():
        top = sp[active] - 1
        node = stack[active, top]
        sp[active] = top
        leaf = node >= first_leaf
        la = active[leaf]
        if la.numel():
            slots = (node[leaf] - first_leaf)[:, None] * LEAF + lanes
            tri = tree.slot_tri[slots]
            tc = torch.clamp(tri, min=0)
            t, u, v, ok = moller_trumbore(org[la][:, None], dirn[la][:, None],
                                          v0[tc], e1[tc], e2[tc])
            bt = best_t[la]
            ok = ok & (tri >= 0) & (t < bt[:, None])
            if any_hit:
                sp[la] = torch.where(ok.any(dim=1), 0, sp[la])
                best_tri[la] = torch.where(ok.any(dim=1), 0, best_tri[la])
            else:
                t = torch.where(ok, t, torch.full_like(t, float("inf")))
                j = torch.argmin(t, dim=1, keepdim=True)
                tj = torch.gather(t, 1, j).squeeze(1)
                better = tj < bt
                best_t[la] = torch.where(better, tj, bt)
                best_tri[la] = torch.where(
                    better, torch.gather(tri, 1, j).squeeze(1), best_tri[la])
                best_u[la] = torch.where(
                    better, torch.gather(u, 1, j).squeeze(1), best_u[la])
                best_v[la] = torch.where(
                    better, torch.gather(v, 1, j).squeeze(1), best_v[la])
        ia = active[~leaf]
        if ia.numel():
            c0 = 2 * node[~leaf] + 1
            c1 = c0 + 1
            o, iv, bt = org[ia], inv[ia], best_t[ia]
            tmin0, tmax0 = _boxes(tree, c0, o, iv)
            tmin1, tmax1 = _boxes(tree, c1, o, iv)
            hit0 = (tmax0 >= torch.clamp(tmin0, min=0.0)) & (tmin0 < bt)
            hit1 = (tmax1 >= torch.clamp(tmin1, min=0.0)) & (tmin1 < bt)
            swap = tmin1 < tmin0
            near = torch.where(swap, c1, c0)
            far = torch.where(swap, c0, c1)
            hit_near = torch.where(swap, hit1, hit0)
            hit_far = torch.where(swap, hit0, hit1)
            pos = sp[ia]
            stack[ia, torch.clamp(pos, max=STACK - 1)] = torch.where(
                hit_far, far, stack[ia, torch.clamp(pos, max=STACK - 1)])
            pos = pos + hit_far.long()
            stack[ia, torch.clamp(pos, max=STACK - 1)] = torch.where(
                hit_near, near, stack[ia, torch.clamp(pos, max=STACK - 1)])
            sp[ia] = pos + hit_near.long()
        active = active[sp[active] > 0]
    if any_hit:
        return best_tri >= 0
    return best_t, best_tri, best_u, best_v
