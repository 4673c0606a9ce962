"""The fixed-depth cluster-cull intersector, in plain PyTorch.

Counterpart of ptsharp_tpu/accel/cluster.py. Every ray
  1. slab-tests every cluster box of its instance, (rays x clusters) at
     once, a chunk of rays at a time;
  2. takes the k_cand clusters it enters first;
  3. runs Moller-Trumbore over each candidate's block of 16 leaves;
  4. where more than k_cand clusters were hit and the last candidate was
     entered before the best hit, finishes with the binary skip-link walk
     bounded by that hit (kernels.traverse.closest_hit_binary; the CUDA
     kernel on the card). The walk is launched on every chunk; resolved
     rays enter it with t_max = -INF and leave it at the first node.

Candidates: jax.lax.top_k puts the lower index first among equal scores,
and ties are common (score max(tmin, 0) is 0 for every cluster whose box
holds the ray's origin). torch.topk promises no order among ties, so the
candidates are the first k_cand columns of a stable ascending sort.

Returns (t, slot, u, v): t = INF, slot = -1 on a miss.
"""

from __future__ import annotations

import torch

from ptsharp_tpu_torch.accel.traverse import INF, leaf_intersect, safe_inv
from ptsharp_tpu_torch.kernels import traverse


def _cull_and_intersect(c_bmin, c_bmax, c_rows, tris_per_cluster, org,
                        dirn, t_max, cbase, cend, k_cand):
    """One chunk: (Rc,) rays against clusters [cbase, cend). Returns
    (t, slot, u, v, unresolved)."""
    rc = org.shape[0]
    n_c = c_bmin.shape[0]
    k_cand = min(k_cand, n_c)  # a small scene may hold fewer clusters
    inv_d = safe_inv(dirn)

    def axis_minmax(ax):
        lo = (c_bmin[None, :, ax] - org[:, None, ax]) * inv_d[:, None, ax]
        hi = (c_bmax[None, :, ax] - org[:, None, ax]) * inv_d[:, None, ax]
        return torch.minimum(lo, hi), torch.maximum(lo, hi)

    l0, h0 = axis_minmax(0)
    l1, h1 = axis_minmax(1)
    l2, h2 = axis_minmax(2)
    tmin = torch.maximum(torch.maximum(l0, l1), l2)
    tmax = torch.minimum(torch.minimum(h0, h1), h2)
    ci = torch.arange(n_c, device=org.device)[None, :]
    in_range = (ci >= cbase) & (ci < cend)
    entry = torch.clamp(tmin, min=0.0)
    hit = in_range & (tmax >= entry) & (tmin < t_max[:, None])
    score = torch.where(hit, entry, torch.full_like(entry, INF))
    n_hit = torch.sum(hit, dim=1)
    tk, cand = torch.sort(score, dim=1, stable=True)
    tk, cand = tk[:, :k_cand], cand[:, :k_cand]

    bt = t_max.clone()
    bs = torch.full((rc,), -1, dtype=torch.int32, device=org.device)
    bu = torch.zeros(rc, dtype=torch.float32, device=org.device)
    bv = torch.zeros(rc, dtype=torch.float32, device=org.device)
    for k in range(k_cand):
        # candidates behind the current hit are skipped
        lanes = torch.nonzero(tk[:, k] < bt).squeeze(1)
        if lanes.numel() == 0:
            continue
        c = cand[lanes, k]
        t_lane, lane_best, u_lane, v_lane = leaf_intersect(
            c_rows, c, org[lanes], dirn[lanes], bt[lanes], tris_per_cluster,
            torch.ones_like(lanes, dtype=torch.bool))
        got = t_lane < bt[lanes]
        g = lanes[got]
        bt[g] = t_lane[got]
        bs[g] = (c * tris_per_cluster + lane_best)[got].to(torch.int32)
        bu[g] = u_lane[got]
        bv[g] = v_lane[got]
    # overflow: more than k_cand clusters hit AND the last candidate was
    # entered before the best hit, so a closer triangle could lie beyond
    unresolved = (n_hit > k_cand) & (tk[:, k_cand - 1] < bt)
    return bt, bs, bu, bv, unresolved


def intersect_clustered(scene_arrays, org, dirn, t_max, k_cand: int = 12,
                        chunk: int = 8192):
    """Cluster cull, candidate brute force and the bounded fallback walk.
    scene_arrays = (c_bmin, c_bmax, c_rows, tris_per_cluster, cbase, cend,
    u_rows, leaf_rows, nbase, nend, leaf_size)."""
    (c_bmin, c_bmax, c_rows, tpc, cbase, cend,
     u_rows, leaf_rows, nbase, nend, leaf_size) = scene_arrays
    r = org.shape[0]
    tm = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                            device=org.device), (r,))
    step = chunk if r > chunk else max(r, 1)
    pad = (-r) % step
    if pad:
        # padded rays carry t_max = 0: no cluster and no node is hit
        org = torch.cat([org, torch.zeros((pad, 3), device=org.device)])
        dirn = torch.cat([dirn, torch.ones((pad, 3), device=dirn.device)])
        tm = torch.cat([tm, torch.zeros(pad, device=tm.device)])
    outs = []
    for i in range(0, org.shape[0], step):
        o = org[i:i + step].contiguous()
        d = dirn[i:i + step].contiguous()
        bt, bs, bu, bv, unres = _cull_and_intersect(
            c_bmin, c_bmax, c_rows, tpc, o, d, tm[i:i + step].contiguous(),
            int(cbase), int(cend), k_cand)
        wt, ws, wu, wv = traverse.closest_hit_binary(
            u_rows, leaf_rows, o, d,
            torch.where(unres, bt, torch.full_like(bt, -INF)), nbase, nend,
            leaf_size)
        got = wt < bt
        outs.append((torch.where(got, wt, bt), torch.where(got, ws, bs),
                     torch.where(got, wu, bu), torch.where(got, wv, bv)))
    if not outs:  # no rays
        return tm.clone(), torch.full((0,), -1, dtype=torch.int32,
                                      device=org.device), tm.clone(), \
            tm.clone()
    bt, bs, bu, bv = (torch.cat(x)[:r] for x in zip(*outs))
    bt = torch.where(bs >= 0, bt, torch.full_like(bt, INF))
    return bt, bs, bu, bv
