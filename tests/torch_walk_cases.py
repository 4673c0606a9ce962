"""The rays and trees that the walk tests and chip_smoke.py share: the
bounce and shadow rays of chip_smoke.py's kernel phases (bounce_rays,
shadow_cut) and the hand-built chains whose stack bound lies in (64, 128]
(stack_chain over STACK_CHAINS). Imports neither jax nor ptsharp_tpu, so
chip_smoke.py runs them on the card."""

import numpy as np
import torch

from ptsharp_tpu_torch.accel.traverse import INF

# (K, chain depth) of the hand-built trees whose stack bound lies in
# (64, 128]
STACK_CHAINS = ((4, 25), (8, 12))


def bounce_rays(scene, org, dirn, n, seed=1):
    """n bounce rays from the hit points of (org, dirn): cosine-weighted
    about the shading normal, in random (scattered) order."""
    from ptsharp_tpu_torch.core import sampling
    from ptsharp_tpu_torch.intersect import closest_hit, hit_info

    hit = closest_hit(scene, org, dirn)
    info = hit_info(scene, org, dirn, hit)
    hit_lanes = torch.nonzero(hit.t < INF).squeeze(1)
    if hit_lanes.numel() == 0:
        raise AssertionError("no camera ray hits the scene")
    g = torch.Generator(device="cpu").manual_seed(seed)
    pick = hit_lanes[torch.randint(0, hit_lanes.numel(), (n,), generator=g)
                     .to(org.device)]
    u1, u2 = torch.rand((2, n), generator=g).to(org.device)
    d = sampling.cosine_hemisphere(info.normal[pick], u1, u2)
    o = info.position[pick] + d * 1e-4
    return o.contiguous(), d.contiguous()


def shadow_cut(scene, org, seed=2):
    """Directions toward the light and t_cut as sample_lights forms them
    (soft-shadow disc sample; analytic light distance less a margin)."""
    from ptsharp_tpu_torch.core import sampling, vec
    from ptsharp_tpu_torch.intersect import light_hit_t

    r = org.shape[0]
    g = torch.Generator(device="cpu").manual_seed(seed)
    lidx = torch.randint(0, scene.num_lights, (r,), generator=g) \
        .to(org.device)
    u1, u2 = torch.rand((2, r), generator=g).to(org.device)
    center = scene.light_center[lidx]
    radius = scene.light_radius[lidx]
    dx, dy = sampling.uniform_disc_area(u1, u2)
    t_ax, b_ax = vec.orthonormal_basis(vec.normalize(center - org))
    point = center + t_ax * (dx * radius)[:, None] + b_ax * (dy * radius)[:, None]
    d = vec.normalize(point - org)
    t_light = light_hit_t(scene, org, d, lidx)
    t_cut = t_light * (1.0 - 1e-3) - 1e-3
    t_cut = torch.where(t_light < INF, t_cut, torch.full_like(t_cut, -INF))
    return d.contiguous(), t_cut.contiguous()


def stack_chain(k: int, depth: int) -> np.ndarray:
    """A fat table of depth+1 K-wide internal nodes in a chain, built by
    hand: node l has K-1 leaf children and, last, node l+1; the last
    node has K leaf children. One triangle a leaf, a plane x = c facing
    rays along +x near the x axis. Every internal box enters at x = 1,
    before its leaf siblings (x >= 1.5), so the ordered walk descends the
    whole chain first and pushes K-1 leaves at each level: (K-1)(depth+1)
    entries. The only triangle before x = 5 (at x = 1.55) sits in the
    nearest leaf of node depth-1, pushed last before the final node,
    beyond a stack of 64; the final node's triangles lie at x >= 5.05,
    the others at x >= 10.05, in leaf boxes that all enter by x = 2.1."""
    n_nodes = k * (depth + 1) + 1
    fat = np.zeros((2 * n_nodes, 128), np.float32)
    bits = fat.view(np.int32)
    inner_box = [1.0, -1.0, -1.0, 100.0, 1.0, 1.0]

    def leaf_x(level, c):
        """(entry x of the leaf's box, x of its triangle)."""
        if level == depth - 1 and c == 0:
            return 1.5, 1.55
        far = 5.0 if level == depth else 10.0 + level
        return 2.0 + 0.01 * c, far + 0.2 * c + 0.05

    n_leaf = 0
    for level in range(depth + 1):
        p = k * level  # this chain node's index
        last = level == depth
        fat[2 * p, 0:6] = inner_box
        bits[2 * p, 8] = n_nodes  # its subtree runs to the end
        for c in range(k):
            j = p + 1 + c  # preorder: the leaves follow their parent
            if c == k - 1 and not last:
                box = inner_box  # the chain's next node, p + k
            else:
                lo, xt = leaf_x(level, c)
                box = [lo, -1.0, -1.0, xt + 0.05, 1.0, 1.0]
                fat[2 * j, 0:6] = box
                bits[2 * j, 6] = n_leaf  # first slot (leaf_size 1)
                bits[2 * j, 7] = 1
                bits[2 * j, 8] = j + 1
                fat[2 * j + 1, 0:9] = [xt, -1, -1, 0, 4, 0, 0, 0, 4]
                n_leaf += 1
            fat[2 * p, 9 + 6 * c:15 + 6 * c] = box
            bits[2 * p, 9 + 6 * k + c] = j
    return fat
