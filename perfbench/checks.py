"""What decides `correct`: the comparisons of the program's output with
the plain reference (perfbench/reference/), at the timed sizes, and the
precision control that each comparison is shown to fail.

Render cells: the film the window accumulated is compared, block by
block, with the reference's own estimate of the same pixels (its own
random numbers, `ref_spp` samples a pixel) by z-scores whose standard
errors come from the reference's per-pixel sample variance; the film's
sample count must equal passes x spp on every pixel.

Train cells: the reference follows the first steps lane by lane from the
same keys (the program traces every lane independently of the others)
and its own colours; it checks the program's target image on a sample of
pixels, then compares each step's loss, the first update's gradient and
the colours' change over the steps, by the worst material (leaf)."""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from perfbench.reference import rng as rrng
from perfbench.reference import scene as rscene
from perfbench.reference import tracer

BATCH = 1 << 21  # lanes the reference traces at once


def run_key(seed: int) -> tuple:
    """The key of a run's seed (any whole number below 2**62)."""
    return rrng.fold_in(rrng.key(seed & 0x7FFFFFFF), seed >> 31)


def port_key(k: tuple) -> torch.Tensor:
    """A key as the program takes it: (2,) int64 of two uint32 words."""
    return torch.tensor([k[0], k[1]], dtype=torch.int64)


def _trace_batches(walker, rays_of, n: int, key, dt):
    out = []
    for a in range(0, n, BATCH):
        lanes = torch.arange(a, min(n, a + BATCH), device=walker.s.v0.device)
        o, d = rays_of(lanes)
        out.append(tracer.trace(walker, o.to(dt), d.to(dt), key, lanes)
                   .float())
    return torch.cat(out)


def block_pixels(seed: int, width: int, height: int, block: int,
                 blocks: int, device):
    """(ys, xs) of `blocks` distinct block x block tiles drawn from the
    seed, tile by tile."""
    gy, gx = height // block, width // block
    pick = np.random.default_rng([seed, 1]).choice(
        gy * gx, size=min(blocks, gy * gx), replace=False)
    oy, ox = np.meshgrid(np.arange(block), np.arange(block), indexing="ij")
    ys = (pick[:, None] // gx) * block + oy.reshape(-1)[None]
    xs = (pick[:, None] % gx) * block + ox.reshape(-1)[None]
    t = torch.as_tensor
    return (t(ys.reshape(-1), device=device), t(xs.reshape(-1), device=device),
            len(pick))


def reference_samples(rs, ys, xs, width, height, spp, key, dt=torch.float32):
    """(spp, P, 3) radiance of `spp` camera paths through each pixel
    (ys, xs), jittered uniformly in the pixel, from `key`."""
    walker = tracer.Walker(rs)
    p = ys.shape[0]
    n = spp * p
    kj, kt = rrng.split(key)

    def rays_of(lanes):
        ju = rrng.uniform_at(kj, lanes).to(dt)
        jv = rrng.uniform_at(kj, lanes + n).to(dt)
        px = lanes % p
        return tracer.camera_rays(rs, xs[px], ys[px], width, height, ju, jv)

    return _trace_batches(walker, rays_of, n, kt, dt).reshape(spp, p, 3)


def render_numbers(prog_px, prog_var, n_prog: int, ref, blocks: int) -> dict:
    """z_max and z_mean of the block means of the program's pixels
    (P, 3), each the mean of n_prog samples of variance prog_var (P, 3),
    against the reference's samples (M, P, 3). A tile's standard error
    takes the larger of the program's and the reference's sample
    variance: the program's estimator may be noisier than the
    reference's (its compaction reweights survivors), never less noisy
    to a check that reads it."""
    m = ref.shape[0]
    ref_px = ref.double().mean(dim=0)
    var_px = ref.double().var(dim=0, unbiased=True)
    per = prog_px.shape[0] // blocks

    def tiles(x):
        return x.double().reshape(blocks, per, 3)

    pb = tiles(prog_px).mean(dim=1)
    rb = tiles(ref_px).mean(dim=1)
    vref = tiles(var_px).sum(dim=1) / (per * per)
    vprog = torch.maximum(tiles(prog_var).sum(dim=1) / (per * per), vref)
    # a tile whose samples all agree (the sky) has no spread: its error
    # is floored at a millionth of its value, a few float32 roundings
    se = torch.maximum(torch.sqrt(vprog / n_prog + vref / m),
                       1e-6 * torch.abs(rb) + 1e-12)
    z = (pb - rb) / se
    signed = float(z.sum()) / math.sqrt(z.numel())
    print(f"run.py: the tiles' signed z_mean {signed:.4f}", file=sys.stderr)
    return {"z_max": float(torch.abs(z).max()), "z_mean": abs(signed)}


def render_check(conf: dict, check: dict, seed: int, film_mean, film_m2,
                 film_n,
                 n_prog: int, width: int, height: int, device,
                 subdivisions=None) -> dict:
    """The numbers of a render cell's comparison (see the module), and
    the scene's triangle count."""
    off = int((film_n != n_prog).sum())
    rs = rscene.build(conf["scene"], device, subdivisions=subdivisions)
    ys, xs, nb = block_pixels(seed, width, height, check["block"],
                              check["blocks"], device)
    ref = reference_samples(rs, ys, xs, width, height, check["ref_spp"],
                            rrng.fold_in(run_key(seed), 0x7EF0))
    prog = film_mean[ys, xs].to(device)
    var = (film_m2[ys, xs] / torch.clamp(film_n[ys, xs] - 1.0, min=1.0)
           [:, None]).to(device)
    out = {"samples_off": float(off)}
    out.update(render_numbers(prog, var, n_prog, ref, nb))
    return out, rs.v0.shape[0]


def render_control(conf: dict, check: dict, seed: int, n_prog: int,
                   width: int, height: int, device, subdivisions=None,
                   dt=torch.bfloat16) -> dict:
    """The render numbers of the reference put in the program's place in
    precision `dt`: n_prog samples a pixel of the same tiles."""
    ys, xs, nb = block_pixels(seed, width, height, check["block"],
                              check["blocks"], device)
    rs_low = rscene.build(conf["scene"], device, subdivisions=subdivisions,
                          dtype=dt)
    low = reference_samples(rs_low, ys, xs, width, height, n_prog,
                            rrng.fold_in(run_key(seed), 0xC0), dt)
    rs = rscene.build(conf["scene"], device, subdivisions=subdivisions)
    ref = reference_samples(rs, ys, xs, width, height, check["ref_spp"],
                            rrng.fold_in(run_key(seed), 0x7EF0))
    out = {"samples_off": 0.0}
    out.update(render_numbers(low.mean(dim=0), low.var(dim=0), n_prog, ref,
                              nb))
    return out


def sharded_pixels(walker, key, ys, xs, width, height, spp, dp, sp,
                   colors=None, dt=torch.float32, only=None):
    """(P, 3) image values at pixels (ys, xs) of a render sharded over a
    dp x sp mesh as the program's parallel/shard.py specifies it: rank
    (i, j) traces spp/sp samples of the rows of block i on the key
    fold_in(fold_in(key, i), j), its lanes numbered sample-major over its
    rows; a pixel is the mean of its samples in each share, the shares
    averaged. Differentiable in `colors`. only=(i, j): rank (i, j)'s
    samples alone, each pixel its share's mean over sp (the other ranks'
    shares held at zero)."""
    rows = height // dp
    per = spp // sp
    n = per * rows * width
    out = 0.0
    for j in range(sp):
        if only is not None and j != only[1]:
            continue
        share = torch.zeros((ys.shape[0], 3), dtype=torch.float32,
                            device=ys.device)
        for i in range(dp):
            if only is not None and i != only[0]:
                continue
            sel = torch.nonzero(ys // rows == i).squeeze(1)
            if sel.numel() == 0:
                continue
            kj, kt = rrng.split(rrng.fold_in(rrng.fold_in(key, i), j))
            base = (ys[sel] - i * rows) * width + xs[sel]
            lanes = (torch.arange(per, device=ys.device)[:, None]
                     * (rows * width) + base[None]).reshape(-1)
            ju = rrng.uniform_at(kj, lanes).to(dt)
            jv = rrng.uniform_at(kj, lanes + n).to(dt)
            o, d = tracer.camera_rays(walker.s, xs[sel].repeat(per),
                                      ys[sel].repeat(per), width, height,
                                      ju, jv)
            rad = tracer.trace(walker, o, d, kt, lanes,
                               None if colors is None else colors.to(dt))
            share = share.index_put((sel,), rad.float().reshape(
                per, -1, 3).mean(dim=0))
        out = out + share
    return out / sp


def _leaf_gap(prog, ref, raw):
    """The worst material's gap between the norms of prog's and ref's
    rows (M, 3), over the larger of its reference norm and the median
    row's; rows whose raw reference gradient is below a thousandth of
    the median row's are left out (their change is round-off alone)."""
    npn = torch.linalg.vector_norm(prog.double(), dim=1)
    nrn = torch.linalg.vector_norm(ref.double(), dim=1)
    graw = torch.linalg.vector_norm(raw.double(), dim=1)
    med_raw = torch.median(graw)
    keep = graw >= 1e-3 * med_raw
    med = torch.median(nrn[keep])
    gap = torch.abs(npn - nrn) / torch.maximum(nrn, med)
    return float(gap[keep].max())


def train_check(conf: dict, traffic: dict, seed: int, c0, target, losses,
                colors, width: int, height: int, device, dp: int = 1,
                sp: int = 1, rank: int = 0, world: int = 1,
                subdivisions=None, dt=torch.float32) -> dict:
    """The numbers of a train cell's comparison (see the module): c0 the
    starting colours (M, 3), target the program's target image, losses
    and colors the program's first steps' losses and colours after each.
    On a multi-rank cell each rank traces its own share of the image's
    rows and the sums are all-reduced over the default group."""
    import torch.distributed as dist

    chk = traffic["check"]
    key = run_key(seed)
    rs = rscene.build(conf["scene"], device, subdivisions=subdivisions,
                      dtype=dt)
    walker = tracer.Walker(rs)
    lr = float(traffic["lr"])
    # the target, on a sample of pixels drawn from the seed
    g = np.random.default_rng([seed, 3, rank])
    per_rank = height // world
    n_t = min(chk["target_pixels"], per_rank * width)
    flat = g.choice(per_rank * width, size=n_t, replace=False)
    ys = torch.as_tensor(rank * per_rank + flat // width, device=device)
    xs = torch.as_tensor(flat % width, device=device)
    with torch.no_grad():
        ref_t = sharded_pixels(walker, rrng.fold_in(key, 0x7A7), ys, xs,
                               width, height, traffic["target_spp"], dp, sp,
                               dt=dt)
    prog_t = target[ys, xs].float().to(device)
    bad = (torch.abs(prog_t - ref_t) > 1e-4 + 1e-3 * torch.abs(ref_t))
    mism = torch.tensor([float(bad.any(dim=1).sum()), float(n_t)],
                        dtype=torch.float64, device=device)
    # the steps
    yy, xx = torch.meshgrid(torch.arange(per_rank, device=device)
                            + rank * per_rank,
                            torch.arange(width, device=device), indexing="ij")
    ys_all, xs_all = yy.reshape(-1), xx.reshape(-1)
    batch = max(1, BATCH // traffic["spp"])
    tgt = target.float().to(device)
    c = c0.clone().to(device)
    ref_losses, ref_colors, raw0 = [], [], None
    for i in range(len(losses)):
        cv = c.clone().requires_grad_()
        sq = torch.zeros((), dtype=torch.float64, device=device)
        grad = torch.zeros_like(c)
        for a in range(0, ys_all.shape[0], batch):
            ys_b, xs_b = ys_all[a:a + batch], xs_all[a:a + batch]
            img = sharded_pixels(walker, rrng.fold_in(key, i), ys_b, xs_b,
                                 width, height, traffic["spp"], dp, sp,
                                 colors=cv, dt=dt)
            part = torch.sum((img - tgt[ys_b, xs_b]) ** 2)
            (gb,) = torch.autograd.grad(part, cv)
            grad += gb.float()
            sq += part.detach().double()
        if world > 1:
            dist.all_reduce(sq)
            dist.all_reduce(grad)
        numel = height * width * 3
        ref_losses.append(float(sq) / numel)
        grad = grad / numel
        if raw0 is None:
            raw0 = grad.clone()
        c = torch.clamp(c - lr * grad, 0.0, 1.0)
        ref_colors.append(c.cpu().clone())
    if world > 1:
        dist.all_reduce(mism)
    c0c = c0.cpu().double()
    out = {"target_mismatch": float(mism[0] / mism[1]),
           "loss_gap": max(abs(p - r) / abs(r)
                           for p, r in zip(losses, ref_losses)),
           "grad_gap": _leaf_gap((c0c - colors[0].double()) / lr,
                                 (c0c - ref_colors[0].double()) / lr,
                                 raw0.cpu()),
           "change_gap": _leaf_gap(colors[-1].double() - c0c,
                                   ref_colors[-1].double() - c0c,
                                   raw0.cpu())}
    return out


def train_control(conf: dict, traffic: dict, seed: int, c0, width: int,
                  height: int, device, subdivisions=None,
                  dt=torch.bfloat16, fault: str | None = None) -> dict:
    """The train numbers of the reference put in the program's place in
    precision `dt` (one rank, the cell's mesh emulated): its target
    pixels, losses and colours over the checked steps, compared by
    train_check with the float32 reference. `fault` plants one of a
    training cell's faults in it instead: "half" (half of the image's
    rows left out, the loss the mean over the rest), "altered" (one colour
    of each step's answer moved by 0.01), "no_exchange" (rank 0's share of
    the gradient alone, the all_reduce left out)."""
    chk = traffic["check"]
    dp, sp = traffic["mesh"]
    key = run_key(seed)
    rs = rscene.build(conf["scene"], device, subdivisions=subdivisions,
                      dtype=dt)
    walker = tracer.Walker(rs)
    lr = float(traffic["lr"])
    yy, xx = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device), indexing="ij")
    ys, xs = yy.reshape(-1), xx.reshape(-1)
    with torch.no_grad():
        low_t = sharded_pixels(walker, rrng.fold_in(key, 0x7A7), ys, xs,
                               width, height, traffic["target_spp"], dp, sp,
                               dt=dt).reshape(height, width, 3)
    rows = height // 2 if fault == "half" else height
    ys, xs = ys[:rows * width], xs[:rows * width]
    numel = rows * width * 3
    c = c0.clone().to(device)
    losses, colors = [], []
    batch = max(1, BATCH // traffic["spp"])
    tgt = low_t.float()
    for i in range(traffic["check_steps"]):
        cv = c.clone().requires_grad_()
        sq, grad = 0.0, torch.zeros_like(c)
        for a in range(0, ys.shape[0], batch):
            yb, xb = ys[a:a + batch], xs[a:a + batch]
            img = sharded_pixels(walker, rrng.fold_in(key, i), yb, xb,
                                 width, height, traffic["spp"], dp, sp,
                                 colors=cv, dt=dt)
            part = torch.sum((img - tgt[yb, xb]) ** 2)
            if fault == "no_exchange":
                # rank 0's graph: its rows and its share of the samples
                own = sharded_pixels(walker, rrng.fold_in(key, i), yb, xb,
                                     width, height, traffic["spp"], dp, sp,
                                     colors=cv, dt=dt, only=(0, 0))
                mask = (yb < height // dp).float()[:, None]
                part_g = torch.sum(2.0 * (img - tgt[yb, xb]).detach() * own
                                   * mask)
            else:
                part_g = part
            if part_g.requires_grad:  # a batch may hold none of rank 0's
                (gb,) = torch.autograd.grad(part_g, cv)
                grad += gb.float()
            sq += float(part.detach())
        losses.append(sq / numel)
        c = torch.clamp(c - lr * grad / numel, 0.0, 1.0)
        if fault == "altered":
            c[1, 0] += 0.01
        colors.append(c.detach().cpu().clone())
    return train_check(conf, dict(traffic, check=dict(
        chk, target_pixels=min(chk["target_pixels"], width * height))),
        seed, c0, tgt, losses, colors, width, height, device, dp, sp,
        subdivisions=subdivisions)
