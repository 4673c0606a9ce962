"""The marched loop: the progressive loop (Renderer.render pass after pass
on one film, each pass on its own key, each pass's sRGB frame to the
host) over a configuration whose scene the mesh reference does not know:
one SDF tree under a thin-lens camera, checked against
reference/marched.py by checks.py's tile rule. `control` is the bfloat16
control of the same comparison (control_marched.py runs it on a card)."""

from __future__ import annotations

import gc
import sys
import time

import torch

from perfbench import checks, devtrace
from perfbench.loops import common
from perfbench.reference import marched
from perfbench.reference import rng as rrng

REF_KEY, CONTROL_KEY = 0x7EF0, 0xC0


def _reference(conf, check, seed, ys, xs, width, height, device):
    rs = marched.build(conf["scene"], device)
    return marched.samples(rs, ys, xs, width, height, check["ref_spp"],
                           rrng.fold_in(checks.run_key(seed), REF_KEY))


def check_numbers(conf: dict, check: dict, seed: int, film_mean, film_m2,
                  film_n, n_prog: int, width: int, height: int,
                  device) -> dict:
    """samples_off, z_max and z_mean of the film against the reference
    on the seed's tiles (checks.render_check's comparison)."""
    off = int((film_n != n_prog).sum())
    ys, xs, nb = checks.block_pixels(seed, width, height, check["block"],
                                     check["blocks"], device)
    ref = _reference(conf, check, seed, ys, xs, width, height, device)
    prog = film_mean[ys, xs].to(device)
    var = (film_m2[ys, xs] / torch.clamp(film_n[ys, xs] - 1.0, min=1.0)
           [:, None]).to(device)
    out = {"samples_off": float(off)}
    out.update(checks.render_numbers(prog, var, n_prog, ref, nb))
    return out


def control(conf: dict, check: dict, seed: int, n_prog: int, width: int,
            height: int, device, dt=torch.bfloat16) -> dict:
    """The numbers of the reference put in the program's place in
    precision `dt`: n_prog samples a pixel of the same tiles."""
    ys, xs, nb = checks.block_pixels(seed, width, height, check["block"],
                                     check["blocks"], device)
    low = marched.samples(marched.build(conf["scene"], device, dt), ys, xs,
                          width, height, n_prog,
                          rrng.fold_in(checks.run_key(seed), CONTROL_KEY), dt)
    ref = _reference(conf, check, seed, ys, xs, width, height, device)
    out = {"samples_off": 0.0}
    out.update(checks.render_numbers(low.mean(dim=0), low.var(dim=0), n_prog,
                                     ref, nb))
    return out


def run(ctx) -> dict:
    args, spec = ctx["args"], ctx["spec"]
    traffic, conf = spec["traffic"], spec["config"]
    from ptsharp_tpu_torch.film import Film
    from ptsharp_tpu_torch.renderer import Renderer, RenderConfig

    dev = common.device_of(ctx)
    key = checks.run_key(args.seed)
    (scene, cam, _rc, icfg), build_s = common.build_scene(ctx, dev)
    kw = common.scene_kwargs(ctx)
    width, height, spp = kw["width"], kw["height"], traffic["spp"]
    rcfg = RenderConfig(width=width, height=height, spp=spp,
                        max_rays_per_chunk=traffic["max_rays_per_chunk"])
    renderer = Renderer(scene, cam, rcfg, icfg)
    if "renderer" in ctx["hooks"]:
        renderer = ctx["hooks"]["renderer"](renderer)
    # warm-up: one pass of the window's shapes on a key of its own
    warm = renderer.render(Film.zeros(height, width, dev),
                           checks.port_key(rrng.fold_in(key, 0x3FFFFFFF)))
    warm.color_srgb().cpu()
    del warm
    common.sync(dev)

    tracer = common.Tracer(args.trace == 1, 1, traffic["trace_units"], dev)
    film = Film.zeros(height, width, dev)
    pass_s = []
    t0 = time.perf_counter()
    setup_s = time.time() - ctx["t_start"]
    while True:
        i = len(pass_s)
        tracer.before(i)
        a = time.perf_counter()
        film = renderer.render(film, checks.port_key(rrng.fold_in(key, i)))
        film.color_srgb().cpu()
        pass_s.append(time.perf_counter() - a)
        tracer.after(i)
        if time.perf_counter() - t0 >= args.seconds and tracer.done:
            break
    window_s = time.perf_counter() - t0
    info = common.device_info(dev)
    red = tracer.reduce()
    record = {"setup_s": setup_s, "window_s": window_s, "pass_s": pass_s,
              "paths": len(pass_s) * width * height * spp,
              "scene_build_s": build_s, "trace": red,
              "sdf_tree": conf["scene"]["sdf"]["tree"]}
    mean, m2, n = film.mean, film.m2, film.n
    del renderer, scene, film
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    check = dict(traffic["check"], **(traffic["toy_check"] if args.cpu_toy
                                      else {}))
    t_check = time.perf_counter()
    numbers = check_numbers(conf, check, args.seed, mean, m2, n,
                            len(pass_s) * spp, width, height, dev)
    print(f"run.py: the reference check took "
          f"{time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    limits = dict(check["limits"], samples_off=0)
    out = {"attempted": len(pass_s), "failed": 0, "record": record,
           "device": info,
           "checks": {k: {"value": v, "limit": limits[k]}
                      for k, v in numbers.items()}}
    if red is not None:
        record["busy_s"] = devtrace.busy_s(red)
        record["traced_s"] = (red["window"][1] - red["window"][0]) * 1e-9
        out["device"].update(busy_s=record["busy_s"],
                             window_s=record["traced_s"])
        out["breakdown"] = devtrace.breakdown(red)
    return out
