"""The progressive loop: Renderer.render over one film, pass after pass,
each pass on its own key, each pass's sRGB frame brought to the host as a
viewer receives it. The traffic gives the samples a pixel a pass and the
wavefront bound."""

from __future__ import annotations

import gc
import sys
import time

import torch

from perfbench import checks, devtrace
from perfbench.loops import common
from perfbench.reference import rng as rrng


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
              "scene_build_s": build_s, "trace": red}
    mean, m2, n = film.mean, film.m2, film.n
    del renderer, scene, film
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    sub = kw.get("subdivisions") if args.cpu_toy else None
    check = dict(traffic["check"], **(traffic["toy_check"] if args.cpu_toy
                                      else {}))
    t_check = time.perf_counter()
    numbers, record["triangles"] = checks.render_check(
        conf, check, args.seed, mean, m2, n, len(pass_s) * spp, width,
        height, dev, subdivisions=sub)
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
