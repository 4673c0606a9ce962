#!/usr/bin/env python3
"""Where the time of a render goes on one NVIDIA GPU, per mesh intersector
of the PyTorch/CUDA port.

    python3 chip_profile.py [--reps 5] [--repo PATH]

Run from the repository root on a machine with a CUDA card and nvcc;
`--repo` names another checkout whose ptsharp_tpu_torch to profile (an
unpacked parent commit, to compare two commits in one call). For each
render of RENDERS (the main path: "pallas" with the ordered walk, the
bunny at 1920x1080 and dragon_hd at 960x540; the bunny's "pallas" build
with the preorder walk; the bunny's default build, "wide"; and its
"walk" build, the binary walk; then the integrator modes: the "pallas"
bunny under specular "first" with light "all", specular "all" and
closest-hit shadows, toybrick at 1920x1080 through the TLAS,
chip_smoke.lit_bunny's "pallas" and "wide" builds (normal and bump maps,
mesh lights; the "wide" one through the TLAS), examples.veach at
1920x1080, and the marched shapes: examples.sdf (an SDF tree, depth of
field) and examples.volume at 1920x1080; and four scenes of the rest
of the catalog at 1920x1080: dragon (one 81,920-triangle mesh, "wide"),
hits (60 scaled spheres outside a TLAS: one batched test of every ray
against every sphere), craft (173 textured cubes through the TLAS) and
runway (126 sphere lights under light mode "power", the TLAS)),
at 1 spp: one warm-up render; `reps`
unprofiled renders, wall seconds each (host clock, ending in
torch.cuda.synchronize()), in turns across the renders; then one render
under torch.profiler (CPU and CUDA activities), whose device kernels are
summed by kind from key_averages(). Prints per build: rays traced, the
median wall seconds and Mrays/s, the device milliseconds of the profiled
render, the card's idle share at the median wall time (1 - device ms /
median wall ms), device launches, and the device milliseconds of the
traversal kernels (also by kernel instance), collectives, sorts,
gathers and scatters, reductions and the other elementwise kernels (the
classes of perfbench/common.py KINDS), and the device
milliseconds of the kernels launched inside geometry/march.py's
"pt.march" spans (the SDF, volume and heightfield marches, counted in
the kinds too); then one JSON line of the same. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time
from dataclasses import replace

import torch

from perfbench.common import kind_of

REPO = os.path.dirname(os.path.abspath(__file__))
PALLAS = dict(intersector="pallas", wide_k=8)
# render -> (scene: an example's name or "lit_bunny", build, the
# IntegratorConfig fields it changes)
RENDERS = {
    "bunny/pallas": ("bunny", PALLAS, {}),
    "dragon_hd/pallas": ("dragon_hd", PALLAS, {}),
    "bunny/pallas_preorder": ("bunny", dict(PALLAS, pallas_ordered=False),
                              {}),
    "bunny/wide": ("bunny", dict(), {}),  # examples.bunny()'s default build
    "bunny/walk": ("bunny", dict(intersector="walk"), {}),
    "bunny/pallas specular first, light all": (
        "bunny", PALLAS, dict(specular_mode="first", light_mode="all")),
    "bunny/pallas specular all": ("bunny", PALLAS,
                                  dict(specular_mode="all")),
    "bunny/pallas closest-hit shadows": ("bunny", PALLAS,
                                         dict(anyhit_shadows=False)),
    "toybrick/wide": ("toybrick", dict(width=1920, height=1080), {}),
    "lit_bunny/pallas": ("lit_bunny", dict(intersector="pallas"), {}),
    "lit_bunny/wide": ("lit_bunny", dict(intersector="wide"), {}),
    "veach": ("veach", dict(width=1920, height=1080), {}),
    "sdf": ("sdf", dict(width=1920, height=1080), {}),
    "volume": ("volume", dict(width=1920, height=1080), {}),
    "dragon/wide": ("dragon", dict(width=1920, height=1080), {}),
    "hits": ("hits", dict(width=1920, height=1080), {}),
    "craft/wide": ("craft", dict(width=1920, height=1080), {}),
    "runway/wide": ("runway", dict(width=1920, height=1080), {}),
}
def kernel_instance(name: str) -> str:
    """A traversal kernel's name and template arguments, without its
    namespace and parameters."""
    m = re.search(r"(\w+_kernel)(<[^>]*>)?", name)
    return m.group(1) + (m.group(2) or "") if m else name


def device_us(event) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--repo", default=REPO,
                    help="the checkout whose ptsharp_tpu_torch to profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.repo))
    from ptsharp_tpu_torch import examples
    from ptsharp_tpu_torch.core import rng
    from ptsharp_tpu_torch.renderer import Renderer

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    print(f"{card}; ptsharp_tpu_torch from {os.path.abspath(args.repo)}",
          flush=True)
    renderers = {}
    for name, (scene_name, kw, fields) in RENDERS.items():
        if scene_name == "lit_bunny":
            from chip_smoke import lit_bunny

            scene, cam, rcfg, icfg = lit_bunny(device=dev, **kw)
        else:
            scene, cam, rcfg, icfg = examples.build(scene_name, device=dev,
                                                    **kw)
        r = Renderer(scene, cam, replace(rcfg, spp=1),
                     replace(icfg, **fields))
        r.render(key=rng.PRNGKey(0))  # warm-up
        renderers[name] = r
    torch.cuda.synchronize(dev)

    walls = {name: [] for name in RENDERS}
    rays = {}
    for rep in range(args.reps):
        order = list(RENDERS) if rep % 2 == 0 else list(reversed(RENDERS))
        for name in order:
            r = renderers[name]
            before = r.rays_traced
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            r.render(key=rng.PRNGKey(1 + rep))
            torch.cuda.synchronize(dev)
            walls[name].append(time.perf_counter() - t0)
            rays[name] = r.rays_traced - before

    out = {}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for name, r in renderers.items():
        with torch.profiler.profile(activities=acts) as prof:
            r.render(key=rng.PRNGKey(99))
            torch.cuda.synchronize(dev)
        kinds, walks, total, launches, march_us = {}, {}, 0.0, 0, 0.0
        for e in prof.key_averages():
            on_card = str(getattr(e, "device_type", "")).endswith("CUDA")
            if e.key.startswith("pt."):
                # the program's spans (profiling.span): a range on the host
                # sums its kernels' device time; its image on the card's
                # timeline is a span, not a kernel
                if e.key == "pt.march" and not on_card:
                    march_us += float(getattr(e, "device_time_total", 0.0))
                continue
            if on_card:
                us = device_us(e)
                kinds[kind_of(e.key)] = kinds.get(kind_of(e.key), 0.0) + us
                if kind_of(e.key) == "traversal":
                    walk = kernel_instance(e.key)
                    walks[walk] = walks.get(walk, 0.0) + us
                total += us
                launches += int(e.count)
        wall = statistics.median(walls[name])
        res = dict(rays_traced=rays[name], wall_s_median=wall,
                   wall_s=walls[name], mrays_per_s=rays[name] / wall / 1e6,
                   device_ms=total / 1e3,
                   idle_share=1.0 - total / 1e3 / (wall * 1e3),
                   device_launches=launches, march_ms=march_us / 1e3,
                   kind_ms={k: v / 1e3 for k, v in sorted(kinds.items())},
                   traversal_ms={k: v / 1e3 for k, v in sorted(walks.items())})
        out[name] = res
        print(f"{name}: rays={res['rays_traced']} wall_s median="
              f"{wall:.4f} (runs {', '.join(f'{w:.4f}' for w in walls[name])})"
              f" mrays_per_s={res['mrays_per_s']:.3f} device_ms="
              f"{res['device_ms']:.2f} idle_share={res['idle_share']:.3f} "
              f"launches={launches} march_ms={res['march_ms']:.2f} "
              + " ".join(
                  f"{k}={v:.2f}ms" for k, v in res["kind_ms"].items())
              + " (" + ", ".join(f"{k} {v:.3f}ms" for k, v in
                                 res["traversal_ms"].items())
              + f") [{card}]", flush=True)
    print(json.dumps({"card": card, "repo": os.path.abspath(args.repo),
                      "renders": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
