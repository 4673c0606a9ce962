#!/usr/bin/env python3
"""The TLAS walk pair (csrc/tlas_walk.cu: closest_hit_tlas, any_hit_tlas)
of the PyTorch/CUDA port on one NVIDIA GPU, alone, so that two trees can
be timed in turns in one call.

    python3 chip_tlas.py [--repo PATH] [--sweep] [--no-dragons]

Run from the repository root on a machine with a CUDA card and nvcc;
`--repo` names another checkout whose ptsharp_tpu_torch to run (an
unpacked parent commit under trees/), with this checkout's chip_smoke.py
phases. It builds that tree's kernels and prints the card's name and
power limit, the build seconds and ptxas's registers, stack frame and
spills of every tlas_walk instance; then chip_smoke.tlas_phase on the
scenes of chip_smoke.py's tlas phase: toybrick at 1920x1080 over its
w_rows (K=4, leaf 4) and over its binary u_rows, cube_field at 1920x1080
and, unless --no-dragons, the four dragon_hd instances at 960x540
through the TLAS (each: every output against the plain version on
every lane, the CUDA-event median of 5 beside the plain version's time
and the bound, and per ray kind the kernel-counted steps, lane use and
time). --sweep adds chip_smoke.tlas_instance_phase (every other
instance; the tree must have traverse.tlas_instance). The last line is
one JSON object: {scene: {wrapper: {max_abs_err, ms, plain_ms, bound_ms,
bound_by}}}.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=REPO)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--no-dragons", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_tlas: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.repo))
    # this checkout's phases, whatever tree the package comes from
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from ptsharp_tpu_torch import examples
    from ptsharp_tpu_torch.kernels import build, traverse

    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    cs.log(smi.stdout.strip().splitlines()[0])
    cs.log(f"tree {os.path.abspath(args.repo)}")
    t0 = time.perf_counter()
    build.load()
    cs.log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, row in sorted(cs.ptxas_report(build.build_info.get(
            "ptxas", "")).items()):
        if name.startswith("tlas_walk"):
            cs.log(f"  ptxas {name}: {row.get('registers')} registers, "
                   f"stack frame {row.get('stack')} B, spill stores "
                   f"{row.get('spill_stores')} B, spill loads "
                   f"{row.get('spill_loads')} B")
    for w in (traverse.closest_hit_tlas, traverse.any_hit_tlas):
        if not hasattr(w, "instance"):  # trees before the instances
            w.instance = "scalar loads, K at run time"

    out = {}
    tb = examples.build("toybrick", width=1920, height=1080, device=device)
    n = 1920 * 1080
    rays = cs.tlas_rays(tb[0], tb[1], 1920, 1080, n, n)
    label = f"toybrick 1080p: {n} camera + {n} bounce"
    out["toybrick"] = cs.tlas_phase(tb[0], rays, label)[0]
    out["toybrick binary"] = cs.tlas_phase(
        cs.replace(tb[0], intersector="walk"), rays,
        f"{label}, binary rows")[0]
    del rays, tb
    cf = examples.build("cube_field", width=1920, height=1080, device=device)
    rays = cs.tlas_rays(cf[0], cf[1], 1920, 1080, n, n)
    out["cube_field"] = cs.tlas_phase(
        cf[0], rays, f"cube_field 1080p: {n} camera + {n} bounce")[0]
    del rays, cf
    if args.sweep:
        cs.tlas_instance_phase(device, f"{cs.TLAS_INSTANCE_RAYS} camera + "
                               f"{cs.TLAS_INSTANCE_RAYS} bounce")
    if not args.no_dragons:
        d4 = cs.four_dragons(examples.dragon_mesh(), device)
        n4 = 960 * 540
        rays = cs.tlas_rays(d4[0], d4[1], 960, 540, n4, n4)
        out["four dragons"] = cs.tlas_phase(
            d4[0], rays, f"four dragons 960x540: {n4} camera + {n4} "
            f"bounce")[0]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
