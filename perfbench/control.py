"""The precision control of a cell on the card, at the cell's own size:
the plain reference in bfloat16 put in the program's place, compared as
a run compares the program (perfbench/checks.py), on several seeds.

    python3 perfbench/control.py --workload <cell> --seeds 1 2 3
        [--samples N]

prints one JSON line a seed with the numbers a run compares. A render
cell's control renders the sampled tiles at N samples a pixel (the
samples a pixel that a run's window accumulates). The benchmark's own
runs never run it."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.abspath(sys.path[0]) == os.path.join(ROOT, "perfbench"):
    sys.path[0] = ROOT

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import checks, run  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--samples", type=int, default=200)
    ap.add_argument("--fault", default=None,
                    help="a train cell's fault planted in the float32 "
                    "reference in the program's place, not the control")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("control.py: no card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    spec = run.cell_spec(a.workload)
    conf, traffic = spec["config"], spec["traffic"]
    kw = conf["program"]["kwargs"]
    w, h = kw["width"], kw["height"]
    for seed in a.seeds:
        t0 = time.perf_counter()
        if traffic["loop"] == "progressive":
            got = checks.render_control(conf, traffic["check"], seed,
                                        a.samples, w, h, dev)
        else:
            pub = np.array([m.get("color", [1.0, 1.0, 1.0])
                            for m in conf["scene"]["materials"]], np.float32)
            lo, hi = traffic["perturb"]
            factor = np.random.default_rng([seed, 2]).uniform(
                lo, hi, size=pub.shape).astype(np.float32)
            c0 = torch.from_numpy(pub) * torch.from_numpy(factor)
            got = checks.train_control(
                conf, traffic, seed, c0, w, h, dev,
                dt=torch.float32 if a.fault else torch.bfloat16,
                fault=a.fault)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "control": a.fault or "bfloat16", "numbers": got,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
