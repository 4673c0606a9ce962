"""The bfloat16 control of a marched cell on the card, at the cell's own
size: the plain reference (reference/marched.py) in bfloat16 put in the
program's place, compared as a run compares the program
(loops/marched.py), on several seeds.

    python3 perfbench/control_marched.py --workload sdf.final \
        --seeds 1 2 3 [--samples N]

prints one JSON line a seed with the numbers a run compares; N is the
samples a pixel a run's window accumulates. The benchmark's own runs
never run it."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.abspath(sys.path[0]) == os.path.join(ROOT, "perfbench"):
    sys.path[0] = ROOT

import torch  # noqa: E402

from perfbench import run  # noqa: E402
from perfbench.loops import marched  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--samples", type=int, default=24)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("control_marched.py: no card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    spec = run.cell_spec(a.workload)
    conf, traffic = spec["config"], spec["traffic"]
    kw = conf["program"]["kwargs"]
    for seed in a.seeds:
        t0 = time.perf_counter()
        got = marched.control(conf, traffic["check"], seed, a.samples,
                              kw["width"], kw["height"], dev)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "control": "bfloat16", "numbers": got,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
