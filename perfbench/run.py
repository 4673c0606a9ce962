"""The benchmark of ptsharp_tpu_torch on NVIDIA GPUs.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

runs one cell of BENCHMARK.json from the root of a checkout: it reads
the cell's configuration (perfbench/configs/<config>.json) and traffic
mix (perfbench/traffic/<traffic>.json), runs the mix's loop
(perfbench/loops/<loop>.py) for `--seconds` after its set-up, checks the
loop's output against the plain reference (perfbench/reference/), and
prints one JSON line last: with --trace 0 the cell's end-to-end metrics,
with --trace 1 its per-layer metrics (perfbench/metrics/<metric>.py, each
a reader of the run's record), read from a torch.profiler trace of a few
whole passes or steps. Without a card, or with fewer cards than the cell
asks for, it exits 1 and prints no result. `--cpu-toy` rehearses the
same path on the CPU at the configuration's toy size; its output names
the CPU.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "perfbench")
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path[0] = ROOT
else:
    sys.path.insert(0, ROOT)
# the build and kernel caches a run may write, at fixed paths inside the
# checkout, so that only a cell's first run there compiles
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["USE_FLAX"] = "0"

from perfbench import common  # noqa: E402


def load_json(rel: str) -> dict:
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


def load_module(rel: str, name: str):
    """A module of the benchmark found by its file name (which may hold
    dots, as a metric's name does)."""
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(workload: str) -> dict:
    """The cell's entry, configuration, traffic and metric entries."""
    bench = load_json("BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"run.py: no workload {workload!r} in "
                         f"BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return {"cell": cell, "config": load_json(conf["file"]),
            "traffic": load_json(f"perfbench/traffic/{cell['traffic']}.json"),
            "end_to_end": bench["end_to_end"],
            "per_layer": bench["per_layer"]}


def metrics_of(spec: dict, record: dict, trace: bool) -> dict:
    """Each metric of the cell that its reader finds something to read."""
    name = spec["cell"]["name"]
    out = {}
    for m in spec["per_layer" if trace else "end_to_end"]:
        if name not in m.get("workloads", [name]):
            continue
        reader = load_module(f"perfbench/metrics/{m['name']}.py",
                             "metric_" + m["name"].replace(".", "_"))
        value = reader.read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--cpu-toy", action="store_true",
                    help="rehearse on the CPU at the configuration's toy "
                    "size (never a measurement)")
    # a rank of a multi-card cell, started by the cell's own run.py
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--t-start", type=float, default=None,
                    help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None, hooks=None) -> int:
    """Run one cell; returns the exit code. `hooks` (tests) may replace
    parts of the program under test before the run."""
    args = parse(argv)
    if args.seed < 0 or args.seed >= 2**62:
        raise SystemExit(f"run.py: seed {args.seed} out of range")
    spec = cell_spec(args.workload)
    import torch

    chips = int(spec["cell"]["chips"])
    if not args.cpu_toy:
        if not torch.cuda.is_available():
            print("run.py: torch.cuda.is_available() is false",
                  file=sys.stderr)
            return 1
        if torch.cuda.device_count() < chips:
            print(f"run.py: {args.workload} needs {chips} cards, "
                  f"{torch.cuda.device_count()} found", file=sys.stderr)
            return 1
    loop = load_module(f"perfbench/loops/{spec['traffic']['loop']}.py",
                       "loop_" + spec["traffic"]["loop"])
    ctx = {"args": args, "spec": spec, "root": ROOT,
           "t_start": args.t_start if args.t_start is not None else T_START,
           "hooks": hooks or {}}
    result = loop.run(ctx)
    bad = common.forbidden_modules()
    if bad:
        print(f"run.py: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 1
    if result is None:  # a rank other than 0 of a multi-card cell
        return 0
    # a multi-card cell's launcher passes on the line its rank 0 printed
    line = result.get("line") or result_line(spec, result, args.trace == 1)
    emit(line)
    return 0


def result_line(spec: dict, result: dict, trace: bool) -> dict:
    # a reading that is not finite fails, and prints as a number
    checks = {k: {"value": c["value"] if math.isfinite(c["value"])
                  else sys.float_info.max, "limit": c["limit"]}
              for k, c in result["checks"].items()}
    line = {"correct": all(c["value"] <= c["limit"]
                           for c in checks.values()),
            "attempted": result["attempted"], "failed": result["failed"],
            "metrics": metrics_of(spec, result["record"], trace),
            "device": result["device"]}
    if trace and result.get("breakdown"):
        line["breakdown"] = result["breakdown"]
    line["checks"] = checks
    return line


def emit(line: dict) -> None:
    """Print the checks on standard error, then the result line (the
    checks its last key)."""
    sys.stdout.flush()
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    sys.exit(main())
