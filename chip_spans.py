"""Where a traced unit's device-idle time goes, by the program's spans.

    python3 chip_spans.py --workload <cell> --seed <n> [--seconds <s>]

runs one cell of BENCHMARK.json as `perfbench/run.py --trace 1` does
(the same loop, its traced passes or steps) and prints its result line,
then one JSON line: per traced unit (pass or step), the traced, busy and
idle milliseconds, and the idle milliseconds by the innermost span of
ptsharp_tpu_torch.profiling (a "pt." range) that the host was in, with
"outside" for the host outside every span; the spans a unit by name;
and for a render, per depth of the traced passes, the share of the
carried lanes that were alive and the share of the lanes offered to a
compaction that it dropped (perfbench/spans.py's idle_by_span and
lanes_by_depth); the draws of core/rng.py by path ("kernel", "plain":
profiling.draws()) and the threefry kernels' launches and words, both a
traced unit; and the host-device syncs a traced unit, counted from the
trace's CUDA runtime calls (SYNC_CALLS, by name; the window's closing
synchronize included). Where the package has no threefry kernel (a tree
from before it, the script copied to that tree's root and run there),
the draws and launches are left out and the rest is counted alike.
The idle is the traced window less the union of the device's
operations, as `device_idle_pct` reads it. Without a card it exits 1, as
run.py does; `--cpu-toy` rehearses at the toy size (no device time).
"""

from __future__ import annotations

import importlib.util
import json
import sys

import perfbench.run as run  # sets the build and kernel caches first
from perfbench import devtrace, spans

# CUDA runtime calls that wait for the card: a pageable copy to or from
# it (cudaMemcpyAsync, then cudaStreamSynchronize), an item read, a
# synchronize
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


def _counting_syncs(reduce, found):
    """devtrace.reduce that first counts the profile's SYNC_CALLS into
    `found`."""

    def counted(prof):
        for e in prof.profiler.kineto_results.events():
            if e.name() in SYNC_CALLS:
                found[e.name()] = found.get(e.name(), 0) + 1
        return reduce(prof)

    return counted


def _counting_draws(fn, found):
    """fn (a render or a train step), adding the threefry wrappers'
    launches and words to `found` while a profiler records."""
    import torch
    from ptsharp_tpu_torch.kernels import threefry

    def total():
        return (sum(w.launches for w in threefry.WRAPPERS),
                sum(w.words for w in threefry.WRAPPERS))

    def counted(*args, **kwargs):
        if not torch.autograd._profiler_enabled():
            return fn(*args, **kwargs)
        before = total()
        out = fn(*args, **kwargs)
        after = total()
        found["launches"] += after[0] - before[0]
        found["words"] += after[1] - before[1]
        return out

    return counted


def _render_hook(found):
    def hook(renderer):
        renderer.render = _counting_draws(renderer.render, found)
        return renderer

    return hook


def main(argv=None) -> int:
    args = run.parse(list(argv if argv is not None else sys.argv[1:])
                     + ["--trace", "1"])
    spec = run.cell_spec(args.workload)
    import torch

    if not args.cpu_toy and not torch.cuda.is_available():
        print("chip_spans.py: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    loop = run.load_module(f"perfbench/loops/{spec['traffic']['loop']}.py",
                           "loop_" + spec["traffic"]["loop"])
    syncs, kernel = {}, {"launches": 0, "words": 0}
    devtrace.reduce = _counting_syncs(devtrace.reduce, syncs)
    draws = importlib.util.find_spec(
        "ptsharp_tpu_torch.kernels.threefry") is not None
    hooks = ({"renderer": _render_hook(kernel),
              "step": lambda step: _counting_draws(step, kernel)}
             if draws else {})
    result = loop.run({"args": args, "spec": spec, "root": run.ROOT,
                       "t_start": run.T_START, "hooks": hooks})
    run.emit(run.result_line(spec, result, True))
    from ptsharp_tpu_torch import profiling

    trace = result["record"]["trace"]
    units = trace["units"]
    out = spans.idle_by_span(trace)
    out["lanes_by_depth"] = spans.lanes_by_depth(profiling.counters())
    if draws:
        out["draws_a_unit"] = {path: n / units
                               for path, n in profiling.draws().items()}
        out["threefry_a_unit"] = {what: n / units
                                  for what, n in kernel.items()}
    out["syncs_a_unit"] = {name: n / units for name, n in syncs.items()}
    out["device"] = result["device"]["kind"]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
