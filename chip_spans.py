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
lanes_by_depth).
The idle is the traced window less the union of the device's
operations, as `device_idle_pct` reads it. Without a card it exits 1, as
run.py does; `--cpu-toy` rehearses at the toy size (no device time).
"""

from __future__ import annotations

import json
import sys

import perfbench.run as run  # sets the build and kernel caches first
from perfbench import spans


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
    result = loop.run({"args": args, "spec": spec, "root": run.ROOT,
                       "t_start": run.T_START, "hooks": {}})
    run.emit(run.result_line(spec, result, True))
    from ptsharp_tpu_torch import profiling

    out = spans.idle_by_span(result["record"]["trace"])
    out["lanes_by_depth"] = spans.lanes_by_depth(profiling.counters())
    out["device"] = result["device"]["kind"]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
