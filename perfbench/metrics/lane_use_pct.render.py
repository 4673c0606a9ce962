"""The share of the lanes the traced passes' depth steps carried that
were alive, in percent: 100 x the sum of alive lanes over the sum of
carried lanes (the wavefront's width, after compaction) over every depth,
from the program's own counters (ptsharp_tpu_torch.profiling.counters(),
which count only while a profiler records). The counters are the run's
process's and the harness's tracer does not reset them, so they hold
every Renderer pass made under a profiler in the process: in a run of
run.py, the traced passes alone."""

import sys


def read(rec):
    if not rec.get("trace"):
        return None
    prof = sys.modules.get("ptsharp_tpu_torch.profiling")
    counters = getattr(prof, "counters", None)
    if counters is None:
        return None
    c = counters().values()
    carried = sum(d["carried"] for d in c)
    if not carried:
        return None
    return 100.0 * sum(d["alive"] for d in c) / carried
