"""The share of the lane steps the traced passes' marches carried that
were still marching, in percent: 100 x active / carried lane steps over
every tagged march ("closest", "shadow"), from the program's own
counters (ptsharp_tpu_torch.profiling.march_counters(), which count
only while a profiler records: in a run of run.py, the traced passes
alone). None where the program has no such counter or nothing
marched."""

import sys


def read(rec):
    if not rec.get("trace"):
        return None
    prof = sys.modules.get("ptsharp_tpu_torch.profiling")
    counters = getattr(prof, "march_counters", None)
    if counters is None:
        return None
    c = counters().values()
    carried = sum(m["carried"] for m in c)
    if not carried:
        return None
    return 100.0 * sum(m["active"] for m in c) / carried
