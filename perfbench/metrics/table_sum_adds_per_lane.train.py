"""Atomic adds to device memory a lane of the traced steps' table sums:
adds / lanes from the program's own counters
(ptsharp_tpu_torch.profiling.table_sum_counters(): the tape backward's
sums into the parameter tables by csrc/table_sum.cu, each float added
to device memory one add, each row summed one lane; they count only
while a profiler records: in a run of run.py, the traced steps alone).
None where the program has no such counter or summed no lane."""

import sys


def read(rec):
    if not rec.get("trace"):
        return None
    prof = sys.modules.get("ptsharp_tpu_torch.profiling")
    counters = getattr(prof, "table_sum_counters", None)
    if counters is None:
        return None
    c = counters()
    if not c["lanes"]:
        return None
    return c["adds"] / c["lanes"]
