"""Host milliseconds a traced pass inside the program's RNG spans
(`pt.rng.keys`: split and fold_in of the host's keys; `pt.rng.draw`:
issuing the device's draws), the outermost of nested spans counted
once."""

from perfbench import common, spans


def read(rec):
    red = rec.get("trace")
    if not red:
        return None
    rng = spans.intervals(red, lambda n: n.startswith("pt.rng."))
    if not rng:
        return None
    return common.union_length(rng) / red["units"] / 1e6
