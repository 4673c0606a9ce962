"""The nearest-rank 90th percentile over all passes of the window of one
pass's wall time, from dispatch until its sRGB frame is on the host."""

from perfbench import common


def read(rec):
    if not rec.get("pass_s"):
        return None
    return common.percentile(rec["pass_s"], 90) * 1e3
