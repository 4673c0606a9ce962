"""The marches' share of their operations bound, in percent: the active
lane steps of the traced passes (the program's march counters, as
march_lane_use_pct.render reads them) times the operations of one lane
step of the configuration's SDF tree (march_ops.lane_step_ops), at the
card's float32 peak, over the marches' device time
(march_ops.device_ns). It counts the work any march of the tree does,
so a fused march reads on the same yardstick."""

import sys

from perfbench import common, march_ops


def read(rec):
    red = rec.get("trace")
    if not red or "sdf_tree" not in rec:
        return None
    prof = sys.modules.get("ptsharp_tpu_torch.profiling")
    counters = getattr(prof, "march_counters", None)
    ns = march_ops.device_ns(red)
    if counters is None or not ns:
        return None
    active = sum(m["active"] for m in counters().values())
    if not active:
        return None
    ops = active * march_ops.lane_step_ops(rec["sdf_tree"])
    return 100.0 * (ops / common.PEAK_F32) / (ns * 1e-9)
