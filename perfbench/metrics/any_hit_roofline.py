"""The any_hit kernel's share of its bytes bound, in percent: over the
traced passes' launches of `kernels.traverse.any_hit` (the program's
launch and ray counters), each ray's contract bytes once and the scene's
triangles once a launch, at 3.35 TB/s, over the kernel's device time.
A lower bound on the kernel's work: it leaves out the operations and
every node read."""

import re

from perfbench import common

NAME = re.compile(r"\bany_hit_kernel\b")


def read(rec):
    red = rec.get("trace")
    if not red:
        return None
    launches, rays = red["counts"].get("any_hit", (0, 0))
    ns = sum(d for name, _s, d, _k, _b in red["ops"] if NAME.search(name))
    if not launches or not ns:
        return None
    nbytes = common.query_bytes(rays, launches, rec["triangles"],
                                common.ANY_OUT_BYTES)
    return common.roofline_pct(nbytes, ns * 1e-9)
