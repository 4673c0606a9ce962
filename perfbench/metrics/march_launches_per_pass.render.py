"""Kernels a traced pass that start on the device inside the host's
`pt.march` spans (copies and fills left out): the marches' launches, as
march_device_ms.render attributes their time. None where the program
has no such span or none started there."""

import bisect

from perfbench import spans


def read(rec):
    red = rec.get("trace")
    if not red:
        return None
    march = spans.named(red, "pt.march")
    if not march:
        return None
    starts = [a for a, _b in march]
    n = 0
    for _n, s, _d, kernel, _b in red["ops"]:
        i = bisect.bisect_right(starts, s) - 1
        n += kernel and i >= 0 and s <= march[i][1]
    return n / red["units"] if n else None
