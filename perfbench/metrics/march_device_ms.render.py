"""Device milliseconds a traced pass of the marches: the union of the
device operations' intervals inside the host's `pt.march` spans
(march_ops.device_ns). None where the program has no such span."""

from perfbench import march_ops


def read(rec):
    red = rec.get("trace")
    ns = march_ops.device_ns(red) if red else None
    return ns / red["units"] / 1e6 if ns else None
