"""Device milliseconds a pass of every operation but the traversal
kernels: the integrator's shading, sampling, RNG, sorts, gathers and the
film's merge."""

from perfbench import common


def read(rec):
    red = rec.get("trace")
    if not red or not red["ops"]:
        return None
    ns = sum(d for name, _s, d, _k, _b in red["ops"]
             if not common.is_traversal(name))
    return ns / red["units"] / 1e6
