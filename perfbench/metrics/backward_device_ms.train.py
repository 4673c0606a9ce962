"""Device milliseconds a step of the operations that autograd's backward
launched (the tape's analytic backward, the gradient's sums)."""


def read(rec):
    red = rec.get("trace")
    if not red:
        return None
    ns = sum(d for _n, _s, d, _k, bwd in red["ops"] if bwd)
    return ns / red["units"] / 1e6 if ns else None
