"""Device milliseconds a step of the NCCL collectives: the image's and
the gradient's all_reduce."""


def read(rec):
    red = rec.get("trace")
    if not red:
        return None
    ns = sum(d for name, _s, d, _k, _b in red["ops"] if "nccl" in name)
    return ns / red["units"] / 1e6 if ns else None
