"""Kernel launches a pass, counted in the device trace of the traced
passes (copies and fills left out)."""


def read(rec):
    red = rec.get("trace")
    if not red:
        return None
    n = sum(1 for op in red["ops"] if op[3])
    return n / red["units"] if n else None
