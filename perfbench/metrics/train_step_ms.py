"""The window's seconds over the training steps completed in it, in ms."""


def read(rec):
    if not rec.get("steps"):
        return None
    return rec["window_s"] / rec["steps"] * 1e3
