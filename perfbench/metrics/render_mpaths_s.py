"""Millions of camera paths (pixel samples) of every pass completed in
the window, over the window's seconds up to the end of the last pass."""


def read(rec):
    if "paths" not in rec:
        return None
    return rec["paths"] / rec["window_s"] / 1e6
