"""Set-up seconds: process start to the window's start (imports, CUDA
start-up, kernel library, scene build, target render, warm-up)."""


def read(rec):
    return rec.get("setup_s")
