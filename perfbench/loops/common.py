"""What the loops share: the device, the program's scene from a
configuration, and the trace of a few whole units of the window."""

from __future__ import annotations

import time

import torch


def device_of(ctx, index: int = 0) -> torch.device:
    if ctx["args"].cpu_toy:
        return torch.device("cpu")
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def scene_kwargs(ctx) -> dict:
    """The example's arguments: the configuration's, at its toy size
    under --cpu-toy."""
    prog = ctx["spec"]["config"]["program"]
    kw = dict(prog["kwargs"])
    if ctx["args"].cpu_toy:
        kw.update(prog["toy"])
    return kw


def build_scene(ctx, dev):
    """The program's scene of the configuration and the seconds its build
    took (host mesh and BVH build, upload), ending in a synchronize."""
    from ptsharp_tpu_torch import examples

    prog = ctx["spec"]["config"]["program"]
    t0 = time.perf_counter()
    out = examples.build(prog["example"], device=dev, **scene_kwargs(ctx))
    sync(dev)
    return out, time.perf_counter() - t0


def device_info(dev, count: int = 1) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu (toy rehearsal, not a "
                "measurement)", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


class Tracer:
    """torch.profiler over units [first, first + n) of the window, its
    events kept in memory."""

    def __init__(self, on: bool, first: int, n: int, dev):
        self.on, self.first, self.n, self.dev = on, first, n, dev
        self.prof = None
        self.done = not on

    def before(self, i: int) -> None:
        if self.on and i == self.first:
            from ptsharp_tpu_torch.kernels import traverse

            sync(self.dev)
            traverse.reset_launch_counts()
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()

    def after(self, i: int) -> None:
        """After unit i; returns once the traced units are done."""
        if self.on and not self.done and i + 1 == self.first + self.n:
            from ptsharp_tpu_torch.kernels import traverse

            sync(self.dev)
            self.prof.__exit__(None, None, None)
            self.counts = {w.__name__: (w.launches, w.rays)
                           for w in traverse.WRAPPERS}
            self.done = True

    def reduce(self) -> dict | None:
        if self.prof is None:
            return None
        from perfbench import devtrace

        red = devtrace.reduce(self.prof)
        red["units"] = self.n
        red["counts"] = self.counts
        self.prof = None
        return red
