"""Profiling and observability (counterpart of ptsharp_tpu/profiling.py):

  * `trace_to(dir)` runs a block under torch.profiler (CPU and, where
    there is a card, CUDA activities) and writes a Chrome trace into
    `dir` (open it in chrome://tracing or Perfetto);
  * `RenderStats` adds up rays and pass times into Mrays/s;
  * `print_device_memory()` prints each card's allocated and reserved
    memory from torch.cuda.memory_stats.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Profile the block; its Chrome trace goes to
    `log_dir`/trace_<pid>_<n>.json. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    n = len([f for f in os.listdir(log_dir) if f.startswith("trace_")])
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{n}.json"))


@dataclass
class RenderStats:
    rays: int = 0
    seconds: float = 0.0
    passes: int = 0
    history: list = field(default_factory=list)

    @contextlib.contextmanager
    def timed_pass(self):
        t0 = time.time()
        yield
        dt = time.time() - t0
        self.seconds += dt
        self.passes += 1
        self.history.append(dt)

    def add_rays(self, n: int):
        self.rays += int(n)

    @property
    def mrays_per_sec(self) -> float:
        return self.rays / max(self.seconds, 1e-9) / 1e6

    def summary(self) -> str:
        return (f"{self.rays:,} rays in {self.seconds:.2f}s over "
                f"{self.passes} passes = {self.mrays_per_sec:.1f} Mrays/s")


def print_device_memory() -> None:
    """One line a card: MiB allocated and reserved (peak allocated in
    brackets) over its total memory."""
    if not torch.cuda.is_available():
        print("no CUDA device")
        return
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        mib = 2**20
        total = torch.cuda.get_device_properties(i).total_memory / mib
        print(f"cuda:{i} {torch.cuda.get_device_name(i)}: "
              f"{stats.get('allocated_bytes.all.current', 0) / mib:.1f} MiB "
              f"allocated ({stats.get('allocated_bytes.all.peak', 0) / mib:.1f}"
              f" peak), {stats.get('reserved_bytes.all.current', 0) / mib:.1f}"
              f" MiB reserved / {total:.1f} MiB")
