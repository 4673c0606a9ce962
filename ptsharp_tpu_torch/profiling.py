"""Profiling and observability (counterpart of ptsharp_tpu/profiling.py):

  * `span(name)` marks a phase of the program as a torch.profiler range
    while a profiler records, and costs one flag check otherwise. The
    ranges land in the profiler's trace beside the device operations, on
    their clock, each inside the range that encloses it on the host
    thread. The program's spans (every name begins with "pt."):

      pt.pass        Renderer._render_pass
        pt.raygen      the chunk's camera rays and their Morton order
        pt.depth       one depth step of a wavefront (every trace variant)
          pt.hit         the depth's closest hit, sort and scatter back
          pt.occlusion   NEE's shadow query
        pt.compact     _reservoir_compact, before its depth's step
        pt.merge       the chunk's film and its merge into the pass's film
        pt.sync        the pass's one read of the card
      pt.rng.keys    split and fold_in of host keys (Python integers)
      pt.rng.draw    issuing random_bits, uniform, uniform_per_key, randint
                     (uniform and randint: one csrc/threefry.cu launch
                     each on a card)
      pt.step        parallel.shard.make_train_step's step
        pt.forward     the sharded render under grad and the loss
        pt.backward    autograd.grad (the tape's backward inside it)
        pt.update      the SGD update
      pt.march       a march: geometry.march's lockstep loop, or the one
                     launch of an SDF's sphere trace on a card (which
                     waits for the card before the span and inside it at
                     its end, so the span holds the kernel alone)
        pt.march.check  a check: the active lanes' nonzero and gather

  * lane counters: while a profiler records, each depth step of a
    Renderer pass counts its alive lanes and the lanes it carried (its
    width, the cap where a compaction precedes it), and each
    _reservoir_compact the alive lanes offered to it (its survivors;
    those beyond the cap are dropped, so the next step's alive lanes are
    min(survivors, carried)). The alive and survivor counts are sums the
    integrator makes anyway; they stay on the device until the pass's one
    read of the card, which brings them back with the pass's ray count;
    `counters()` gives them per depth, `reset_counters()` clears them.
    With no profiler recording a pass reads its ray count alone, as
    before;
  * march counters: while a profiler records, each tagged march
    ("closest", "shadow") counts its marches, steps, checks and carried
    lane steps and its active lane steps (the sum over its steps of the
    lanes still marching). The lockstep loop's are host ints but the
    active ones, a device sum; a march that one kernel runs (an SDF's on
    a card) counts every one but its checks (0) on the device: its steps
    are the most a lane took, its carried lane steps the lane slots its
    warps ran. A Renderer pass reads the device counts with its ray
    count; a march outside a counted pass reads them itself.
    `march_counters()` gives them per tag, `reset_counters()` clears
    them;
  * draw counter: while a profiler records, core/rng.py counts each draw
    by the path it took, "kernel" (a CUDA device: one csrc/threefry.cu
    launch) or "plain" (the torch block, any other device); `draws()`
    gives them, `reset_counters()` clears them with the lane counters;
  * `trace_to(dir)` runs a block under torch.profiler (CPU and, where
    there is a card, CUDA activities) and writes a Chrome trace into
    `dir` (open it in chrome://tracing or Perfetto);
  * `print_device_memory()` prints each card's allocated and reserved
    memory from torch.cuda.memory_stats.

There is no setting: the spans and counters are on exactly while a torch
profiler records (torch.autograd._profiler_enabled()).
"""

from __future__ import annotations

import contextlib
import os

import torch

_OFF = contextlib.nullcontext()

FIELDS = ("alive", "carried", "survivors")

# depth -> [alive, carried, survivors], summed over the passes
_COUNTERS: dict[int, list[int]] = {}
MARCH_FIELDS = ("marches", "steps", "checks", "carried", "active")
# march tag -> MARCH_FIELDS, summed over the marches
_MARCHES: dict[str, list[int]] = {}
# draws by path (core/rng.py), while a profiler records
PATHS = ("kernel", "plain")
_DRAWS = dict.fromkeys(PATHS, 0)
# the pass being counted; the integrator's depth steps find it here, since
# the trace functions' signatures are the JAX package's
_open: "_Tally | None" = None


def span(name: str):
    """A context: torch.profiler.record_function(name) while a profiler
    records, else one shared no-op context (nothing is built)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def counters() -> dict:
    """{depth: {"alive", "carried", "survivors"}} summed over the
    Renderer passes made while a profiler recorded."""
    return {d: dict(zip(FIELDS, c)) for d, c in sorted(_COUNTERS.items())}


def march_counters() -> dict:
    """{tag: {"marches", "steps", "checks", "carried", "active"}} summed
    over the marches made while a profiler recorded."""
    return {t: dict(zip(MARCH_FIELDS, c))
            for t, c in sorted(_MARCHES.items())}


def reset_counters() -> None:
    _COUNTERS.clear()
    _MARCHES.clear()
    _DRAWS.update(dict.fromkeys(PATHS, 0))


def draws() -> dict:
    """{"kernel", "plain"}: the draws core/rng.py made by each path
    while a profiler recorded."""
    return dict(_DRAWS)


def count_draw(path: str) -> None:
    """Count one draw by `path` ("kernel" or "plain") while a profiler
    records."""
    if torch.autograd._profiler_enabled():
        _DRAWS[path] += 1


def count(depth: int, field: str, n) -> None:
    """Add n (an int, or a 0-d integer tensor, which stays on its device)
    to the open pass's `field` count at `depth`; nothing outside a
    counted pass."""
    if _open is not None:
        _open.items.append((_COUNTERS, depth, FIELDS, field, n))


def tally(table: dict, key, fields: tuple, field: str, n) -> None:
    """Add n to table[key][fields.index(field)] (the row made at first
    use): an int at once; a 0-d integer tensor at the open pass's read,
    with its ray count, or read here outside a counted pass."""
    row = table.setdefault(key, [0] * len(fields))
    if torch.is_tensor(n):
        if _open is not None:
            _open.items.append((table, key, fields, field, n))
            return
        n = int(n)
    row[fields.index(field)] += n


def count_march(tag: str, steps, checks, carried, active) -> None:
    """Add one march's counts under `tag` (geometry/march.py calls it
    while a profiler records); each an int or a 0-d integer tensor, which
    stays on its device until the open pass's read (`tally`): the
    lockstep loop's `active`, and every count but `checks` (0) of a march
    that one kernel runs."""
    tally(_MARCHES, tag, MARCH_FIELDS, "marches", 1)
    for f, n in zip(MARCH_FIELDS[1:], (steps, checks, carried, active)):
        tally(_MARCHES, tag, MARCH_FIELDS, f, n)


class _Tally:
    """One pass's pending counts, read with its ray count."""

    def __init__(self):
        self.items = []

    def read(self, rays: torch.Tensor) -> int:
        """The ray count (a 0-d device tensor) as an int; the pending
        counts come back in the same read and go into the counters."""
        dev = [n for *_k, n in self.items if torch.is_tensor(n)]
        if not dev:
            vals = [int(rays.item())]
        else:
            vals = torch.stack([rays] + [n.to(rays.dtype) for n in dev]) \
                .tolist()
        it = iter(vals[1:])
        for table, key, fields, f, n in self.items:
            row = table.setdefault(key, [0] * len(fields))
            n = next(it) if torch.is_tensor(n) else int(n)
            row[fields.index(f)] += n
        self.items = []
        return vals[0]


@contextlib.contextmanager
def counted_pass():
    """Yields the pass's tally; its depth steps count lanes into it while
    a profiler records."""
    global _open
    tally, outer = _Tally(), _open
    if torch.autograd._profiler_enabled():
        _open = tally
    try:
        yield tally
    finally:
        _open = outer


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
