"""The benchmark's yardstick: the peaks of the card, the bytes a query
moves, the classes of kernel names, the statistics over the window, the
reduction of a profiler trace to device intervals, and the checks that
guard every run. Nothing here imports the program."""

from __future__ import annotations

import bisect
import math
import sys

# NVIDIA H100 SXM, 700 W (data sheet): float32 outside the tensor cores,
# and HBM3 bandwidth
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# the rays' contract bytes of a query: origin and direction (24 B) and
# t_max (4 B) in; t, slot, u, v (16 B) out of a closest hit; one byte out
# of an any hit; a triangle's three float32 corners
RAY_BYTES = 28
CLOSEST_OUT_BYTES = 16
ANY_OUT_BYTES = 1
TRIANGLE_BYTES = 36

# kernel-name fragments -> class; the first match wins
KINDS = (("traversal", ("closest_hit", "any_hit", "tlas_walk")),
         ("collective", ("nccl",)),
         ("sort", ("sort", "radix", "Sort")),
         ("gather/scatter", ("index", "gather", "scatter", "Index")),
         ("reduction", ("reduce", "Reduce")))

FORBIDDEN = ("jax", "jaxlib", "flax", "ptsharp_tpu")


def kind_of(name: str) -> str:
    for kind, frags in KINDS:
        if any(f in name for f in frags):
            return kind
    return "elementwise/other"


def is_traversal(name: str) -> bool:
    return kind_of(name) == "traversal"


def query_bytes(rays: int, launches: int, triangles: int,
                out_bytes: int) -> int:
    """The least bytes a set of launches of one query moves: each ray's
    contract bytes once, and the scene's triangles once a launch."""
    return rays * (RAY_BYTES + out_bytes) + launches * triangles \
        * TRIANGLE_BYTES


def roofline_pct(nbytes: float, device_s: float) -> float | None:
    """The share of the bytes bound, (bytes / peak bandwidth) / device
    seconds, in percent; None where nothing ran."""
    if device_s <= 0 or nbytes <= 0:
        return None
    return 100.0 * (nbytes / PEAK_BYTES) / device_s


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile of all values (0 < q <= 100)."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def union_length(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def gaps(intervals, lo: float, hi: float):
    """The idle stretches (start, end) of [lo, hi] outside the union of
    the intervals."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def merge(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint ones."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def inside(merged: list, starts: list, t: float) -> bool:
    """Whether t lies in one of the merged intervals (starts: theirs)."""
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and merged[i][1] >= t
