"""The traced run's reduction of torch.profiler's events (kept in memory)
to what the per-layer readers take: each device operation's name, start
and length, whether autograd's backward launched it, and the host's
operations around the idle gaps."""

from __future__ import annotations

import sys

import numpy as np

from . import common

BACKWARD = "autograd::engine::evaluate_function"
_COPY = ("Memcpy", "Memset", "memcpy", "memset")


def _is_device(e) -> bool:
    return "CUDA" in str(e.device_type()) or "cuda" in str(e.device_type())


def reduce(prof) -> dict:
    """{"ops": [(name, start_ns, dur_ns, is_kernel, in_backward)],
    "window": (lo_ns, hi_ns), "host": (starts, ends, names)} of one
    profile; the window is the span of the host's events."""
    events = prof.profiler.kineto_results.events()
    cpu, runtime, dev = [], {}, []
    for e in events:
        if _is_device(e):
            # a range the host annotated is mirrored on the device's
            # timeline around its kernels: it is no operation of its own
            if not e.is_user_annotation():
                dev.append(e)
            continue
        name = e.name()
        if name.startswith("cuda") and e.correlation_id():
            runtime[e.correlation_id()] = e.start_ns()
        cpu.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
    bwd = common.merge((a, b) for a, b, n in cpu if n.startswith(BACKWARD))
    b_starts = [a for a, _b in bwd]
    ops = []
    matched = 0
    for e in dev:
        name = e.name()
        # the launching runtime call shares the device operation's
        # correlation id (kineto links it one way or the other)
        launch = runtime.get(e.linked_correlation_id(),
                             runtime.get(e.correlation_id()))
        matched += launch is not None
        in_bwd = launch is not None and common.inside(bwd, b_starts, launch)
        ops.append((name, e.start_ns(), e.duration_ns(),
                    not name.startswith(_COPY), in_bwd))
    t0_ns = min(a for a, _b, _n in cpu)
    t1_ns = max(b for _a, b, _n in cpu)
    print(f"trace: {len(dev)} device operations, {matched} matched to "
          f"their launch, {sum(o[4] for o in ops)} under the backward "
          f"({len(bwd)} ranges)", file=sys.stderr)
    host = [(a, b, n) for a, b, n in cpu
            if not n.startswith("cuda") and not n.startswith("Profiler")]
    return {"ops": ops, "window": (t0_ns, t1_ns),
            "host": (np.array([a for a, _b, _n in host], np.int64),
                     np.array([b for _a, b, _n in host], np.int64),
                     [n for _a, _b, n in host])}


def busy_s(red: dict) -> float:
    lo, hi = red["window"]
    iv = [(max(s, lo), min(s + d, hi)) for _n, s, d, _k, _b in red["ops"]
          if s + d > lo and s < hi]
    return common.union_length(iv) * 1e-9


def breakdown(red: dict, top: int = 10) -> dict:
    """The device operations that took most time, summed by name, and the
    longest idle gaps, named by the host operation around each gap's
    start."""
    by_name = {}
    for name, _s, d, _k, _b in red["ops"]:
        by_name[name] = by_name.get(name, 0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    lo, hi = red["window"]
    idle = common.gaps([(s, s + d) for _n, s, d, _k, _b in red["ops"]],
                       lo, hi)
    idle = sorted(idle, key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n[:120], d * 1e-9] for n, d in ops],
            "idle_gaps": [[_host_at(red["host"], a)[:120], (b - a) * 1e-9]
                          for a, b in idle]}


def _host_at(host, t) -> str:
    """The innermost (latest-starting) host operation running at t."""
    starts, ends, names = host
    on = np.nonzero((starts <= t) & (ends >= t))[0]
    if on.size == 0:
        return "no host op"
    return names[int(on[np.argmax(starts[on])])]
