"""The program's spans in a traced run's record: the host intervals of
the ranges that ptsharp_tpu_torch.profiling.span records (names that
begin with "pt."), the interval arithmetic their readers share, and the
traced idle split by innermost span and the lane counters by depth that
chip_spans.py prints. A program without spans leaves no such interval,
and its readers then read nothing."""

from __future__ import annotations

from perfbench import common


def intervals(red: dict, match) -> list:
    """The merged [start, end] (ns) of the host events whose name
    satisfies `match`; nested ones count once (the outermost)."""
    starts, ends, names = red["host"]
    return common.merge((int(starts[i]), int(ends[i]))
                        for i, n in enumerate(names) if match(n))


def named(red: dict, name: str) -> list:
    return intervals(red, lambda n: n == name)


def device_idle(red: dict) -> list:
    """The stretches of the traced window in which no operation ran on
    the device."""
    lo, hi = red["window"]
    return common.gaps([(s, s + d) for _n, s, d, _k, _b in red["ops"]],
                       lo, hi)


def subtract(a: list, b: list) -> list:
    """The parts of the disjoint sorted intervals `a` outside `b`."""
    out = []
    for s, e in a:
        cur = s
        for bs, be in b:
            if be <= cur or bs >= e:
                continue
            if bs > cur:
                out.append((cur, bs))
            cur = max(cur, be)
        if cur < e:
            out.append((cur, e))
    return out


def overlap(a: list, b: list) -> float:
    """The length of the intersection of two lists of disjoint sorted
    intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_inside_ms(red: dict, inside: list) -> float | None:
    """Device-idle ms a traced unit while the host is in `inside`; None
    where the program has no such span or the trace no device
    operation."""
    if not inside or not red["ops"]:
        return None
    return overlap(device_idle(red), inside) / red["units"] / 1e6


def innermost(red: dict) -> dict:
    """{name: [(start, end)]}: the traced window cut into stretches, each
    named by the innermost "pt." span around it ("outside" where none
    is)."""
    lo, hi = red["window"]
    starts, ends, names = red["host"]
    ev = sorted(((int(starts[i]), int(ends[i]), n)
                 for i, n in enumerate(names) if n.startswith("pt.")),
                key=lambda x: (x[0], -x[1]))
    segs, stack, cur = {}, [], lo

    def emit(b, name):
        nonlocal cur
        if b > cur:
            segs.setdefault(name, []).append((cur, b))
            cur = b

    for s, e, n in ev:
        while stack and stack[-1][1] <= s:
            emit(stack[-1][1], stack[-1][2])
            stack.pop()
        emit(s, stack[-1][2] if stack else "outside")
        stack.append((s, e, n))
    while stack:
        emit(stack[-1][1], stack[-1][2])
        stack.pop()
    emit(hi, "outside")
    return segs


def idle_by_span(red: dict) -> dict:
    """Per traced unit: the traced and idle ms, the idle ms by innermost
    span (largest first), and the spans a unit by name."""
    units = red["units"]
    idle = device_idle(red)
    lo, hi = red["window"]
    by = {n: overlap(idle, segs) / units / 1e6
          for n, segs in innermost(red).items()}
    count = {}
    for n in red["host"][2]:
        if n.startswith("pt."):
            count[n] = count.get(n, 0) + 1
    return {"units": units, "traced_ms": (hi - lo) / units / 1e6,
            "idle_ms": sum(b - a for a, b in idle) / units / 1e6,
            "idle_ms_by_innermost_span": dict(
                sorted(by.items(), key=lambda kv: -kv[1])),
            "spans_a_unit": {n: c / units for n, c in sorted(count.items())}}


def lanes_by_depth(counters: dict) -> dict:
    """Per depth of ptsharp_tpu_torch.profiling.counters(): the share of
    the carried lanes that were alive, and where a compaction preceded the
    depth, the share of the alive lanes offered to it that it dropped (a
    depth's alive lanes are the ones its compaction kept)."""
    out = {}
    for d, c in sorted(counters.items()):
        row = {"alive_pct": 100.0 * c["alive"] / c["carried"]
               if c["carried"] else None}
        if c.get("survivors"):
            row["dropped_pct"] = (100.0 * (c["survivors"] - c["alive"])
                                  / c["survivors"])
        out[d] = row
    return out
