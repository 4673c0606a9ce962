"""Lockstep ray marches over a wavefront, with no device-side while loop.

The JAX package marches its SDF, volume and heightfield shapes with
`lax.while_loop(cond, body)` (ptsharp_tpu/geometry/sdf.py:313,
volume.py:145): `cond` stops once no lane is active or at the step cap.
torch has no such loop, and asking the host whether any lane is active
after every step would synchronise with the card on each of up to 1,000
(SDF) or ~1,840 (volume) steps.

`march` asks every CHECK_EVERY steps instead, and between two checks runs
the step on the lanes that were active at the last one, gathered to the
front: the rays that miss a shape's box are never marched, and a lane that
has finished costs nothing after the next check. Every march writes a
lane's result only where the lane is active, and a lane never becomes
active again, so a finished lane's result is final: the step run on a
gathered subset gives every lane the bits of the full-width loop, whatever
CHECK_EVERY is (tests/test_torch_shapes.py pins CHECK_EVERY=1 against the
default, bit for bit).

CHECK_EVERY = 8: a check costs one synchronisation and the gather of the
lanes' state (a few launches), against the tens of launches of one step of
an SDF tree or a volume sample, so at 8 the checks add a few percent of a
march's launches, and a march overruns its last active lane by at most 7
steps.

COUNTS[tag] holds [marches, steps, lane steps] for each tag a caller names
(intersect.py: "closest" and "shadow") over every march; reset_counts()
clears them. Each march runs inside the span "pt.march" and each check
inside "pt.march.check" (profiling.span: a torch.profiler range while a
profiler records). While a profiler records, a tagged march also counts
into profiling.march_counters(): its checks, and beside the carried lane
steps the active ones (the lanes still marching at each step), a device
sum that the pass's one read brings back.

`fused` runs a march that one kernel takes to its end (geometry/sdf.py's
sphere trace on a card, kernels/sdf_march.py) under the same span and
counters: it adds its march to COUNTS at once, and its steps (the most a
lane took) and lane steps (the lane slots its warps ran), which only the
card knows, only while a profiler records, through the pass's one read.
"""

from __future__ import annotations

from typing import Callable

import torch

from ptsharp_tpu_torch import profiling

CHECK_EVERY = 8

COUNTS: dict[str, list[int]] = {}
COUNT_FIELDS = ("marches", "steps", "lane steps")


def reset_counts() -> None:
    COUNTS.clear()


def march(step: Callable, lanes: dict, active: torch.Tensor,
          results: tuple, max_steps: int, tag: str | None = None) -> dict:
    """Run `step(lanes, active) -> active` at most `max_steps` times, the
    JAX loop's cap, while some lane is active. `lanes` maps names to
    per-lane tensors (first dimension R) that `step` reads and replaces in
    the dict; it must write a result lane only where `active` is set.
    Returns the `results` lanes over all R lanes."""
    with profiling.span("pt.march"):
        return _march(step, lanes, active, results, max_steps, tag)


def _march(step, lanes, active, results, max_steps, tag):
    every = CHECK_EVERY
    out = {k: lanes[k].clone() for k in results}
    idx = None  # the lanes in `lanes`, as indices into the R lanes
    steps = lane_steps = checks = 0
    # the active masks since the last check, summed at the next one
    counting = tag is not None and torch.autograd._profiler_enabled()
    masks, active_sum = [], 0
    for i in range(max_steps):
        if i % every == 0:
            if masks:
                active_sum = active_sum + torch.stack(masks).sum()
                masks = []
            with profiling.span("pt.march.check"):
                keep = torch.nonzero(active).squeeze(1)
                checks += 1
                for k in results:
                    if idx is None:
                        out[k] = lanes[k].clone()
                    else:
                        out[k][idx] = lanes[k]
                if keep.numel() == 0:
                    idx = keep
                    break
                if keep.numel() < active.shape[0]:
                    lanes = {k: v[keep] for k, v in lanes.items()}
                    active = active[keep]
                    idx = keep if idx is None else idx[keep]
        if counting:
            masks.append(active)
        active = step(lanes, active)
        steps += 1
        lane_steps += active.shape[0]
    else:
        for k in results:
            if idx is None:
                out[k] = lanes[k]
            else:
                out[k][idx] = lanes[k]
    if tag is not None:
        c = COUNTS.setdefault(tag, [0, 0, 0])
        c[0] += 1
        c[1] += steps
        c[2] += lane_steps
    if counting:
        if masks:
            active_sum = active_sum + torch.stack(masks).sum()
        profiling.count_march(tag, steps, checks, lane_steps, active_sum)
    return out


def fused(launch: Callable, tag: str | None, device) -> torch.Tensor:
    """A march that one kernel runs to its end: `launch(counts)` launches
    it and returns its result, with `counts` None, or, while a profiler
    records a tagged march, a zeroed (3,) int64 tensor on `device` to
    which the kernel adds its active lane steps and lane slots and raises
    the most steps a lane took. The launch runs inside "pt.march"; while
    a profiler records, the stream is waited for before the span opens and
    again inside it, so the span holds the kernel alone and nothing
    queued before it. Otherwise nothing waits for the card."""
    recording = torch.autograd._profiler_enabled()
    wait = recording and torch.device(device).type == "cuda"
    counts = None
    if recording and tag is not None:
        counts = torch.zeros(3, dtype=torch.int64, device=device)
    if wait:
        torch.cuda.current_stream(device).synchronize()
    with profiling.span("pt.march"):
        out = launch(counts)
        if wait:
            torch.cuda.current_stream(device).synchronize()
    if tag is not None:
        profiling.tally(COUNTS, tag, COUNT_FIELDS, "marches", 1)
    if counts is not None:
        active, carried, most = counts.unbind()
        profiling.tally(COUNTS, tag, COUNT_FIELDS, "steps", most)
        profiling.tally(COUNTS, tag, COUNT_FIELDS, "lane steps", carried)
        profiling.count_march(tag, most, 0, carried, active)
    return out
