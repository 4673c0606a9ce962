"""What the march metrics share: the float32 operations of one step of a
sphere trace, counted from the SDF tree's node kinds by SDF.cs's
formulas (reference/sdf.py states them), and the marches' device time
in a traced run. One operation each: an add, subtract,
multiply, negation, absolute value, min, max, compare, logical op,
select or square root. A step on one lane evaluates the tree once at
o + t d and decides its next t. The count is of the work any march of
the tree does, whatever code runs it."""

from __future__ import annotations

from perfbench import common, spans

# o + t d (3 multiplies, 3 adds); the jump-back test (compare, and), the
# hit test (compare, and, and-not), the hit's t (select), the stride
# (compare, and, select), the next t (subtract, add, select), the jump
# flag (and-not), the exit test and the active flag (compare, 2 and-not)
STEP_OPS = 22
# |p|: 3 multiplies, 2 adds, a square root
LENGTH_OPS = 6
# M^-1 p: 3 rows of 3 multiplies and 3 adds
AFFINE_OPS = 18


def node_ops(node: dict) -> int:
    """The operations of one evaluation of a node and its subtree."""
    kind = node["kind"]
    if kind == "sphere":  # |p| - r
        return LENGTH_OPS + 1
    if kind == "cube":
        # q = |p| - h (6); min(max(q), 0) (3); |max(q, 0)| (3 + 6); add
        return 6 + 3 + 3 + LENGTH_OPS + 1
    if kind == "cylinder":
        # a = sqrt(x^2 + z^2) - r (5); b = |y| - h/2 (2); min(max(a, b), 0)
        # (2); sqrt(max(a, 0)^2 + max(b, 0)^2) (2 + 4); add
        return 5 + 2 + 2 + 6 + 1
    if kind in ("union", "intersection", "difference"):
        items = node["items"]
        join = 2 if kind == "difference" else 1  # max(d, -e): a negation
        return (sum(node_ops(it) for it in items)
                + join * (len(items) - 1))
    if kind == "transform":
        return AFFINE_OPS + node_ops(node["child"])
    raise ValueError(f"no SDF node {kind!r}")


def lane_step_ops(tree: dict) -> int:
    """The operations of one step of one lane: the tree and the step's
    own."""
    return node_ops(tree) + STEP_OPS


def device_ns(red: dict):
    """The nanoseconds of the union of the device operations' intervals
    that lie inside the host's `pt.march` spans (geometry/march.py), or
    None where the program has no such span. A march's checks wait for
    the card every few steps, so its operations run inside its span; the
    tail of the work queued before its first check counts with it."""
    march = spans.named(red, "pt.march")
    if not march or not red["ops"]:
        return None
    busy = common.merge((s, s + d) for _n, s, d, _k, _b in red["ops"])
    return spans.overlap(busy, march)
