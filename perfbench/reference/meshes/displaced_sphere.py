"""The bunny-class mesh: a displaced, squashed icosphere (81,920
triangles at 6 subdivisions) fitted into a box."""

from __future__ import annotations

from .common import displaced_sphere, fit_inside


def make(subdivisions: int, seed: int, box_min, box_max, anchor):
    v, n, uv = displaced_sphere(subdivisions, seed)
    v, n = fit_inside(v, n, box_min, box_max, anchor)
    return v, n, uv
