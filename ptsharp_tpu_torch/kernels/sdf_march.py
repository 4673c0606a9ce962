"""Sphere traces on the card: the wrapper of csrc/sdf_march.cu.

geometry/sdf.py compiles an Sdf tree into a `Program` (`compile_program`)
and, for rays on a CUDA device, marches them with `march`: one launch on
the current stream runs every ray to its end (persistent warps that take
rays from the stream's ray counter, kernels/build.py `launch`) and
writes each ray's hit t, bit-equal to the plain march (geometry/march.py
over the tree's torch ops), which is this kernel's plain version and the
route of every other device. It does not wait for the card.

A program is postfix: `code` holds (op, constant offset, flags) int32
rows, the op codes OPS in order (csrc/sdf_march.cu's enum Op), and
`consts` the float32 constants the offsets index; `depth` is the most
distances or saved points it holds at once, at most STACK.

`march.launches` counts the launches and `march.rays` their rays;
`reset_launch_counts()` clears them. Inputs of another dtype, shape,
layout or device raise ValueError: there is no fallback from the kernel
to the plain version here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ptsharp_tpu_torch.kernels import build

OPS = ("sphere", "sphere_n", "cube", "cylinder", "capsule", "capsule_n",
       "torus", "union", "intersection", "difference", "affine", "divide",
       "repeat", "pop", "scale")
OP = {name: code for code, name in enumerate(OPS)}
# the distances and saved points a lane holds (csrc/sdf_march.cu kStack)
STACK = 16
# torus flags: its major and minor norms are Euclidean
TORUS_MAJOR_TWO, TORUS_MINOR_TWO = 1, 2


class Program(NamedTuple):
    code: torch.Tensor    # (n_ops, 3) int32
    consts: torch.Tensor  # (n_consts,) float32
    depth: int


def _check(name, x, dtype, shape):
    if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                         f"shape {shape}, got {x.dtype} {tuple(x.shape)}")


def march(prog: Program, org, dirn, t0, t_exit, active, max_steps: int,
          counts=None) -> torch.Tensor:
    """Each ray's hit t (INF where it ends without one), as sphere_trace
    marches it: org, dirn (R, 3) and t0, t_exit (R,) float32, active (R,)
    bool, all contiguous on one CUDA device. `counts`, if given, a (3,)
    int64 tensor there, to which the kernel adds its active lane steps
    and lane slots and raises the most steps a lane took."""
    r = org.shape[0]
    _check("code", prog.code, torch.int32, (prog.code.shape[0], 3))
    _check("consts", prog.consts, torch.float32, (prog.consts.shape[0],))
    for name, x in (("org", org), ("dirn", dirn)):
        _check(name, x, torch.float32, (r, 3))
    for name, x in (("t0", t0), ("t_exit", t_exit)):
        _check(name, x, torch.float32, (r,))
    _check("active", active, torch.bool, (r,))
    if counts is not None:
        _check("counts", counts, torch.int64, (3,))
    if not (prog.code.shape[0] > 0 and 0 < prog.depth <= STACK):
        raise ValueError(f"a program of 1 or more ops and depth at most "
                         f"{STACK}, got {prog.code.shape[0]} ops, depth "
                         f"{prog.depth}")
    if not 0 <= max_steps < 2**31 or r >= 2**31:
        raise ValueError(f"max_steps={max_steps}, {r} rays")
    dev = org.device
    tensors = (prog.code, prog.consts, org, dirn, t0, t_exit, active,
               *(() if counts is None else (counts,)))
    if dev.type != "cuda" or any(x.device != dev for x in tensors):
        raise ValueError(f"no sdf march kernel for devices "
                         f"{sorted({str(x.device) for x in tensors})}")
    out = torch.empty(r, dtype=torch.float32, device=dev)
    if r:
        build.launch(march, "pt_sdf_march", dev, prog.code.data_ptr(),
                     prog.code.shape[0], prog.consts.data_ptr(),
                     org.data_ptr(), dirn.data_ptr(), t0.data_ptr(),
                     t_exit.data_ptr(), active.data_ptr(), r, max_steps,
                     out.data_ptr(), persistent=True, counts=counts, rays=r)
    return out


march.launches = march.rays = 0


def reset_launch_counts() -> None:
    march.launches = march.rays = 0
