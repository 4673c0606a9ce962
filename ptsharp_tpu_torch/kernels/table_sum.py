"""Sums of per-lane rows by table row: the wrapper of csrc/table_sum.cu.

  table_sum(ids, rows, m) -> (m, W)

sums the rows (R, W), float32 on a card and any float dtype on the CPU,
by their ids (R,) int32 or int64, clamped into [0, m) as tape._row clamps
them: the scatter-add of the tape backward's per-lane cotangents into a
parameter table (tape._tape_backward) and of the atlas fetches'
cotangents into the texels (textures.TextureAtlas.sample under grad).
For CUDA tensors one launch on the current stream (kernels/build.py
`launch`), which does not wait for the card: a lane whose row is all
zeros adds nothing, the lanes of a warp that share an id add once, and a
table that fits a block's shared memory is summed there first (the
source's note says why). For CPU tensors the plain version, `plain`:
index_add_ into zeros. Any other
device raises ValueError, as do ids, rows or m the kernel does not take:
there is no fallback from the kernel to the plain version.

`table_sum.launches` counts the launches and `table_sum.lanes` their
rows; `reset_launch_counts()` clears them. While a torch profiler
records, the launch also adds its lanes, active lanes (a nonzero entry)
and atomic adds to device memory to the device's counts in
`profiling.table_sum_counters()`.
"""

from __future__ import annotations

import torch

from ptsharp_tpu_torch import profiling
from ptsharp_tpu_torch.kernels import build

# the widest row the kernel takes (csrc/table_sum.cu kMaxW)
MAX_WIDTH = 8


def plain(ids, rows, m: int) -> torch.Tensor:
    """The plain version: index_add_ of the rows into an (m, W) table of
    zeros, ids clamped into [0, m)."""
    out = torch.zeros((m, rows.shape[1]), dtype=rows.dtype, device=rows.device)
    return out.index_add_(0, torch.clamp(ids, 0, m - 1).long(), rows)


def table_sum(ids, rows, m: int) -> torch.Tensor:
    """(m, W) in the rows' dtype: row j the sum of the rows whose clamped
    id is j."""
    if ids.dtype not in (torch.int32, torch.int64) or ids.dim() != 1:
        raise ValueError(f"ids must be an (R,) int32 or int64 tensor, got "
                         f"{ids.dtype} {tuple(ids.shape)}")
    r = ids.shape[0]
    # the kernel sums float32; the plain version any float
    dtype_ok = (rows.dtype == torch.float32
                or rows.dtype.is_floating_point and rows.device.type == "cpu")
    if (not dtype_ok or rows.dim() != 2
            or rows.shape[0] != r or not 1 <= rows.shape[1] <= MAX_WIDTH):
        raise ValueError(f"rows must be an ({r}, W) float tensor (float32 on "
                         f"a card) with W in [1, {MAX_WIDTH}], got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    if not (ids.is_contiguous() and rows.is_contiguous()):
        raise ValueError("ids and rows must be contiguous")
    if m < 1:
        raise ValueError(f"a table of 1 or more rows, got m={m}")
    dev = rows.device
    if ids.device != dev or dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no table sum for devices {ids.device}, {dev}")
    if dev.type == "cpu":
        return plain(ids, rows, m)
    w = rows.shape[1]
    out = torch.zeros((m, w), dtype=torch.float32, device=dev)
    if r:
        counts = profiling.table_sum_counts(dev)
        build.launch(table_sum, "pt_table_sum", dev, ids.data_ptr(),
                     int(ids.dtype == torch.int64), rows.data_ptr(), r, w, m,
                     out.data_ptr(),
                     None if counts is None else counts.data_ptr(), lanes=r)
    return out


table_sum.launches = table_sum.lanes = 0


def reset_launch_counts() -> None:
    table_sum.launches = table_sum.lanes = 0
