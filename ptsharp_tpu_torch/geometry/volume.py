"""Windowed iso-surface volume rendering over a scalar voxel grid.

Counterpart of ptsharp_tpu/geometry/volume.py (reference Volume.cs): a
density grid built from image slices, (lo, hi, material) transfer windows,
a fixed-step march with a 64x refinement where the window band changes
(Volume.cs:169-197), gradient normals and nearest-window materials. As
there, the volume's world box maps to grid coordinates correctly (the
reference's sampler computes y from z, Volume.cs:76-78).

The grid is a device tensor of SceneData (`volume_data`), passed to these
functions beside the host VolumeGrid; the coarse march runs in
geometry/march.py's lockstep loop, the refinement over the lanes that
found a crossing, in chunks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ptsharp_tpu_torch.core import vec
from ptsharp_tpu_torch.geometry.march import march

MARCH_STEP = 1.0 / 512.0  # reference step (Volume.cs:171)
REFINE = 64  # refinement subdivisions (Volume.cs:183-193)
REFINE_CHUNK = 1 << 18  # lanes refined at once: 64 points each


@dataclass
class VolumeWindow:
    lo: float
    hi: float
    material_id: int


@dataclass(eq=False)
class VolumeGrid:
    """Host volume description. data is (W, H, D) float32 in [0, 1]; the
    box maps the grid onto world space."""

    data: Any  # (W, H, D) numpy, host copy
    windows: list
    bmin: Any
    bmax: Any

    @staticmethod
    def from_slices(slices: np.ndarray, windows: list, bmin,
                    bmax) -> "VolumeGrid":
        """slices: (D, H, W) stack (CT images, red channel = density,
        Volume.cs:48-71) -> grid indexed [x, y, z]."""
        data = np.ascontiguousarray(np.transpose(slices, (2, 1, 0)),
                                    dtype=np.float32)
        return VolumeGrid(data=data, windows=windows,
                          bmin=np.asarray(bmin, np.float32),
                          bmax=np.asarray(bmax, np.float32))

    def const(self, name: str, value, device) -> torch.Tensor:
        """A host array as a tensor on `device`, made once."""
        cache = self.__dict__.setdefault("_consts", {})
        key = (name, str(device))
        if key not in cache:
            cache[key] = torch.as_tensor(value, device=device)
        return cache[key]

    def box(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """(bmin, bmax) as float32 tensors on `device`, made once."""
        return (self.const("bmin", np.asarray(self.bmin, np.float32), device),
                self.const("bmax", np.asarray(self.bmax, np.float32), device))


def _grid_coords(data, volume: VolumeGrid, p):
    """p's (..., 3) grid coordinates: (p - bmin) / extent * (dims - 1), the
    three axes in one op each."""
    bmin, bmax = volume.box(p.device)
    top = volume.const("top", np.asarray(data.shape, np.float32) - 1,
                       p.device)
    return (p - bmin) / torch.clamp(bmax - bmin, min=1e-12) * top


def sample(data, volume: VolumeGrid, p):
    """Trilinear density at world points p (..., 3) -> (...,); `data` is
    the device grid. Out-of-box coordinates clamp. The eight corners come
    from one gather of the flattened grid, and the lerps run over x, then
    y, then z on all the corners at once: per corner the JAX package's
    arithmetic (ptsharp_tpu/geometry/volume.py:69-102), op for op."""
    dev = p.device
    # the clamp's top, dims - 1.0001, rounded once to float32 as jnp.clip
    # rounds its Python bound
    upper = volume.const("upper", (np.asarray(data.shape, np.float64)
                                   - 1.0001).astype(np.float32), dev)
    q = torch.minimum(torch.clamp(_grid_coords(data, volume, p), min=0.0),
                      upper)
    qf = torch.floor(q)
    f = q - qf
    g = 1 - f
    lo = qf.long()
    hi = torch.minimum(lo + 1, volume.const("last", np.asarray(
        data.shape, np.int64) - 1, dev))
    # flat offsets of each axis's two corners: x * H * D, y * D, z
    stride = volume.const("stride", np.asarray(
        [data.shape[1] * data.shape[2], data.shape[2], 1], np.int64), dev)
    lo, hi = lo * stride, hi * stride
    idx = (torch.stack([lo[..., 0], hi[..., 0]], -1)[..., :, None, None]
           + torch.stack([lo[..., 1], hi[..., 1]], -1)[..., None, :, None]
           + torch.stack([lo[..., 2], hi[..., 2]], -1)[..., None, None, :])
    c = data.reshape(-1)[idx]  # (..., x, y, z)
    c = c[..., 0, :, :] * g[..., 0, None, None] \
        + c[..., 1, :, :] * f[..., 0, None, None]
    c = c[..., 0, :] * g[..., 1, None] + c[..., 1, :] * f[..., 1, None]
    return c[..., 0] * g[..., 2] + c[..., 1] * f[..., 2]


def band_sign(data, volume: VolumeGrid, p):
    """Window-band classification (Volume.Sign, Volume.cs:113-131): 0
    inside some window (a surface), else the index of the gap the sample
    falls in."""
    s = sample(data, volume, p)
    windows = volume.windows
    result = torch.full(s.shape, len(windows) + 1, dtype=torch.int32,
                        device=s.device)
    zero = torch.zeros_like(result)
    # last to first, so earlier windows take precedence
    for i in reversed(range(len(windows))):
        w = windows[i]
        result = torch.where(s < w.lo, torch.full_like(result, i + 1), result)
        result = torch.where((s >= w.lo) & (s <= w.hi), zero, result)
    return result


def intersect(data, volume: VolumeGrid, org, dirn, t_enter, t_exit,
              tag: str | None = None):
    """Fixed-step march (step 1/512) with a 64x refinement once the band
    changes or a window is entered (ptsharp_tpu/geometry/volume.py:134):
    the coarse march records each ray's first band change, capped at the
    box diagonal's steps plus 64, then one refinement pass over
    [cross_t - step, cross_t]. org/dirn (R, 3), unit directions. Returns t
    (R,), INF on a miss. Detached."""
    org, dirn = org.detach(), dirn.detach()
    t_enter, t_exit = t_enter.detach(), t_exit.detach()
    start = torch.clamp(t_enter, min=MARCH_STEP)
    active0 = (t_exit >= t_enter) & (t_exit > 0.0)
    diag = float(np.linalg.norm(np.asarray(volume.bmax)
                                - np.asarray(volume.bmin)))
    max_iters = int(diag / MARCH_STEP) + 64
    t_exit = torch.minimum(t_exit, start + diag)

    def step(lanes, active):
        t = lanes["t"]
        s = band_sign(data, volume, lanes["org"] + lanes["dirn"] * t[:, None])
        prev = lanes["prev_sign"]
        crossed = (s == 0) | ((prev >= 0) & (s != prev))
        hit_now = active & crossed
        lanes["cross_t"] = torch.where(hit_now, t, lanes["cross_t"])
        new_t = t + MARCH_STEP
        active = active & ~hit_now & (new_t <= lanes["t_exit"])
        lanes["t"] = new_t
        lanes["prev_sign"] = torch.where(active, s, prev)
        return active

    lanes = dict(org=org, dirn=dirn, t=start, t_exit=t_exit,
                 prev_sign=torch.full(start.shape, -1, dtype=torch.int32,
                                      device=start.device),
                 cross_t=torch.full_like(start, vec.INF))
    cross_t = march(step, lanes, active0, ("cross_t",), max_iters,
                    tag)["cross_t"]

    # one refinement pass over the lanes that found a crossing; the
    # reference reports the sample just before entry (t - fine_step)
    out = torch.full_like(cross_t, vec.INF)
    found = torch.nonzero(cross_t < vec.INF).squeeze(1)
    fine = MARCH_STEP / REFINE
    ks = fine * (1.0 + torch.arange(REFINE, dtype=torch.float32,
                                    device=org.device))
    for c in range(0, found.numel(), REFINE_CHUNK):
        lane = found[c:c + REFINE_CHUNK]
        t_prev = cross_t[lane] - MARCH_STEP
        ts = t_prev[None, :] + ks[:, None]
        p = org[lane][None] + dirn[lane][None] * ts[..., None]
        is_hit = band_sign(data, volume, p) == 0
        first = torch.argmax(is_hit.to(torch.uint8), dim=0)
        t_hit = t_prev + fine * first.to(torch.float32)
        out[lane] = torch.where(is_hit.any(dim=0), t_hit,
                                torch.full_like(t_hit, vec.INF))
    return out


def normal_at(data, volume: VolumeGrid, p, eps: float = 1e-3):
    """Density-gradient normal (Volume.NormalAt, Volume.cs:138-145): the
    six offset samples as one batch."""
    offs = torch.zeros((6, 3), dtype=p.dtype, device=p.device)
    offs[[0, 2, 4], [0, 1, 2]] = -eps
    offs[[1, 3, 5], [0, 1, 2]] = eps
    s = sample(data, volume, p[None] + offs.reshape(6, *([1] * (p.dim() - 1)),
                                                   3))
    return vec.normalize(torch.stack([s[0] - s[1], s[2] - s[3], s[4] - s[5]],
                                     dim=-1))


def material_at(data, volume: VolumeGrid, p):
    """Nearest-window material id (Volume.MaterialAt,
    Volume.cs:147-167): the containing window wins, the first on
    overlap."""
    s = sample(data, volume, p)
    windows = volume.windows
    best_e = torch.full(s.shape, 1e9, dtype=torch.float32, device=s.device)
    best_m = torch.zeros(s.shape, dtype=torch.int32, device=s.device)
    for w in windows:
        e = torch.minimum(torch.abs(s - w.lo), torch.abs(s - w.hi))
        better = e < best_e
        best_e = torch.where(better, e, best_e)
        best_m = torch.where(better, torch.full_like(best_m, w.material_id),
                             best_m)
    for w in reversed(windows):
        inside = (s >= w.lo) & (s <= w.hi)
        best_m = torch.where(inside, torch.full_like(best_m, w.material_id),
                             best_m)
    return best_m
