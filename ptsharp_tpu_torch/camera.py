"""Look-at thin-lens camera with batched ray generation.

Counterpart of ptsharp_tpu/camera.py: `look_at` builds the basis,
`set_focus` opens a thin lens (depth of field) and `cast_rays` makes a
whole batch of rays at once (Camera.cs:23-35, 98-119).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ptsharp_tpu_torch.core import device as devices
from ptsharp_tpu_torch.core import vec


def _f32(x, device=None):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


class Camera(NamedTuple):
    p: torch.Tensor  # eye position (3,)
    u: torch.Tensor  # right (3,)
    v: torch.Tensor  # up (3,)
    w: torch.Tensor  # forward (3,)
    m: torch.Tensor  # 1 / tan(fovy/2), 0-d
    focal_distance: torch.Tensor
    aperture_radius: torch.Tensor

    @staticmethod
    def look_at(eye, center, up, fovy_deg: float,
                device=devices.DEFAULT) -> "Camera":
        """On `device`: the card unless "cpu" is asked for."""
        device = devices.resolve(device)
        eye = _f32(eye, device)
        center = _f32(center, device)
        up = _f32(up, device)
        w = vec.normalize(center - eye)
        u = vec.normalize(vec.cross(up, w))
        v = vec.normalize(vec.cross(w, u))
        m = 1.0 / math.tan(fovy_deg * math.pi / 360.0)
        return Camera(p=eye, u=u, v=v, w=w, m=_f32(m, device),
                      focal_distance=_f32(0.0, device),
                      aperture_radius=_f32(0.0, device))

    def set_focus(self, focal_point, aperture_radius: float) -> "Camera":
        """Thin lens focused at |focal_point - eye| (Camera.SetFocus):
        cast_rays then spreads origins over the aperture disc."""
        fp = _f32(focal_point, self.p.device)
        return self._replace(
            focal_distance=vec.length(fp - self.p),
            aperture_radius=_f32(aperture_radius, self.p.device))

    def to(self, device) -> "Camera":
        return Camera(*(f.to(device) for f in self))

    def cast_rays(self, x, y, width: int, height: int, jitter_u, jitter_v,
                  lens_u=None, lens_v=None):
        """Rays for pixel coords x, y (matching batch shapes); jitter and
        lens samples in [0,1). Returns (origins, directions), each (..., 3).

          px = ((x + ju - 0.5) / (w-1)) * 2 - 1  (and the same for py)
          d  = normalize(-px*aspect*u - py*v + m*w)
        """
        x = x.to(torch.float32)
        y = y.to(torch.float32)
        aspect = width / float(height)
        px = vec.div(x + jitter_u - 0.5, width - 1.0) * 2.0 - 1.0
        py = vec.div(y + jitter_v - 0.5, height - 1.0) * 2.0 - 1.0
        d = (self.u * (-px * aspect)[..., None]
             + self.v * (-py)[..., None]
             + self.w * self.m)
        d = vec.normalize(d)
        org = torch.broadcast_to(self.p, d.shape)
        if lens_u is not None:
            # thin lens: move the origin on the aperture disc and re-aim at
            # the focal point (angle- and radius-uniform, Camera.cs:108-116)
            angle = lens_u * 2.0 * math.pi
            radius = lens_v * self.aperture_radius
            focal = org + d * self.focal_distance
            offset = (self.u * (vec.cos(angle) * radius)[..., None]
                      + self.v * (vec.sin(angle) * radius)[..., None])
            lens_org = org + offset
            lens_dir = vec.normalize(focal - lens_org)
            use_lens = self.aperture_radius > 0.0
            org = torch.where(use_lens, lens_org, org)
            d = torch.where(use_lens, lens_dir, d)
        return org, d
