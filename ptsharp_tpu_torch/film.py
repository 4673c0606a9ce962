"""Welford film buffer (counterpart of ptsharp_tpu/film.py).

Per-pixel running (count, mean, M2) of radiance samples plus mean
albedo and normal, merged with the Chan parallel formula, so chunks and
passes compose by merges in any order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ptsharp_tpu_torch.core import color as colorlib
from ptsharp_tpu_torch.core import device as devices


class Film(NamedTuple):
    """mean (H, W, 3), m2 (H, W, 3), n (H, W), albedo (H, W, 3),
    normal (H, W, 3)."""

    mean: torch.Tensor
    m2: torch.Tensor
    n: torch.Tensor
    albedo: torch.Tensor
    normal: torch.Tensor

    @staticmethod
    def zeros(height: int, width: int, device=devices.DEFAULT) -> "Film":
        """An empty film on `device`: the card unless "cpu" is asked
        for."""
        device = devices.resolve(device)

        def z(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)

        return Film(mean=z(height, width, 3), m2=z(height, width, 3),
                    n=z(height, width), albedo=z(height, width, 3),
                    normal=z(height, width, 3))

    def add_batch(self, radiance, weight=None, albedo=None,
                  normal=None) -> "Film":
        """Merge S samples per pixel: radiance (S, H, W, 3); weight
        (S, H, W) optionally masks samples (0 = not taken)."""
        if weight is None:
            weight = torch.ones(radiance.shape[:-1], dtype=radiance.dtype,
                                device=radiance.device)
        w3 = weight[..., None]
        nb = torch.sum(weight, dim=0)
        wsum = torch.clamp(nb, min=1e-12)[..., None]
        mb = torch.sum(radiance * w3, dim=0) / wsum
        m2b = torch.sum(w3 * (radiance - mb[None]) ** 2, dim=0)
        n, mean, m2 = _welford_merge(self.n, self.mean, self.m2, nb, mb, m2b)
        new_albedo, new_normal = self.albedo, self.normal
        if albedo is not None:
            ab = torch.sum(albedo * w3, dim=0) / wsum
            new_albedo = _mean_merge(self.n, self.albedo, nb, ab)
        if normal is not None:
            nm = torch.sum(normal * w3, dim=0) / wsum
            new_normal = _mean_merge(self.n, self.normal, nb, nm)
        return Film(mean, m2, n, new_albedo, new_normal)

    def merge(self, other: "Film") -> "Film":
        """Merge two films over the sample axis."""
        n, mean, m2 = _welford_merge(self.n, self.mean, self.m2,
                                     other.n, other.mean, other.m2)
        return Film(mean, m2, n,
                    _mean_merge(self.n, self.albedo, other.n, other.albedo),
                    _mean_merge(self.n, self.normal, other.n, other.normal))

    def variance(self):
        """Per-pixel unbiased sample variance."""
        denom = torch.clamp(self.n - 1.0, min=1.0)[..., None]
        return torch.where((self.n > 1)[..., None], self.m2 / denom, 0.0)

    def stddev(self):
        return torch.sqrt(self.variance())

    def color_srgb(self):
        return colorlib.to_srgb(self.mean)


def _welford_merge(na, ma, m2a, nb, mb, m2b):
    """Chan et al. parallel Welford merge of (count, mean, M2)."""
    n = na + nb
    n_safe = torch.clamp(n, min=1e-12)
    delta = mb - ma
    mean = ma + delta * (nb / n_safe)[..., None]
    m2 = m2a + m2b + delta**2 * (na * nb / n_safe)[..., None]
    zero = n[..., None] <= 0
    return n, torch.where(zero, 0.0, mean), torch.where(zero, 0.0, m2)


def _mean_merge(na, ma, nb, mb):
    n = torch.clamp(na + nb, min=1e-12)
    return ma + (mb - ma) * (nb / n)[..., None]


def save_png(image01, path: str) -> None:
    """Write an (H, W, 3) [0,1] image as PNG. Pillow is imported here, so
    the package itself does not need it."""
    from PIL import Image

    arr = np.asarray(torch.as_tensor(image01).detach().cpu().numpy())
    arr = np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)
    Image.fromarray(arr, mode="RGB").save(path)
