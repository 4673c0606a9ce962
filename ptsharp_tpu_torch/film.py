"""Welford film buffer (counterpart of ptsharp_tpu/film.py).

Per-pixel running (count, mean, M2) of radiance samples plus mean
albedo and normal, merged with the Chan parallel formula, so chunks and
passes compose by merges in any order. PNG output is encoded here with
zlib (8-bit RGB, filter 0), so writing an image needs no imaging library.
"""

from __future__ import annotations

import struct
import zlib
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

    def samples_image(self):
        mx = torch.clamp(torch.amax(self.n), min=1.0)
        return (self.n / mx)[..., None].expand(*self.n.shape, 3)

    def albedo_image(self):
        """Albedo over its largest component (Buffer.CalculateAlbedo)."""
        mx = torch.clamp(torch.amax(self.albedo, dim=-1, keepdim=True),
                         min=1e-6)
        return torch.clamp(self.albedo / mx, 0.0, 1.0)

    def normal_image(self):
        return 0.5 * (self.normal + 1.0)


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


def quantize(image01) -> np.ndarray:
    """An (H, W, 3) [0, 1] image (tensor on any device, or array) as
    (H, W, 3) uint8: clip(x * 255 + 0.5, 0, 255), truncated."""
    if isinstance(image01, torch.Tensor):
        image01 = image01.detach().cpu().numpy()
    arr = np.asarray(image01)
    return np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image01) -> bytes:
    """PNG bytes of an (H, W, 3) [0, 1] image: 8-bit RGB, no interlace,
    every scanline filter 0, the pixels of quantize()."""
    arr = quantize(image01)
    h, w, c = arr.shape
    if c != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {arr.shape}")
    raw = np.zeros((h, 1 + 3 * w), np.uint8)  # a filter byte a scanline
    raw[:, 1:] = arr.reshape(h, 3 * w)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def save_png(image01, path: str) -> None:
    """Write an (H, W, 3) [0, 1] image as PNG (encode_png)."""
    data = encode_png(image01)
    with open(path, "wb") as f:
        f.write(data)


def load_png(path: str, linearize: bool = True) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1], linearized by pow 2.2 unless
    `linearize` is false. Pillow is imported here, as in the JAX package:
    no path of a render reads a PNG, and the package needs it nowhere
    else."""
    from PIL import Image

    img = np.asarray(Image.open(path).convert("RGB"),
                     dtype=np.float32) / 255.0
    if linearize:
        img = img**colorlib.GAMMA
    return img
