"""Edge-aware a-trous wavelet denoiser (counterpart of
ptsharp_tpu/denoise.py; the reference calls Intel Open Image Denoise,
OIDN.cs:43-95).

A few dilated 5x5 B3-spline passes whose weights combine color, albedo
and normal differences (Dammertz et al. 2010), as plain torch on the
film's device.
"""

from __future__ import annotations

import torch

from ptsharp_tpu_torch.core import vec

# the 1D B3 spline; the 5x5 filter is its outer product
_B3 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def atrous_denoise(color, albedo=None, normal=None, variance=None,
                   iterations: int = 4, sigma_color: float = 0.45,
                   sigma_albedo: float = 0.35, sigma_normal: float = 0.35):
    """color (H, W, 3) linear radiance; optional (H, W, 3) albedo and
    normal guides (variance is accepted and unused, as in the JAX
    package). Returns the filtered (H, W, 3)."""
    out = color
    for it in range(iterations):
        out = _atrous_pass(out, albedo, normal, 1 << it,
                           sigma_color * (2.0**-it), sigma_albedo,
                           sigma_normal)
    return out


def _weight(img, shifted, sigma):
    d = torch.sum((shifted - img) ** 2, dim=-1, keepdim=True)
    return torch.exp(vec.div(-d, sigma * sigma + 1e-8))


def _atrous_pass(color, albedo, normal, step, sc, sa, sn):
    h, w, _ = color.shape
    acc = torch.zeros_like(color)
    wacc = torch.zeros((h, w, 1), dtype=color.dtype, device=color.device)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            k = _B3[dy + 2] * _B3[dx + 2]  # exact in float32
            shifted = _shift2d(color, dy * step, dx * step)
            wgt = torch.full((h, w, 1), k, dtype=color.dtype,
                             device=color.device)
            wgt = wgt * _weight(color, shifted, sc)
            if albedo is not None:
                wgt = wgt * _weight(albedo, _shift2d(albedo, dy * step,
                                                     dx * step), sa)
            if normal is not None:
                wgt = wgt * _weight(normal, _shift2d(normal, dy * step,
                                                     dx * step), sn)
            acc = acc + shifted * wgt
            wacc = wacc + wgt
    return acc / torch.clamp(wacc, min=1e-8)


def _shift2d(img, dy: int, dx: int):
    """Edge-clamped 2D shift (the border replicated)."""
    out = torch.roll(img, (dy, dx), dims=(0, 1))
    if dy > 0:
        out[:dy] = out[dy:dy + 1]
    elif dy < 0:
        out[dy:] = out[dy - 1:dy]
    if dx > 0:
        out[:, :dx] = out[:, dx:dx + 1]
    elif dx < 0:
        out[:, dx:] = out[:, dx - 1:dx]
    return out


def denoise_film(film):
    """Denoise a Film's mean under its albedo and normal guides."""
    return atrous_denoise(film.mean, film.albedo, film.normal,
                          film.variance())
