"""Texture atlas: all scene textures in one padded tensor.

Counterpart of ptsharp_tpu/textures.py: every image is stacked into one
(K, maxH, maxW, 3) atlas with a (K, 2) size table, so a wavefront's
texture lookups are one batched bilinear gather indexed by the per-ray
texture id. Normal and bump maps are read through the same gather, so
texel gradients flow through them too. The host helpers decode an image
file (load_texture, which needs PIL) and adjust an image before it is
registered (pow_texture, mul_texture).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ptsharp_tpu_torch.core import color as colorlib
from ptsharp_tpu_torch.core import vec


class TextureAtlas(NamedTuple):
    data: torch.Tensor   # (K, maxH, maxW, 3) linear RGB, zero-padded
    sizes: torch.Tensor  # (K, 2) int32 (h, w)

    @staticmethod
    def from_arrays(data, sizes, device) -> "TextureAtlas":
        return TextureAtlas(
            data=torch.from_numpy(np.array(data, np.float32)).to(device),
            sizes=torch.from_numpy(np.array(sizes, np.int32)).to(device))

    @staticmethod
    def empty(device) -> "TextureAtlas":
        """The (1, 1, 1, 3) atlas of a scene without textures."""
        return TextureAtlas.from_arrays(np.zeros((1, 1, 1, 3)),
                                        np.ones((1, 2)), device)

    @staticmethod
    def build(images: list[np.ndarray], device) -> "TextureAtlas":
        """images: list of (H, W, 3) float32 arrays already in linear space."""
        if not images:
            return TextureAtlas.empty(device)
        mh = max(im.shape[0] for im in images)
        mw = max(im.shape[1] for im in images)
        data = np.zeros((len(images), mh, mw, 3), np.float32)
        sizes = np.zeros((len(images), 2), np.int32)
        for i, im in enumerate(images):
            h, w = im.shape[:2]
            data[i, :h, :w] = im
            sizes[i] = (h, w)
        return TextureAtlas.from_arrays(data, sizes, device)

    @property
    def nontrivial(self) -> bool:
        """The atlas holds real texels (a (1,1,1,3) empty atlas never
        samples)."""
        return self.data.shape[1] > 1 or self.data.shape[0] > 1

    def sample(self, tex_id, u, v):
        """Bilinear wrap sample -> (..., 3); ids < 0 return texture 0
        (callers select against a fallback)."""
        tid = torch.clamp(tex_id, 0, self.data.shape[0] - 1).long()
        hi = self.sizes[tid, 0].long()
        wi = self.sizes[tid, 1].long()
        h = hi.float()
        w = wi.float()
        # wrap to [0,1), v flipped like the reference sampler
        uu = torch.remainder(u, 1.0) * (w - 1.0)
        vv = (1.0 - torch.remainder(v, 1.0)) * (h - 1.0)
        x0 = torch.floor(uu).long()
        y0 = torch.floor(vv).long()
        fx = (uu - x0)[..., None]
        fy = (vv - y0)[..., None]
        x1 = torch.where(x0 + 1 >= wi, 0, x0 + 1)
        y1 = torch.where(y0 + 1 >= hi, 0, y0 + 1)
        # index_select, whose backward is an atomic index_add_: the
        # backward of advanced indexing on CUDA sorts the indices and sums
        # each run of equal ones serially, and a wavefront's lanes pile
        # onto a few texels (every untextured lane reads texel 0)
        texels = self.data.reshape(-1, 3)
        mh, mw = self.data.shape[1], self.data.shape[2]

        def fetch(y, x):
            idx = (tid * mh + y) * mw + x
            return texels.index_select(0, idx.reshape(-1)) \
                .reshape(idx.shape + (3,))

        c00 = fetch(y0, x0)
        c01 = fetch(y0, x1)
        c10 = fetch(y1, x0)
        c11 = fetch(y1, x1)
        c0 = c00 * (1 - fx) + c01 * fx
        c1 = c10 * (1 - fx) + c11 * fx
        return c0 * (1 - fy) + c1 * fy

    def normal_sample(self, tex_id, u, v):
        """RGB -> [-1, 1] tangent-space normal."""
        return self.sample(tex_id, u, v) * 2.0 - 1.0

    def bump_sample(self, tex_id, u, v):
        """Central-difference luminance gradient, one texel in u and in v
        -> (..., 2) (du, dv)."""
        tid = torch.clamp(tex_id, 0, self.data.shape[0] - 1).long()
        w = self.sizes[tid, 1].float()
        h = self.sizes[tid, 0].float()
        du = 1.0 / torch.clamp(w, min=1.0)
        dv = 1.0 / torch.clamp(h, min=1.0)

        def lum(c):
            return vec.div(vec.sum_last(c), 3.0)

        gx = lum(self.sample(tex_id, u + du, v)) \
            - lum(self.sample(tex_id, u - du, v))
        gy = lum(self.sample(tex_id, u, v + dv)) \
            - lum(self.sample(tex_id, u, v - dv))
        return torch.stack([gx, gy], dim=-1)


def load_texture(path: str) -> np.ndarray:
    """Decode and linearize an image file (host) -> (H, W, 3) float32.
    Needs PIL: without it this raises ImportError."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"load_texture({path!r}) needs PIL (Pillow) to "
                          f"decode the image") from e
    img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    return img**colorlib.GAMMA


def pow_texture(image: np.ndarray, exponent: float) -> np.ndarray:
    """Per-texel power before registration (ITexture.Pow,
    Texture.cs:170-178): adjust the host image, then pass it to
    SceneBuilder.add_texture."""
    return np.power(np.asarray(image, np.float32), exponent)


def mul_texture(image: np.ndarray, scalar: float) -> np.ndarray:
    """Per-texel scale (ITexture.MulScalar, Texture.cs:180-186)."""
    return np.asarray(image, np.float32) * scalar
