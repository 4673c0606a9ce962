"""Material model: the reference's 7 archetypes over a flat SoA table.

Counterpart of ptsharp_tpu/materials.py. Shapes carry an int32 material
id; shading gathers per-ray fields from one (M, ...) table of tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch


@dataclass(frozen=True)
class Material:
    """Host-side material description (scene-build time)."""

    color: tuple = (1.0, 1.0, 1.0)
    emittance: float = 0.0
    index: float = 1.0
    gloss: float = 0.0
    tint: float = 0.0
    reflectivity: float = -1.0
    transparent: bool = False
    texture: int = -1
    normal_texture: int = -1
    bump_texture: int = -1
    gloss_texture: int = -1
    bump_multiplier: float = 1.0


def _c3(color) -> tuple:
    arr = np.asarray(color, np.float32).reshape(3)
    return (float(arr[0]), float(arr[1]), float(arr[2]))


def diffuse_material(color) -> Material:
    return Material(color=_c3(color))


def specular_material(color, index: float) -> Material:
    return Material(color=_c3(color), index=index)


def glossy_material(color, index: float, gloss: float) -> Material:
    return Material(color=_c3(color), index=index, gloss=gloss)


def clear_material(index: float, gloss: float) -> Material:
    return Material(color=(0.0, 0.0, 0.0), index=index, gloss=gloss,
                    transparent=True)


def transparent_material(color, index: float, gloss: float,
                         tint: float) -> Material:
    return Material(color=_c3(color), index=index, gloss=gloss, tint=tint,
                    transparent=True)


def metallic_material(color, gloss: float, tint: float) -> Material:
    return Material(color=_c3(color), gloss=gloss, tint=tint, reflectivity=1.0)


def light_material(color, emittance: float) -> Material:
    return Material(color=_c3(color), emittance=emittance)


_FLOAT_FIELDS = ("emittance", "index", "gloss", "tint", "reflectivity",
                 "bump_multiplier")
_INT_FIELDS = ("texture", "normal_texture", "bump_texture", "gloss_texture")


class MaterialTable(NamedTuple):
    """SoA table of all scene materials, one row per material id."""

    color: torch.Tensor        # (M, 3) f32
    emittance: torch.Tensor    # (M,) f32
    index: torch.Tensor
    gloss: torch.Tensor
    tint: torch.Tensor
    reflectivity: torch.Tensor
    transparent: torch.Tensor  # (M,) bool
    texture: torch.Tensor      # (M,) i32
    normal_texture: torch.Tensor
    bump_texture: torch.Tensor
    gloss_texture: torch.Tensor
    bump_multiplier: torch.Tensor

    @staticmethod
    def from_arrays(arrays: dict, device) -> "MaterialTable":
        """From numpy arrays named like the fields."""
        out = {}
        for name in MaterialTable._fields:
            a = np.asarray(arrays[name])
            if name == "transparent":
                a = a.astype(bool)
            elif name in _INT_FIELDS:
                a = a.astype(np.int32)
            else:
                a = a.astype(np.float32)
            out[name] = torch.from_numpy(a).to(device)
        return MaterialTable(**out)

    @staticmethod
    def build(materials: list[Material], device) -> "MaterialTable":
        if not materials:
            materials = [Material()]
        arrays = {name: [getattr(m, name) for m in materials]
                  for name in MaterialTable._fields}
        arrays["color"] = np.asarray(arrays["color"], np.float32)
        return MaterialTable.from_arrays(arrays, device)

    def gather(self, mat_id) -> "MaterialTable":
        """Per-ray material fields for an int id tensor (...,), by
        index_select: its backward is an atomic index_add_, where advanced
        indexing's would sum each material's lanes serially on CUDA."""
        i = torch.clamp(mat_id, 0, self.color.shape[0] - 1).long()
        flat = i.reshape(-1)
        return MaterialTable(*(f.index_select(0, flat)
                               .reshape(i.shape + f.shape[1:]) for f in self))
