"""A configuration's scene as the reference's tensors, rebuilt from the
description in the configuration file: one triangle mesh (a procedural
kind from meshes/), infinite planes, spheres (an emissive one is a
light), a flat environment colour, textures (a kind from textures/), the
material table and a look-at pinhole camera."""

from __future__ import annotations

import importlib
import math
from dataclasses import dataclass

import numpy as np
import torch

MATERIAL_DEFAULTS = dict(color=(1.0, 1.0, 1.0), emittance=0.0, index=1.0,
                         gloss=0.0, tint=0.0, reflectivity=-1.0,
                         transparent=False, texture=-1)


@dataclass
class Scene:
    v0: torch.Tensor        # (T, 3) triangle corner 0
    e1: torch.Tensor        # (T, 3) v1 - v0
    e2: torch.Tensor        # (T, 3) v2 - v0
    n: torch.Tensor         # (T, 3, 3) vertex normals
    uv: torch.Tensor        # (T, 3, 2) texture coordinates
    mesh_material: int
    plane_point: torch.Tensor   # (P, 3)
    plane_normal: torch.Tensor  # (P, 3)
    plane_material: torch.Tensor  # (P,) int64
    sphere_center: torch.Tensor   # (S, 3)
    sphere_radius: torch.Tensor   # (S,)
    sphere_material: torch.Tensor  # (S,) int64
    light_sphere: int           # the index of the one emissive sphere
    materials: dict             # name -> (M,) or (M, 3) tensor
    texture: torch.Tensor       # (K, H, W, 3)
    texture_size: tuple         # (H, W) of each texture (all alike)
    env: torch.Tensor           # (3,)
    eye: torch.Tensor
    cu: torch.Tensor            # camera right, up, forward
    cv: torch.Tensor
    cw: torch.Tensor
    m: float                    # 1 / tan(fovy / 2)
    max_bounces: int


def _by_name(package: str, kind: str):
    return importlib.import_module(f"{__package__}.{package}.{kind}")


def _normalize(a):
    return a / np.linalg.norm(a)


def mesh_arrays(desc: dict, subdivisions: int | None = None):
    """The mesh of a scene description as float32 NumPy (v, n, uv)."""
    params = dict(desc["mesh"])
    kind = params.pop("kind")
    params.pop("material")
    if subdivisions is not None:
        params["subdivisions"] = subdivisions
    return _by_name("meshes", kind).make(**params)


def build(desc: dict, device, subdivisions: int | None = None,
          dtype=torch.float32) -> Scene:
    """The scene of `desc` on `device`; `subdivisions` overrides the
    mesh's (the CPU rehearsal's toy size); `dtype` is the precision of
    every float table (float32, or bfloat16 for the control)."""
    v, n, uv = mesh_arrays(desc, subdivisions)

    def f(x):
        return torch.as_tensor(np.asarray(x, np.float32),
                               device=device).to(dtype)

    def i64(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=device)

    mats = [dict(MATERIAL_DEFAULTS, **m) for m in desc["materials"]]
    materials = {k: f([m[k] for m in mats]) for k in
                 ("color", "emittance", "index", "gloss", "tint",
                  "reflectivity")}
    materials["transparent"] = torch.as_tensor(
        [bool(m["transparent"]) for m in mats], device=device)
    materials["texture"] = i64([m["texture"] for m in mats])
    textures = []
    for t in desc["textures"]:
        params = dict(t)
        textures.append(_by_name("textures", params.pop("kind"))
                        .make(**params))
    if len({t.shape for t in textures}) > 1:
        raise ValueError("the reference samples textures of one size")
    planes = desc["planes"]
    spheres = desc["spheres"]
    lights = [i for i, s in enumerate(spheres)
              if mats[s["material"]]["emittance"] > 0]
    if len(lights) != 1:
        raise ValueError("the reference samples exactly one sphere light")
    pn = [_normalize(np.asarray(p["normal"], np.float32)) for p in planes]
    cam = desc["camera"]
    eye = np.asarray(cam["eye"], np.float32)
    return Scene(
        v0=f(v[:, 0]), e1=f(v[:, 1] - v[:, 0]), e2=f(v[:, 2] - v[:, 0]),
        n=f(n), uv=f(uv), mesh_material=int(desc["mesh"]["material"]),
        plane_point=f([p["point"] for p in planes]),
        plane_normal=f(pn),
        plane_material=i64([p["material"] for p in planes]),
        sphere_center=f([s["center"] for s in spheres]),
        sphere_radius=f([s["radius"] for s in spheres]),
        sphere_material=i64([s["material"] for s in spheres]),
        light_sphere=lights[0], materials=materials,
        texture=f(np.stack(textures)) if textures else f(np.zeros((1, 1, 1, 3))),
        texture_size=textures[0].shape[:2] if textures else (1, 1),
        env=f(desc["environment"]),
        eye=torch.as_tensor(eye, device=device),
        **_camera_basis(cam, device),
        m=1.0 / math.tan(cam["fovy"] * math.pi / 360.0),
        max_bounces=int(desc["max_bounces"]))


def _camera_basis(cam: dict, device) -> dict:
    """The look-at basis in float32, as the camera of the configuration
    states it: w forward, u = up x w, v = w x u, each normalised."""
    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    def unit(a):
        s = (a[0] * a[0] + a[1] * a[1]) + a[2] * a[2]
        return a * (1.0 / torch.sqrt(s.double()).float())

    def cross(a, b):
        # each component a_i b_k - a_k b_i with one rounding
        i, k = [1, 2, 0], [2, 0, 1]
        return (a[i].double() * b[k].double()
                - (a[k] * b[i]).double()).float()

    eye, center, up = t(cam["eye"]), t(cam["center"]), t(cam["up"])
    w = unit(center - eye)
    u = unit(cross(up, w))
    v = unit(cross(w, u))
    return dict(cu=u, cv=v, cw=w)
