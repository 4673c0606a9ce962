"""Scene catalog: the scenes of the port's slice (counterpart of
ptsharp_tpu/examples.py, same signatures and defaults plus a `device`,
the card unless "cpu" is asked for): cornell, bunny, dragon_hd, the
instanced and many-object scenes that take the TLAS, toybrick and
cube_field, veach, the integrator-correctness scene of the split and
all-lights modes, and the scenes of the marched shapes and meshing:
teapot (an SDF tree meshed by marching tetrahedra), ellipsoid, sdf
(depth of field), volume, mol (a molfile's ball-and-stick), sh (two
spherical-harmonics lobe meshes), heightfield and love.

Each builder returns (scene, camera, render_config, integrator_config).
"""

from __future__ import annotations

import math

import numpy as np

from ptsharp_tpu_torch.camera import Camera
from ptsharp_tpu_torch.core import color as colorlib
from ptsharp_tpu_torch.core import transform, vec
from ptsharp_tpu_torch.core.device import DEFAULT
from ptsharp_tpu_torch.geometry import mc
from ptsharp_tpu_torch.geometry import sdf as sdf_mod
from ptsharp_tpu_torch.geometry import volume as vol_mod
from ptsharp_tpu_torch.geometry.function import Heightfield
from ptsharp_tpu_torch.geometry.mesh import TriMesh, cube_mesh, sphere_mesh
from ptsharp_tpu_torch.geometry.sh_shape import add_sh_shape
from ptsharp_tpu_torch.io.mol import add_molecule, benzene
from ptsharp_tpu_torch.integrator import (
    LIGHT_MODE_ALL, SPECULAR_MODE_FIRST, IntegratorConfig,
)
from ptsharp_tpu_torch.materials import (
    Material, clear_material, diffuse_material, glossy_material,
    light_material, metallic_material,
)
from ptsharp_tpu_torch.renderer import RenderConfig
from ptsharp_tpu_torch.scene import SceneBuilder, not_ported

CATALOG = {}


def example(name):
    def deco(fn):
        CATALOG[name] = fn
        return fn

    return deco


@example("cornell")
def cornell(width=512, height=512, device=DEFAULT):
    """Cornell-style box: area-light NEE, specular and refractive spheres,
    Russian roulette. Analytic primitives only."""
    red = diffuse_material([0.63, 0.065, 0.05])
    green = diffuse_material([0.14, 0.45, 0.091])
    white = diffuse_material([0.725, 0.71, 0.68])
    b = SceneBuilder()
    s = 2.0  # half-size of the box
    b.add_plane([-s, 0, 0], [1, 0, 0], red)     # left wall
    b.add_plane([s, 0, 0], [-1, 0, 0], green)   # right wall
    b.add_plane([0, 0, 0], [0, 1, 0], white)    # floor
    b.add_plane([0, 2 * s, 0], [0, -1, 0], white)  # ceiling
    b.add_plane([0, 0, s], [0, 0, -1], white)   # back wall
    # area light: emissive sphere poking through the ceiling
    b.add_sphere([0, 2 * s + 0.85, 0], 1.0, light_material([1, 1, 1], 14.0))
    b.add_sphere([-0.9, 0.75, 0.6], 0.75,
                 metallic_material([0.95, 0.95, 0.95], 0.0, 0.9))
    b.add_sphere([0.9, 0.65, -0.4], 0.65, clear_material(1.5, 0.0))
    scene = b.build(device=device)
    cam = Camera.look_at([0, 2.0, -6.5], [0, 2.0, 0], [0, 1, 0], 40.0,
                         device=device)
    return scene, cam, RenderConfig(width=width, height=height, spp=16), \
        IntegratorConfig(max_bounces=5, russian_roulette=True,
                         rr_start_depth=2)


def _bunny_mesh(subdivisions: int = 6, seed: int = 11) -> TriMesh:
    """Procedural bunny-class mesh: an icosphere displaced by a band of
    sines (irregular triangle sizes and concavities). Subdivision 6 gives
    81,920 triangles."""
    m = sphere_mesh([0, 0, 0], 1.0, subdivisions=subdivisions)
    v = m.v.reshape(-1, 3).astype(np.float64)
    d = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    # seed-derived phase offsets give distinct geometry per caller
    p1, p2, p3 = (np.random.default_rng(seed).uniform(0, 2 * np.pi, 3)
                  if seed != 11 else (0.0, 0.0, 0.0))
    disp = (
        0.16 * np.sin(5.1 * x + 1.3 + p1) * np.sin(4.3 * y + p2)
        + 0.11 * np.sin(7.7 * z + 0.5 + p2) * np.cos(6.1 * x + p3)
        + 0.07 * np.sin(11.0 * y + 2.1 + p3) * np.sin(9.0 * z + p1)
        + 0.23 * np.exp(-18.0 * ((x - 0.25) ** 2 + (y - 0.85) ** 2 + z**2))
        + 0.23 * np.exp(-18.0 * ((x + 0.25) ** 2 + (y - 0.85) ** 2 + z**2))
    )
    r = 1.0 + disp
    # squash into a seated-blob silhouette
    v2 = d * r[:, None]
    v2[:, 1] *= 0.92
    new_v = v2.reshape(-1, 3, 3).astype(np.float32)
    uv = np.stack(
        [0.5 + np.arctan2(z, x) / (2 * np.pi),
         0.5 + np.arcsin(np.clip(y, -1, 1)) / np.pi],
        axis=-1,
    ).astype(np.float32).reshape(-1, 3, 2)
    return TriMesh(v=new_v, n=m.n, uv=uv).smooth_normals()


def _leaf_size(intersector: str) -> int:
    """Leaf 14 fills the pallas kernels' 126-slot row; the XLA walks take
    leaf 8 (ptsharp_tpu/examples.py:211-214)."""
    return 14 if intersector == "pallas" else 8


@example("bunny")
def bunny(width=1920, height=1080, subdivisions: int = 6,
          intersector: str = "wide", wide_k: int = 4,
          pallas_ordered: bool = True, device=DEFAULT):
    """A bunny-class triangle mesh (81,920 triangles) with a procedural
    marble texture, a ground plane and one spherical area light, 1080p.
    Leaf 14 for "pallas", 8 for the XLA walks, as in the JAX package."""
    b = SceneBuilder()
    ty, tx = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    vein = np.sin(tx * 0.35 + 3.0 * np.sin(ty * 0.12)) * 0.5 + 0.5
    tex = (0.45 + 0.5 * vein[..., None] * np.array([0.9, 0.85, 0.75]))
    tid = b.add_texture(np.clip(tex, 0, 1).astype(np.float32))
    mat = Material(color=(0.7, 0.65, 0.55), texture=tid)
    m = _bunny_mesh(subdivisions)
    m = m.fit_inside([-1, 0, -1], [1, 2, 1], [0.5, 0.0, 0.5])
    b.add_mesh(m, mat)
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.75, 0.72, 0.68]))
    b.add_sphere([3.5, 6, -3], 1.6, light_material([1, 1, 1], 9.0))
    b.set_environment(color=[0.10, 0.11, 0.14])
    scene = b.build(leaf_size=_leaf_size(intersector),
                    intersector=intersector, wide_k=wide_k,
                    pallas_ordered=pallas_ordered, device=device)
    cam = Camera.look_at([0, 1.8, -4.2], [0, 0.9, 0], [0, 1, 0], 38.0,
                         device=device)
    return scene, cam, RenderConfig(width=width, height=height, spp=16), \
        IntegratorConfig(max_bounces=4)


def dragon_mesh(subdivisions: int = 8) -> TriMesh:
    """dragon_hd's mesh: the displaced icosphere of _bunny_mesh (seed 23)
    with a serpentine warp, fitted inside [-1.6, 0, -0.8] .. [1.6, 1.2,
    0.8]; 1,310,720 triangles at subdivisions=8."""
    m = _bunny_mesh(subdivisions, seed=23)
    v = m.v.reshape(-1, 3).copy()
    t = v[:, 0] * 1.5
    c, s = np.cos(t * 0.8), np.sin(t * 0.8)
    y = v[:, 1] * c - v[:, 2] * s
    z = v[:, 1] * s + v[:, 2] * c
    v[:, 1], v[:, 2] = y * 0.6, z * 0.8
    v[:, 0] *= 1.9
    m = TriMesh(v=v.reshape(-1, 3, 3), uv=m.uv).smooth_normals()
    return m.fit_inside([-1.6, 0, -0.8], [1.6, 1.2, 0.8], [0.5, 0, 0.5])


@example("dragon_hd")
def dragon_hd(width=960, height=540, subdivisions: int = 8,
              intersector: str = "wide", wide_k: int = 4,
              pallas_ordered: bool = True, device=DEFAULT):
    """Dragon-scale mesh: 1,310,720 triangles (the subdivision-8 displaced
    icosphere with a serpentine warp), one jade glossy material, a ground
    plane and one spherical area light. Leaf 14 for "pallas", 8 for the
    XLA walks."""
    b = SceneBuilder()
    jade = glossy_material([0.35, 0.72, 0.45], 1.6, math.radians(16))
    b.add_mesh(dragon_mesh(subdivisions), jade)
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.42, 0.42, 0.45]))
    b.add_sphere([-2.5, 5, -3], 1.4, light_material([1, 1, 1], 10.0))
    b.set_environment(color=[0.15, 0.17, 0.21])
    scene = b.build(leaf_size=_leaf_size(intersector),
                    intersector=intersector, wide_k=wide_k,
                    pallas_ordered=pallas_ordered, device=device)
    cam = Camera.look_at([0, 1.6, -3.6], [0, 0.5, 0], [0, 1, 0], 42.0,
                         device=device)
    return scene, cam, RenderConfig(width=width, height=height, spp=8), \
        IntegratorConfig(max_bounces=4)


def _brick_mesh() -> TriMesh:
    """2x4 toy brick with studs (Util.CreateBrick stand-in: the STL asset
    is not shipped; studs are small boxes)."""
    parts = [cube_mesh([0, 0, 0], [4, 1.0, 2])]
    for i in range(4):
        for j in range(2):
            cx, cz = 0.5 + i, 0.5 + j
            parts.append(cube_mesh([cx - 0.28, 1.0, cz - 0.28],
                                   [cx + 0.28, 1.28, cz + 0.28]))
    return TriMesh(v=np.concatenate([p.v for p in parts]))


@example("toybrick")
def toybrick(width=512, height=384, rows=6, cols=6, device=DEFAULT,
             leaf_size=4, wide_k=4):
    """Instanced toy-brick wall (reference toybrick, Example.cs:1229-1272):
    one brick mesh, rows x cols instances with per-instance material
    overrides, walked through the TLAS (K-wide rows at `wide_k`, leaves
    of `leaf_size` triangles: the JAX example's 4 and 4)."""
    rng = np.random.default_rng(4)
    palette = [
        diffuse_material(c) for c in
        ([0.78, 0.12, 0.1], [0.98, 0.75, 0.1], [0.1, 0.4, 0.75],
         [0.1, 0.6, 0.25], [0.95, 0.95, 0.95], [0.95, 0.45, 0.1])
    ]
    b = SceneBuilder()
    mid = None
    brick = _brick_mesh()
    for r_ in range(rows):
        off = 2.0 if r_ % 2 else 0.0
        for c_ in range(cols):
            t = transform.translate([c_ * 4.0 + off - cols * 2, r_ * 1.0, 0])
            mat = palette[int(rng.integers(len(palette)))]
            if mid is None:
                mid = b.add_mesh(brick, mat, transform=t)
            else:
                b.add_mesh_instance(mid, transform=t, material=mat)
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.7, 0.7, 0.7]))
    b.add_sphere([6, 14, -12], 3.0, light_material([1, 1, 1], 7.0))
    b.set_environment(color=[0.25, 0.28, 0.33])
    scene = b.build(leaf_size=leaf_size, wide_k=wide_k, device=device)
    cam = Camera.look_at([2, 5.5, -16], [0, 3, 0], [0, 1, 0], 40.0,
                         device=device)
    return scene, cam, RenderConfig(width=width, height=height, spp=12), \
        IntegratorConfig(max_bounces=3)


@example("cube_field")
def cube_field(width=512, height=384, n=12, device=DEFAULT):
    """Grid of random-height cubes (reference example3, Example.cs:387-418,
    the default viewport scene): n x n cubes and a light, 145 analytic
    primitives at n = 12, walked through the TLAS."""
    rng = np.random.default_rng(4)
    b = SceneBuilder()
    for i in range(-n // 2, n // 2):
        for j in range(-n // 2, n // 2):
            h = float(rng.uniform(0.1, 1.8))
            b.add_cube([i, 0, j], [i + 0.92, h, j + 0.92],
                       diffuse_material(colorlib.hex_color(
                           [0x334D5C, 0x45B29D, 0xEFC94C, 0xE27A3F,
                            0xDF5A49][int(rng.integers(5))])))
    b.add_sphere([0, 14, -6], 3.0, light_material([1, 1, 1], 8.0))
    b.set_environment(color=[0.1, 0.12, 0.15])
    scene = b.build(device=device)
    cam = Camera.look_at([-7, 8, -10], [0, 0, 0], [0, 1, 0], 40.0,
                         device=device)
    return scene, cam, RenderConfig(width=width, height=height, spp=8), \
        IntegratorConfig(max_bounces=3)


@example("veach")
def veach(width=512, height=384, device=DEFAULT):
    """Veach MIS stress scene: four lights of varying size and emittance
    over metallic bars of varying gloss (reference veachscene,
    Example.cs:1566-1611), the integrator-correctness scene: specular
    mode "first", light mode "all". Analytic primitives only."""
    b = SceneBuilder()
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.6, 0.6, 0.6]))
    b.add_plane([0, 0, 6], [0, 0, -1], diffuse_material([0.55, 0.55, 0.55]))
    # four spherical lights: radius shrinks as emittance grows
    lights = [
        (2.0, 2.0, [1.0, 0.8, 0.6]),
        (0.9, 8.0, [0.9, 1.0, 0.7]),
        (0.35, 40.0, [0.7, 0.9, 1.0]),
        (0.12, 300.0, [1.0, 0.7, 0.9]),
    ]
    for i, (rad, e, c) in enumerate(lights):
        b.add_sphere([-4.5 + i * 3.0, 5.0, 3.0], rad, light_material(c, e))
    # metallic bars with increasing roughness
    for i in range(4):
        gloss = math.radians([2.0, 8.0, 18.0, 32.0][i])
        b.add_cube([-1, -0.03, -0.15], [1, 0.03, 0.15],
                   metallic_material([0.9, 0.9, 0.9], gloss, 0.9),
                   transform=_bar_transform(0.6 + i * 0.9, 1.0 + i * 0.8))
    b.set_environment(color=[0.03, 0.03, 0.04])
    scene = b.build(device=device)
    cam = Camera.look_at([0, 3.0, -8.0], [0, 2.0, 2.0], [0, 1, 0], 40.0,
                         device=device)
    return scene, cam, RenderConfig(width=width, height=height, spp=16), \
        IntegratorConfig(max_bounces=4, specular_mode=SPECULAR_MODE_FIRST,
                         light_mode=LIGHT_MODE_ALL)


def _bar_transform(y, z):
    """A bar stretched 3x along x, tilted 25 degrees toward the camera
    and placed at (0, y, z)."""
    t = np.eye(4, dtype=np.float32)
    t[:3, :3] = np.diag([3.0, 1.0, 1.0]).astype(np.float32)
    ang = math.radians(-25.0)
    c, s = math.cos(ang), math.sin(ang)
    rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    t[:3, :3] = rot @ t[:3, :3]
    t[:3, 3] = [0, y, z]
    return t


@example("teapot")
def teapot(width=512, height=384, device=DEFAULT):
    """CSG-meshed teapot stand-in (reference teapot, Example.cs:1349-1382):
    supersphere body, torus handle and capsule spout, iso-surfaced by
    marching tetrahedra into a triangle mesh (the default "wide" build)."""
    body = sdf_mod.SdfSphere(radius=1.0, exponent=3.0)
    handle = sdf_mod.SdfTransform(sdf_mod.SdfTorus(major=0.45, minor=0.1),
                                  transform.translate([-1.05, 0.1, 0.0]))
    spout = sdf_mod.SdfTransform(
        sdf_mod.SdfCapsule(a=[0, 0, 0], b=[0.9, 0.55, 0.0], radius=0.14),
        transform.translate([0.8, 0.0, 0.0]))
    pot = sdf_mod.SdfUnion(body, handle, spout)
    m = mc.sdf_mesh(pot.evaluate, [-2.2, -1.4, -1.4], [2.2, 1.4, 1.4], 0.06)
    m = m.smooth_normals_threshold(math.radians(40))
    b = SceneBuilder()
    b.add_mesh(m.fit_inside([-1, 0, -1], [1, 1.4, 1], [0.5, 0, 0.5]),
               glossy_material([0.75, 0.78, 0.82], 1.6, math.radians(18)))
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.7, 0.68, 0.62]))
    b.add_sphere([2.5, 5, -2.5], 1.2, light_material([1, 1, 1], 9.0))
    b.set_environment(color=[0.12, 0.13, 0.16])
    scene = b.build(leaf_size=8, device=device)
    cam = Camera.look_at([0, 1.6, -3.4], [0, 0.6, 0], [0, 1, 0], 40.0,
                         device=device)
    return scene, cam, RenderConfig(width=width, height=height, spp=16), \
        IntegratorConfig(max_bounces=3)


@example("ellipsoid")
def ellipsoid(width=512, height=384, device=DEFAULT):
    """Non-uniformly scaled sphere instancing (reference ellipsoid,
    Example.cs:1104-1125): the per-primitive affine path."""
    b = SceneBuilder()
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.8, 0.8, 0.8]))
    for i in range(4):
        t = np.eye(4, dtype=np.float32)
        ang = i * math.pi / 4
        c, s = math.cos(ang), math.sin(ang)
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        scl = np.diag([2.0, 0.6, 0.6]).astype(np.float32)
        t[:3, :3] = rot @ scl
        t[:3, 3] = [0, 0.8, 0]
        b.add_sphere([0, 0, 0], 1.0, glossy_material(
            [0.7, 0.2, 0.2], 1.5, math.radians(30)), transform=t)
    b.add_sphere([3, 7, -3], 1.5, light_material([1, 1, 1], 10.0))
    b.set_environment(color=[0.07, 0.08, 0.1])
    scene = b.build(device=device)
    cam = Camera.look_at([0, 3, -7], [0, 0.8, 0], [0, 1, 0], 35.0,
                         device=device)
    return scene, cam, RenderConfig(width=width, height=height, spp=16), \
        IntegratorConfig(max_bounces=3)


@example("sdf")
def sdf_scene(width=512, height=384, device=DEFAULT):
    """BASELINE config #4: an SDF CSG shape (a rounded cube drilled by
    three cylinders) under a depth-of-field camera (reference sdf,
    Example.cs:1399-1425)."""
    b = SceneBuilder()
    shape = sdf_mod.SdfIntersection(
        sdf_mod.SdfCube((1.6, 1.6, 1.6)),
        sdf_mod.SdfSphere(1.05),
    ) - sdf_mod.SdfUnion(
        sdf_mod.SdfCylinder(0.55, 4.0),
        sdf_mod.SdfTransform(sdf_mod.SdfCylinder(0.55, 4.0),
                             transform.rotate([1.0, 0, 0], math.pi / 2)),
        sdf_mod.SdfTransform(sdf_mod.SdfCylinder(0.55, 4.0),
                             transform.rotate([0.0, 0, 1], math.pi / 2)),
    )
    shape = sdf_mod.SdfTransform(shape, transform.translate([0.0, 1.0, 0.0]))
    b.add_sdf(shape, glossy_material([0.85, 0.55, 0.15], 1.4,
                                     math.radians(25)))
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.78, 0.78, 0.78]))
    b.add_sphere([3, 6, -4], 1.5, light_material([1, 1, 1], 10.0))
    b.set_environment(color=[0.08, 0.09, 0.11])
    scene = b.build(device=device)
    cam = Camera.look_at([2.8, 2.8, -4.5], [0, 1, 0], [0, 1, 0], 35.0,
                         device=device)
    cam = cam.set_focus([0.0, 1.0, 0.0], 0.06)
    return scene, cam, RenderConfig(width=width, height=height, spp=16), \
        IntegratorConfig(max_bounces=3)


def volume_density(n: int = 64) -> np.ndarray:
    """volume's procedural (n, n, n) density: a radial falloff plus an
    angular ripple, clipped to [0, 1]."""
    g = np.mgrid[0:n, 0:n, 0:n].astype(np.float32) / (n - 1) * 2.0 - 1.0
    x, y, z = g[0], g[1], g[2]
    r = np.sqrt(x**2 + y**2 + z**2)
    density = (np.clip(1.0 - r, 0, 1)
               + 0.12 * np.sin(6 * x) * np.sin(6 * y) * np.sin(6 * z))
    return np.clip(density, 0.0, 1.0)


@example("volume")
def volume_scene(width=384, height=384, device=DEFAULT):
    """BASELINE config #5: windowed iso-surface volume rendering over a
    procedural 64^3 density grid (reference volume, Example.cs:1427-1474,
    minus the CT-slice asset)."""
    b = SceneBuilder()
    id_out = b.material_id(diffuse_material([0.9, 0.5, 0.3]))
    id_in = b.material_id(diffuse_material([0.3, 0.5, 0.9]))
    b.add_volume(vol_mod.VolumeGrid(
        data=volume_density(),
        windows=[vol_mod.VolumeWindow(0.25, 0.6, id_out),
                 vol_mod.VolumeWindow(0.6, 1.1, id_in)],
        bmin=np.array([-1, 0, -1], np.float32),
        bmax=np.array([1, 2, 1], np.float32)))
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.8, 0.8, 0.8]))
    b.add_sphere([3, 6, -3], 1.5, light_material([1, 1, 1], 10.0))
    b.set_environment(color=[0.09, 0.1, 0.12])
    scene = b.build(device=device)
    cam = Camera.look_at([0, 2.2, -4.5], [0, 1, 0], [0, 1, 0], 40.0,
                         device=device)
    return scene, cam, RenderConfig(width=width, height=height, spp=8), \
        IntegratorConfig(max_bounces=2)


@example("mol")
def mol(width=512, height=384, device=DEFAULT):
    """Ball-and-stick molecule (reference mol, Example.cs:538-816) from the
    embedded benzene structure: spheres and transformed cylinders."""
    b = SceneBuilder()
    add_molecule(b, benzene())
    b.add_plane([0, 0, -1.2], [0, 0, 1], diffuse_material([0.85, 0.85, 0.85]))
    b.add_sphere([4, 6, 6], 2.0, light_material([1, 1, 1], 8.0))
    b.set_environment(color=[0.12, 0.13, 0.16])
    scene = b.build(device=device)
    cam = Camera.look_at([0, -7, 4], [0, 0, 0], [0, 0, 1], 40.0,
                         device=device)
    return scene, cam, RenderConfig(width=width, height=height, spp=16), \
        IntegratorConfig(max_bounces=3)


@example("sh")
def sh(width=448, height=448, device=DEFAULT):
    """Spherical-harmonics lobe shape, its positive and negative lobes two
    meshes of two materials (reference sh, SH.cs, Example.cs:942-975):
    two instances, so the TLAS."""
    b = SceneBuilder()
    t = np.eye(4, dtype=np.float32)
    t[:3, :3] *= 2.2
    t[:3, 3] = [0, 1.4, 0]
    add_sh_shape(b, 3, 2,
                 glossy_material([0.8, 0.25, 0.2], 1.4, math.radians(15)),
                 glossy_material([0.2, 0.3, 0.8], 1.4, math.radians(15)),
                 transform=t, step=0.035)
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.8, 0.8, 0.8]))
    b.add_sphere([3, 6, -3], 1.5, light_material([1, 1, 1], 9.0))
    b.set_environment(color=[0.09, 0.1, 0.12])
    scene = b.build(leaf_size=8, device=device)
    cam = Camera.look_at([0, 2.6, -4.5], [0, 1.2, 0], [0, 1, 0], 40.0,
                         device=device)
    return scene, cam, RenderConfig(width=width, height=height, spp=16), \
        IntegratorConfig(max_bounces=3)


def terrain(x, y):
    """heightfield's f over tensors: a product of sines (vec.sin, vec.cos:
    the same bits on the CPU and the card)."""
    return (0.6 * vec.sin(x) * vec.cos(y)
            + 0.2 * vec.sin(3 * x) * vec.sin(2 * y))


@example("heightfield")
def heightfield(width=512, height=384, device=DEFAULT):
    """z < f(x, y) terrain shape (reference Function.cs capability)."""
    b = SceneBuilder()
    hf = Heightfield(f=terrain, bmin=np.array([-4, -4, -2], np.float32),
                     bmax=np.array([4, 4, 2], np.float32))
    b.add_function(hf, glossy_material([0.4, 0.55, 0.35], 1.3,
                                       math.radians(25)))
    b.add_sphere([5, 6, 8], 2.0, light_material([1, 1, 1], 8.0))
    b.set_environment(color=[0.2, 0.25, 0.33])
    scene = b.build(device=device)
    cam = Camera.look_at([0, -8, 5], [0, 0, 0], [0, 0, 1], 42.0,
                         device=device)
    return scene, cam, RenderConfig(width=width, height=height, spp=8), \
        IntegratorConfig(max_bounces=2)


@example("love")
def love(width=512, height=384, device=DEFAULT):
    """Heart-ish CSG of two spheres and a rotated cube (reference love)."""
    b = SceneBuilder()
    red = glossy_material([0.8, 0.1, 0.15], 1.5, math.radians(20))
    heart = sdf_mod.SdfUnion(
        sdf_mod.SdfTransform(sdf_mod.SdfSphere(0.72),
                             transform.translate([-0.45, 1.6, 0.0])),
        sdf_mod.SdfTransform(sdf_mod.SdfSphere(0.72),
                             transform.translate([0.45, 1.6, 0.0])),
        sdf_mod.SdfTransform(
            sdf_mod.SdfCube((1.35, 1.35, 1.0)),
            transform.mul(transform.translate([0.0, 0.9, 0.0]),
                          transform.rotate([0.0, 0.0, 1.0], math.pi / 4))),
    )
    b.add_sdf(heart, red)
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.9, 0.88, 0.86]))
    b.add_sphere([3, 6, -4], 1.5, light_material([1, 1, 1], 9.0))
    b.set_environment(color=[0.12, 0.1, 0.12])
    scene = b.build(device=device)
    cam = Camera.look_at([0, 2.2, -5], [0, 1.1, 0], [0, 1, 0], 38.0,
                         device=device)
    return scene, cam, RenderConfig(width=width, height=height, spp=16), \
        IntegratorConfig(max_bounces=3)


def build(name: str, **kw):
    if name not in CATALOG:
        raise not_ported(f"example {name!r}", "Queue 1 item 10d")
    return CATALOG[name](**kw)
