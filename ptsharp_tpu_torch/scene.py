"""Host scene builder -> SceneData of torch tensors on one device.

Counterpart of ptsharp_tpu/scene.py for the slice the port covers:
analytic primitives (sphere, plane, cube, cylinder, each with an optional
affine) and triangle meshes with instances, emissive meshes as area lights
(their emissive triangles in world space with an area CDF, `em_*`) and
materials with normal and bump maps, in one of two table sets by
`intersector`:

  * "pallas": the fat interleave `p_fat` (accel/tables.py), read by the
    fat-table kernels. Up to FLAT_TRI_CAP instanced triangles, every
    instance is baked into ONE world-space K-wide BVH (`p_flat`), walked
    in one launch, with slot maps back to scene triangle and instance;
    beyond it, each mesh's K-wide BVH in object space at its own node
    offset, built once per mesh however many instances share it, walked
    once per instance with object-space rays (the slot is the scene slot).
    The JAX package's VMEM/HBM switch and its duplicate `p_rows`/`p_leaf`
    tables have no counterpart: a GPU has no such split. `p_ordered` picks
    the walk, as in the JAX package: near to far with a stack, or preorder
    along skip links. An ordered scene's build checks `max_stack_bound`
    (each mesh's, non-flat) against the ordered kernels' stack capacity
    and raises if a tree could overflow it, and checks that each child
    box in a node row equals the child's own box bit for bit, which the
    ordered kernels' single box test per node needs
    (tables.check_child_boxes); a preorder walk keeps no stack and has no
    such limit.
  * "wide", "walk", "cluster" (the XLA walks): a binary BVH per mesh in
    object space, its K-wide collapse, and a TLAS head over every object,
    packed as the JAX package packs them (u_rows, w_rows, leaf_rows, the
    cluster tables for "cluster"), byte for byte. intersect.py walks each
    instance with object-space rays, or, where `use_tlas` (more than one
    instance or 64 analytic primitives, as the JAX package decides), the
    whole scene in one walk over the TLAS that re-enters each instance's
    BLAS (kernels.traverse.closest_hit_tlas).

SDF trees (geometry/sdf.py), heightfield functions (geometry/function.py)
and voxel volumes (geometry/volume.py) sit outside both table sets, as in
the JAX package: SceneData holds them as host objects (with each volume's
grid as a device tensor), and intersect.py marches them. An emissive SDF
becomes a PT_SDF light over its bounding sphere.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ptsharp_tpu_torch.accel import bvh as bvh_mod
from ptsharp_tpu_torch.accel import tables
from ptsharp_tpu_torch.accel import wide as wide_mod
from ptsharp_tpu_torch.core import device as devices
from ptsharp_tpu_torch.geometry.mesh import TriMesh
from ptsharp_tpu_torch.kernels.build import STACK_CAPACITY
from ptsharp_tpu_torch.materials import Material, MaterialTable
from ptsharp_tpu_torch.textures import TextureAtlas

# primitive type codes in hit records (same values as the JAX package)
PT_NONE = 0
PT_SPHERE = 1
PT_PLANE = 2
PT_CUBE = 3
PT_CYLINDER = 4
PT_TRIANGLE = 5
PT_SDF = 6
PT_VOLUME = 7
PT_FUNCTION = 8
PT_INSTANCE = 9  # TLAS leaf: a mesh instance

# consecutive leaves are padded to a multiple of this per mesh, so scene
# triangle slots match the JAX package's layout
CLUSTER_GROUP = 16
# "pallas" instances are baked to world space up to this many instanced
# triangle slots (their sum over instances), beyond it each mesh keeps its
# own object-space table, as in the JAX package
FLAT_TRI_CAP = 4_000_000

_IDENTITY34 = np.eye(4, dtype=np.float32)[:3, :4]


@dataclass(frozen=True, eq=False)
class SceneData:
    """Frozen scene tables. Every tensor lives on `device`."""

    device: torch.device
    # spheres (object space center/radius + world->object affine)
    sphere_center: torch.Tensor   # (S, 3)
    sphere_radius: torch.Tensor   # (S,)
    sphere_inv: torch.Tensor      # (S, 3, 4)
    sphere_mat: torch.Tensor      # (S,) i32
    plane_point: torch.Tensor     # (P, 3)
    plane_normal: torch.Tensor    # (P, 3)
    plane_mat: torch.Tensor
    cube_min: torch.Tensor        # (C, 3)
    cube_max: torch.Tensor
    cube_inv: torch.Tensor
    cube_mat: torch.Tensor
    cyl_radius: torch.Tensor      # (Y,)
    cyl_z0: torch.Tensor
    cyl_z1: torch.Tensor
    cyl_inv: torch.Tensor
    cyl_mat: torch.Tensor
    # slot-ordered triangle attributes (padding slots are zeros)
    tri_n0: torch.Tensor          # (T, 3)
    tri_n1: torch.Tensor
    tri_n2: torch.Tensor
    tri_uv0: torch.Tensor         # (T, 2)
    tri_uv1: torch.Tensor
    tri_uv2: torch.Tensor
    tri_mat: torch.Tensor         # (T,) i32
    tri_e1: torch.Tensor          # (T, 3) object-space edges v1 - v0,
    tri_e2: torch.Tensor          # v2 - v0 (the surface maps' tangent frame)
    # mesh instances
    inst_inv: torch.Tensor        # (I, 3, 4) world->object
    inst_mat: torch.Tensor        # (I,) material override, -1 = per-tri
    # "pallas": the fat traversal table and its slot maps (else empty);
    # non-flat: the identity over scene slots, and -1 (the instance is the
    # loop's)
    p_fat: torch.Tensor           # (2*Nw, 128) f32
    p_slot_tri: torch.Tensor      # (NL*leaf,) i32 kernel slot -> scene slot
    p_slot_inst: torch.Tensor     # (NL*leaf,) i32 kernel slot -> instance
    # "wide" / "walk" / "cluster": the XLA walks' tables (else empty);
    # node rows are [TLAS head][object-space BLAS per mesh]
    u_rows: torch.Tensor          # (N, 10) binary node rows
    leaf_rows: torch.Tensor       # (NL, leaf*9) (v0, e1, e2) per slot
    w_rows: torch.Tensor          # (Nw, row_width(K)) K-wide node rows
    cluster_bmin: torch.Tensor    # (C, 3) boxes of 16 leaves ("cluster")
    cluster_bmax: torch.Tensor
    cluster_rows: torch.Tensor    # (C, 16*leaf*9)
    # each instance's BLAS node range [base, end) in u_rows and in w_rows,
    # which the TLAS walk reads on the device
    u_inst_range: torch.Tensor    # (I, 2) i32
    w_inst_range: torch.Tensor    # (I, 2) i32
    # NEE light table
    light_ptype: torch.Tensor
    light_pindex: torch.Tensor
    light_center: torch.Tensor
    light_radius: torch.Tensor
    light_mat: torch.Tensor
    # PT_TRIANGLE lights (emissive mesh instances): each light's emissive
    # triangles are em_*[start:end], sampled by area; light_area their
    # total world area (0 for other lights)
    light_tri_start: torch.Tensor  # (L,) i32
    light_tri_end: torch.Tensor
    light_area: torch.Tensor
    light_cdf: torch.Tensor       # power-mode cumulative pmf
    light_pmf: torch.Tensor
    em_v0: torch.Tensor           # (E, 3) world space
    em_e1: torch.Tensor
    em_e2: torch.Tensor
    em_nrm: torch.Tensor          # (E, 3) unit face normal, world space
    em_cdf: torch.Tensor          # (E,) cumulative area within its light
    em_mat: torch.Tensor          # (E,) i32 the triangle's material
    materials: MaterialTable
    textures: TextureAtlas
    volume_data: tuple            # per volume its (W, H, D) grid tensor
    env_color: torch.Tensor       # (3,)
    texture_angle: float
    # --- static metadata ---
    env_texture: int
    sphere_xform: bool
    cube_xform: bool
    cyl_xform: bool
    max_leaf: int
    wide_k: int
    intersector: str
    use_tlas: bool                # one TLAS walk over the whole scene
    p_flat: bool                  # one world-space tree over all instances
    p_ordered: bool               # ordered (stack) walk, else preorder
    p_inst_base: tuple            # node range [base, end) in the fat table:
    p_inst_end: tuple             # one (flat), or one per instance
    p_stack_bound: int            # max_stack_bound of the fat table (the
                                  # largest of the meshes' non-flat;
                                  # checked for ordered scenes only)
    # per instance: its BLAS node range in u_rows and w_rows and its
    # cluster range; the TLAS heads' row counts
    u_inst_base: tuple
    u_inst_end: tuple
    w_inst_base: tuple
    w_inst_end: tuple
    inst_cluster_base: tuple
    inst_cluster_end: tuple
    tlas_end: int
    w_tlas_end: int
    light_types: tuple
    # the marched shapes, host objects: (Sdf, mat_id, bmin, bmax) tuples,
    # VolumeGrids (their windows carry material ids), (Heightfield, mat_id)
    sdf_objects: tuple
    volumes: tuple
    functions: tuple
    has_surface_maps: bool        # some material has a normal or bump map
    bvh_builder: str              # builder of the traversal tree

    @property
    def num_lights(self) -> int:
        return self.light_mat.shape[0]

    @property
    def has_meshes(self) -> bool:
        return self.inst_inv.shape[0] > 0


def check_stack_bound(bound: int) -> None:
    if bound > STACK_CAPACITY:
        raise ValueError(
            f"BVH needs a traversal stack of {bound} entries; the kernels "
            f"hold {STACK_CAPACITY}")


def inst_range(base, end) -> np.ndarray:
    """Instance node ranges as the (I, 2) int32 array the TLAS walk
    reads."""
    return np.stack([np.asarray(base, np.int32).reshape(-1),
                     np.asarray(end, np.int32).reshape(-1)], axis=1)


def no_xla_tables(leaf_size: int, k: int) -> tuple[dict, dict]:
    """The XLA walks' (tables, ranges) of a scene that has none: a
    "pallas" scene."""
    cw = CLUSTER_GROUP * leaf_size * 9
    return (dict(u_rows=np.zeros((0, 10), np.float32),
                 leaf_rows=np.zeros((0, leaf_size * 9), np.float32),
                 w_rows=np.zeros((0, wide_mod.row_width(k)), np.float32),
                 cluster_bmin=np.zeros((0, 3), np.float32),
                 cluster_bmax=np.zeros((0, 3), np.float32),
                 cluster_rows=np.zeros((0, cw), np.float32)),
            dict(u_inst_base=(), u_inst_end=(), w_inst_base=(),
                 w_inst_end=(), inst_cluster_base=(), inst_cluster_end=(),
                 tlas_end=0, w_tlas_end=0))


def _affine(m: np.ndarray) -> np.ndarray:
    return np.asarray(m, np.float32)[:3, :4]


def _xform_aabb(world34: np.ndarray, lo, hi):
    """World box of an object-space box under an affine: the 8 corners
    transformed and re-boxed (Matrix.MulBox, Matrix.cs:157-173)."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    corners = np.array(
        [[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
         for z in (lo[2], hi[2])],
        np.float32,
    )
    w = corners @ np.asarray(world34, np.float32)[:, :3].T + world34[:, 3]
    return w.min(axis=0), w.max(axis=0)


class SceneBuilder:
    """Collects shapes and materials on the host; `build()` freezes them
    into tensors on one device. Emissive primitives become NEE lights."""

    def __init__(self):
        self._materials: list[Material] = []
        self._mat_ids: dict[Material, int] = {}
        self._spheres = []   # (center, radius, inv, mat, world)
        self._planes = []
        self._cubes = []
        self._cyls = []
        self._meshes: list[tuple[TriMesh, int]] = []  # (mesh, default mat)
        self._instances = []  # (mesh_idx, inv, world, mat_override)
        self._lights = []     # (ptype, pindex, center, radius, mat)
        self._sdfs = []       # (sdf, mat, bmin, bmax)
        self._volumes = []
        self._functions = []  # (heightfield, mat)
        self._textures: list[np.ndarray] = []
        self.env_color = np.zeros(3, np.float32)
        self.env_texture = -1
        self.texture_angle = 0.0

    # -- materials / textures ----------------------------------------------

    def material_id(self, m: Material) -> int:
        if m not in self._mat_ids:
            self._mat_ids[m] = len(self._materials)
            self._materials.append(m)
        return self._mat_ids[m]

    def add_texture(self, image: np.ndarray) -> int:
        """Register an (H, W, 3) linear-RGB image; returns its atlas id."""
        self._textures.append(np.asarray(image, np.float32))
        return len(self._textures) - 1

    def set_environment(self, color=None, texture_id: int = -1,
                        angle: float = 0.0):
        if color is not None:
            self.env_color = np.asarray(color, np.float32)
        self.env_texture = texture_id
        self.texture_angle = float(angle)

    # -- shapes --------------------------------------------------------------

    def _register_light(self, ptype, pindex, center, radius, mat_id,
                        m: Material):
        if m.emittance > 0:
            self._lights.append((ptype, pindex, np.asarray(center, np.float32),
                                 float(radius), mat_id))

    def _xform(self, transform):
        if transform is None:
            return _IDENTITY34, None
        t = np.asarray(transform, np.float32)
        return _affine(np.linalg.inv(t)), t

    @staticmethod
    def _world(t):
        return _IDENTITY34 if t is None else _affine(t)

    def add_sphere(self, center, radius, material: Material,
                   transform=None) -> int:
        mid = self.material_id(material)
        center = np.asarray(center, np.float32)
        inv, t = self._xform(transform)
        wcenter, wradius = center, radius
        if t is not None:
            wcenter = t[:3, :3] @ center + t[:3, 3]
            wradius = radius * float(np.linalg.norm(t[:3, :3], 2))
        idx = len(self._spheres)
        self._spheres.append((center, float(radius), inv, mid,
                              self._world(t)))
        self._register_light(PT_SPHERE, idx, wcenter, wradius, mid, material)
        return idx

    def add_plane(self, point, normal, material: Material) -> int:
        if material.emittance > 0:
            raise ValueError(
                "emissive infinite planes are not supported as NEE lights; "
                "use an emissive quad mesh or thin cube instead")
        mid = self.material_id(material)
        n = np.asarray(normal, np.float32)
        n = n / max(np.linalg.norm(n), 1e-20)
        self._planes.append((np.asarray(point, np.float32), n, mid))
        return len(self._planes) - 1

    def add_cube(self, bmin, bmax, material: Material, transform=None) -> int:
        mid = self.material_id(material)
        bmin = np.asarray(bmin, np.float32)
        bmax = np.asarray(bmax, np.float32)
        inv, t = self._xform(transform)
        center = 0.5 * (bmin + bmax)
        radius = 0.5 * float(np.linalg.norm(bmax - bmin))
        if t is not None:
            center = t[:3, :3] @ center + t[:3, 3]
            radius *= float(np.linalg.norm(t[:3, :3], 2))
        idx = len(self._cubes)
        self._cubes.append((bmin, bmax, inv, mid, self._world(t)))
        self._register_light(PT_CUBE, idx, center, radius, mid, material)
        return idx

    def add_cylinder(self, radius, z0, z1, material: Material,
                     transform=None) -> int:
        """Z-axis capped cylinder; `transform` places it anywhere."""
        mid = self.material_id(material)
        inv, t = self._xform(transform)
        center = np.array([0.0, 0.0, (z0 + z1) / 2.0], np.float32)
        rad = float(np.hypot(radius, (z1 - z0) / 2.0))
        if t is not None:
            center = t[:3, :3] @ center + t[:3, 3]
            rad *= float(np.linalg.norm(t[:3, :3], 2))
        idx = len(self._cyls)
        self._cyls.append((float(radius), float(z0), float(z1), inv, mid,
                           self._world(t)))
        self._register_light(PT_CYLINDER, idx, center, rad, mid, material)
        return idx

    def add_mesh(self, mesh: TriMesh, material: Material | None = None,
                 transform=None) -> int:
        """Add a mesh; returns its id for add_mesh_instance. material=None
        keeps per-triangle materials."""
        mid = -1 if material is None else self.material_id(material)
        mesh_idx = len(self._meshes)
        self._meshes.append((mesh, mid))
        self.add_mesh_instance(mesh_idx, transform=transform,
                               material=material)
        return mesh_idx

    def add_mesh_instance(self, mesh_idx: int, transform=None,
                          material: Material | None = None) -> int:
        over = -1 if material is None else self.material_id(material)
        inv, world = _IDENTITY34, _IDENTITY34
        if transform is not None:
            t = np.asarray(transform, np.float32)
            inv, world = _affine(np.linalg.inv(t)), _affine(t)
        mesh, def_mid = self._meshes[mesh_idx]
        mat = material if material is not None else (
            self._materials[def_mid] if def_mid >= 0 else None)
        idx = len(self._instances)
        self._instances.append((mesh_idx, inv, world, over))
        if mat is None and mesh.mat is not None:
            # per-triangle materials (OBJ Ke): any emissive triangle makes
            # the instance a light, whose material is the first emissive one
            mat = next((self._materials[int(m)] for m in np.unique(mesh.mat)
                        if self._materials[int(m)].emittance > 0), None)
        if mat is not None and mat.emittance > 0:
            lo, hi = mesh.bounds()
            center = 0.5 * (lo + hi)
            radius = 0.5 * float(np.linalg.norm(hi - lo))
            if transform is not None:
                t = np.asarray(transform, np.float32)
                center = t[:3, :3] @ center + t[:3, 3]
                radius *= float(np.linalg.norm(t[:3, :3], 2))
            # a mesh light is identified by its instance id in hit records
            self._lights.append((PT_TRIANGLE, idx, center, radius,
                                 self.material_id(mat)))
        return idx

    def add_sdf(self, sdf, material: Material) -> int:
        """Add an SDF tree (geometry/sdf.py), sphere traced inside its
        bounds; an emissive one is a PT_SDF light over its bounding
        sphere."""
        mid = self.material_id(material)
        idx = len(self._sdfs)
        lo, hi = (tuple(map(float, b)) for b in sdf.bounds())
        self._sdfs.append((sdf, mid, lo, hi))
        if material.emittance > 0:
            center = 0.5 * (np.asarray(lo) + np.asarray(hi))
            radius = 0.5 * float(np.linalg.norm(np.asarray(hi)
                                                - np.asarray(lo)))
            self._lights.append((PT_SDF, idx, center.astype(np.float32),
                                 radius, mid))
        return idx

    def add_function(self, heightfield, material: Material) -> int:
        """Add a z < f(x, y) heightfield (geometry/function.py,
        Function.cs)."""
        mid = self.material_id(material)
        self._functions.append((heightfield, mid))
        return len(self._functions) - 1

    def add_volume(self, volume) -> int:
        """Add a geometry.volume.VolumeGrid whose windows carry material
        ids already registered with material_id()."""
        self._volumes.append(volume)
        return len(self._volumes) - 1

    # -- freeze --------------------------------------------------------------

    def _emissive_tables(self):
        """Each PT_TRIANGLE light's emissive triangles in world space with
        a cumulative area CDF within the light, for NEE's area sampling.
        Returns (em_* arrays, light_tri_start, light_tri_end,
        light_area)."""
        n_l = len(self._lights)
        lt_start = np.zeros(n_l, np.int32)
        lt_end = np.zeros(n_l, np.int32)
        lt_area = np.zeros(n_l, np.float32)
        parts = {name: [] for name in ("em_v0", "em_e1", "em_e2", "em_nrm",
                                       "em_cdf", "em_mat")}
        emit_lut = np.asarray([m.emittance for m in self._materials],
                              np.float32)
        cursor = 0
        for li, (ptype, pindex, _c, _r, _lm) in enumerate(self._lights):
            if ptype != PT_TRIANGLE:
                continue
            mesh_idx, _inv, world, over = self._instances[pindex]
            mesh, def_mid = self._meshes[mesh_idx]
            n_tri = mesh.v.shape[0]
            if over >= 0:
                mids = np.full(n_tri, over, np.int32)
            elif mesh.mat is not None:
                mids = np.asarray(mesh.mat, np.int32)
            else:
                mids = np.full(n_tri, max(def_mid, 0), np.int32)
            sel = emit_lut[mids] > 0
            if not sel.any():
                continue
            wv = mesh.v[sel] @ world[:3, :3].T + world[:3, 3]
            e1 = wv[:, 1] - wv[:, 0]
            e2 = wv[:, 2] - wv[:, 0]
            cr = np.cross(e1, e2)
            area2 = np.linalg.norm(cr, axis=1)
            area = 0.5 * area2
            total = float(area.sum())
            parts["em_v0"].append(wv[:, 0].astype(np.float32))
            parts["em_e1"].append(e1.astype(np.float32))
            parts["em_e2"].append(e2.astype(np.float32))
            parts["em_nrm"].append(
                (cr / np.maximum(area2, 1e-20)[:, None]).astype(np.float32))
            parts["em_cdf"].append(
                (np.cumsum(area) / max(total, 1e-20)).astype(np.float32))
            parts["em_mat"].append(mids[sel])
            lt_start[li] = cursor
            cursor += int(sel.sum())
            lt_end[li] = cursor
            lt_area[li] = total
        shapes = dict(em_v0=(3,), em_e1=(3,), em_e2=(3,), em_nrm=(3,),
                      em_cdf=(), em_mat=())
        em = {}
        for name, ps in parts.items():
            dtype = np.int32 if name == "em_mat" else np.float32
            em[name] = (np.concatenate(ps).astype(dtype) if ps
                        else np.zeros((0,) + shapes[name], dtype))
        return em, lt_start, lt_end, lt_area

    def _mesh_slots(self, leaf_size: int):
        """Per-mesh BVH slot layout, as the JAX package lays out its scene
        triangle arrays: every leaf owns leaf_size slots and each mesh's
        leaf count is padded to a CLUSTER_GROUP multiple. Also returns
        each mesh's binary BVH and its leaf node ids."""
        tri_v, tri_n, tri_uv, tri_mat, slot_range = [], [], [], [], []
        blas = []
        slot_offset = 0
        for mesh, def_mid in self._meshes:
            mesh = mesh.fix_normals()
            v = mesh.v
            lo = np.minimum(np.minimum(v[:, 0], v[:, 1]), v[:, 2])
            hi = np.maximum(np.maximum(v[:, 0], v[:, 1]), v[:, 2])
            flat = bvh_mod.build(lo, hi, leaf_size=leaf_size)
            order = flat.order
            sv, sn, suv = v[order], mesh.n[order], mesh.uv[order]
            if mesh.mat is not None and def_mid < 0:
                tm = mesh.mat[order]
            else:
                tm = np.full(v.shape[0], max(def_mid, 0), np.int32)
            leaf_ids = np.where(flat.count > 0)[0]
            nl = leaf_ids.shape[0]
            lanes = np.arange(leaf_size, dtype=np.int32)
            src = flat.first[leaf_ids][:, None] + lanes[None, :]
            valid = lanes[None, :] < flat.count[leaf_ids][:, None]
            src = np.where(valid, src, 0).reshape(-1)
            vmask = valid.reshape(-1)
            lpad = ((-nl) % CLUSTER_GROUP) * leaf_size
            parts = []
            for a, shape in ((sv, (3, 3)), (sn, (3, 3)), (suv, (3, 2))):
                s = np.where(vmask[:, None, None], a[src], 0.0)
                parts.append(np.concatenate(
                    [s.astype(np.float32), np.zeros((lpad,) + shape,
                                                    np.float32)]))
            tri_v.append(parts[0])
            tri_n.append(parts[1])
            tri_uv.append(parts[2])
            tri_mat.append(np.concatenate(
                [np.where(vmask, tm[src], 0).astype(np.int32),
                 np.zeros(lpad, np.int32)]))
            n_slots = nl * leaf_size + lpad
            slot_range.append((slot_offset, slot_offset + n_slots))
            blas.append((flat, leaf_ids))
            slot_offset += n_slots
        return (np.concatenate(tri_v), np.concatenate(tri_n),
                np.concatenate(tri_uv), np.concatenate(tri_mat), slot_range,
                blas)

    @staticmethod
    def _mesh_wides(slot_range, blas, leaf_size: int, k: int):
        """Per mesh, in object space: its leaf firsts moved to its padded
        scene slots, and the K-wide collapse of its binary BVH with them
        (ptsharp_tpu/scene.py:590-599). Returns [(first, kind, wide)]."""
        out = []
        for (flat, leaf_ids), (lo_s, _hi_s) in zip(blas, slot_range):
            first = flat.first.copy()
            first[leaf_ids] = (np.arange(leaf_ids.shape[0], dtype=np.int32)
                               * leaf_size + lo_s)
            kind = np.where(flat.count > 0, PT_TRIANGLE,
                            PT_NONE).astype(np.int32)
            out.append((first, kind, wide_mod.collapse(
                flat.bmin, flat.bmax, first, flat.count, flat.skip,
                kind=kind, k=k)))
        return out

    @staticmethod
    def _leaf_rows(tv, leaf_size: int) -> np.ndarray:
        """(NL, leaf*9): (v0, e1, e2) of each scene slot, a leaf a row."""
        return np.concatenate(
            [tv[:, 0], tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]],
            axis=1).reshape(-1, leaf_size * 9).astype(np.float32)

    def _pallas_instance_tables(self, tv, slot_range, blas, leaf_size: int,
                                k: int, ordered: bool):
        """The non-flat "pallas" table (ptsharp_tpu/scene.py:796-816):
        each mesh's K-wide rows in object space at its own node offset,
        padded to 128 columns, once per mesh; the scene's leaf rows padded
        the same way; pack_fat over both. Kernel slots are scene slots.
        Returns (fat, node range of each instance (base, end), the largest
        max_stack_bound of the meshes); an ordered build checks each
        mesh's bound and the child boxes."""
        parts, ranges = [], []
        off = 0
        for _first, _kind, w in self._mesh_wides(slot_range, blas,
                                                  leaf_size, k):
            parts.append(tables._pack_rows_128(w, off))
            ranges.append((off, off + w.bmin.shape[0]))
            off += w.bmin.shape[0]
        rows = np.concatenate(parts)
        lr = self._leaf_rows(tv, leaf_size)
        leaf = np.zeros((lr.shape[0], tables.ROW), np.float32)
        leaf[:, :lr.shape[1]] = lr
        bounds = [tables.max_stack_bound(rows, k, b, e) for b, e in ranges]
        if ordered:
            for bound in bounds:
                check_stack_bound(bound)
            tables.check_child_boxes(rows, k)
        inst = [ranges[m] for m, *_ in self._instances]
        return (tables.pack_fat(rows, leaf, leaf_size),
                (tuple(b for b, _e in inst), tuple(e for _b, e in inst)),
                max(bounds))

    def _xla_tables(self, tv, slot_range, blas, leaf_size: int, k: int,
                    clusters: bool) -> tuple[dict, dict]:
        """The XLA walks' tables, laid out as the JAX package's build lays
        them out (ptsharp_tpu/scene.py:499-760): per mesh its binary BVH in
        object space with leaf firsts moved to its padded slots, and the
        K-wide collapse of it; a TLAS over every object (leaf 1, world
        boxes), built whenever there are objects, ahead of the meshes'
        rows; leaf_rows (NL, leaf*9); and for "cluster" the boxes of each
        CLUSTER_GROUP leaves with their blocks. Returns (tables, ranges):
        the arrays, and each instance's node and cluster ranges with the
        TLAS heads' row counts."""
        nodes, ranges, roots, wides = [], [], [], []
        cl_min, cl_max, cl_ranges = [], [], []
        node_off = cl_off = 0
        for (flat, leaf_ids), (first, kind, wide) in zip(
                blas, self._mesh_wides(slot_range, blas, leaf_size, k)):
            nl = leaf_ids.shape[0]
            lo_s, hi_s = slot_range[len(ranges)]
            nlp = (hi_s - lo_s) // leaf_size
            nc = nlp // CLUSTER_GROUP
            if clusters:
                lb_min = np.full((nlp, 3), np.float32(np.inf))
                lb_max = np.full((nlp, 3), np.float32(-np.inf))
                lb_min[:nl] = flat.bmin[leaf_ids]
                lb_max[:nl] = flat.bmax[leaf_ids]
                cl_min.append(lb_min.reshape(nc, CLUSTER_GROUP, 3).min(1))
                cl_max.append(lb_max.reshape(nc, CLUSTER_GROUP, 3).max(1))
            cl_ranges.append((cl_off, cl_off + nc))
            cl_off += nc
            wides.append(wide)
            n = flat.bmin.shape[0]
            nodes.append((flat.bmin, flat.bmax, first, flat.count,
                          flat.skip + node_off, kind))
            ranges.append((node_off, node_off + n))
            roots.append((flat.bmin[0].copy(), flat.bmax[0].copy()))
            node_off += n
        leaf_rows = self._leaf_rows(tv, leaf_size)
        cw = CLUSTER_GROUP * leaf_size * 9
        if clusters and cl_min:
            cl_min, cl_max = np.concatenate(cl_min), np.concatenate(cl_max)
            cl_rows = leaf_rows.reshape(cl_min.shape[0], cw)
        else:
            cl_min = cl_max = np.zeros((0, 3), np.float32)
            cl_rows = np.zeros((0, cw), np.float32)

        # the TLAS (Tree.cs:22-42): typed singleton leaves over objects
        objs = [(PT_SPHERE, i, c - rad, c + rad, w)
                for i, (c, rad, _inv, _m, w) in enumerate(self._spheres)]
        objs += [(PT_CUBE, i, lo, hi, w)
                 for i, (lo, hi, _inv, _m, w) in enumerate(self._cubes)]
        objs += [(PT_CYLINDER, i, [-rad, -rad, z0], [rad, rad, z1], w)
                 for i, (rad, z0, z1, _inv, _m, w) in enumerate(self._cyls)]
        objs += [(PT_INSTANCE, i, *roots[mesh_idx], w)
                 for i, (mesh_idx, _inv, w, _o) in enumerate(self._instances)]
        w_parts = []
        tlas_n = 0
        if objs:
            boxes = [_xform_aabb(w, lo, hi) for _k, _i, lo, hi, w in objs]
            tl = bvh_mod.build(np.stack([b[0] for b in boxes]),
                               np.stack([b[1] for b in boxes]), leaf_size=1)
            tlas_n = tl.bmin.shape[0]
            t_kind = np.zeros(tlas_n, np.int32)
            t_first = np.zeros(tlas_n, np.int32)
            leaf = tl.count > 0
            ids = tl.order[tl.first[leaf]]
            t_kind[leaf] = np.asarray([o[0] for o in objs], np.int32)[ids]
            t_first[leaf] = np.asarray([o[1] for o in objs], np.int32)[ids]
            w_parts.append(wide_mod.pack_rows(wide_mod.collapse(
                tl.bmin, tl.bmax, t_first, tl.count, tl.skip, kind=t_kind,
                k=k), 0))
            parts = [(tl.bmin, tl.bmax, t_first, tl.count, tl.skip, t_kind)]
            parts += [(*x[:4], x[4] + tlas_n, x[5]) for x in nodes]
            bmin, bmax, first, count, skip, kind = (np.concatenate(x)
                                                    for x in zip(*parts))
        else:
            bmin = bmax = np.zeros((0, 3), np.float32)
            first = count = skip = kind = np.zeros(0, np.int32)
        # binary node rows: [bmin, bmax, first, kind << 8 | count, skip],
        # the ints as bits; skip owns a whole int32
        if leaf_size > 255:
            raise ValueError("leaf_size must be <= 255")
        u_rows = np.zeros((bmin.shape[0], 10), np.float32)
        u_rows[:, 0:3] = bmin
        u_rows[:, 3:6] = bmax
        u_rows[:, 6] = first.astype(np.int32).view(np.float32)
        meta = ((kind.astype(np.int64) << 8)
                | np.minimum(count, 255).astype(np.int64)).astype(np.int32)
        u_rows[:, 7] = meta.view(np.float32)
        u_rows[:, 8] = skip.astype(np.int32).view(np.float32)

        w_tlas_n = w_off = sum(p.shape[0] for p in w_parts)
        w_ranges = []
        for wm in wides:
            w_parts.append(wide_mod.pack_rows(wm, w_off))
            w_ranges.append((w_off, w_off + wm.bmin.shape[0]))
            w_off += wm.bmin.shape[0]
        w_rows = (np.concatenate(w_parts) if w_parts
                  else np.zeros((0, wide_mod.row_width(k)), np.float32))
        meshes = [m for m, *_ in self._instances]
        tabs = dict(u_rows=u_rows, leaf_rows=leaf_rows, w_rows=w_rows,
                    cluster_bmin=cl_min, cluster_bmax=cl_max,
                    cluster_rows=cl_rows)
        return tabs, dict(
            u_inst_base=tuple(ranges[m][0] + tlas_n for m in meshes),
            u_inst_end=tuple(ranges[m][1] + tlas_n for m in meshes),
            w_inst_base=tuple(w_ranges[m][0] for m in meshes),
            w_inst_end=tuple(w_ranges[m][1] for m in meshes),
            inst_cluster_base=tuple(cl_ranges[m][0] for m in meshes),
            inst_cluster_end=tuple(cl_ranges[m][1] for m in meshes),
            tlas_end=int(tlas_n), w_tlas_end=int(w_tlas_n))

    def build(self, leaf_size: int = 8, use_tlas: bool | None = None,
              intersector: str = "wide", wide_k: int = 4,
              pallas_ordered: bool = True,
              device=devices.DEFAULT) -> SceneData:
        """Freeze the scene onto `device` (the card unless "cpu" is
        asked for). Mesh instances are walked by the CUDA kernels, or by
        their plain versions on the CPU:
          "wide"    (default) the K-wide preorder walk over w_rows;
          "walk"    the binary skip-link walk over u_rows;
          "cluster" a cluster cull, then the binary walk for the rays it
                    leaves unresolved;
          "pallas"  one world-space K-wide tree over all instances (up to
                    FLAT_TRI_CAP instanced triangle slots; else each mesh's
                    tree, walked per instance), near to far when
                    `pallas_ordered`, else in preorder.
        Shadow rays of the first three take the K-wide walk, as in the JAX
        package. `use_tlas` (not for "pallas"; None: more than one
        instance or 64 analytic primitives, as the JAX package decides)
        walks every object of the first three through the TLAS in one
        walk instead: wide rows for "wide" and "cluster", binary rows for
        "walk"."""
        if intersector not in ("wide", "walk", "cluster", "pallas"):
            raise ValueError(intersector)
        n_analytic = len(self._spheres) + len(self._cubes) + len(self._cyls)
        if intersector == "pallas":
            if leaf_size * 9 > tables.ROW or 9 + 7 * wide_k > tables.ROW:
                raise ValueError("pallas: leaf_size <= 14 and wide_k <= 17")
            if use_tlas:
                raise ValueError("pallas intersector is per-instance")
            use_tlas = False
        if use_tlas is None:
            use_tlas = len(self._instances) > 1 or n_analytic >= 64
        use_tlas = bool(use_tlas and n_analytic + len(self._instances) > 0)
        dev = devices.resolve(device)

        def t(a, dtype=np.float32):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

        def soa(rows, idx, shape, dtype=np.float32):
            if rows:
                return t(np.stack([np.asarray(r[idx], dtype) for r in rows]),
                         dtype)
            return t(np.zeros((0,) + shape, dtype), dtype)

        p_fat = np.zeros((0, tables.ROW), np.float32)
        p_slot_tri = np.zeros(0, np.int32)
        p_slot_inst = np.zeros(0, np.int32)
        p_inst_b, p_inst_e = (), ()
        stack_bound = 0
        p_flat = False
        builder = "none"
        if self._meshes:
            tv, tn, tuv, tmat, slot_range, blas = self._mesh_slots(leaf_size)
        else:
            tv = np.zeros((0, 3, 3), np.float32)
            tn = np.zeros((0, 3, 3), np.float32)
            tuv = np.zeros((0, 3, 2), np.float32)
            tmat = np.zeros(0, np.int32)
            slot_range, blas = [], []
        if intersector != "pallas":
            xla, ranges = self._xla_tables(tv, slot_range, blas, leaf_size,
                                           wide_k, intersector == "cluster")
            builder = blas[0][0].builder if blas else "none"
        else:
            xla, ranges = no_xla_tables(leaf_size, wide_k)
        if self._instances and intersector == "pallas":
            specs = []
            for iid, (mesh_idx, _inv, world, _over) in enumerate(
                    self._instances):
                lo_s, hi_s = slot_range[mesh_idx]
                specs.append((lo_s, hi_s, world, iid))
            p_flat = sum(hi - lo for lo, hi, _w, _i in specs) <= FLAT_TRI_CAP
            if p_flat:
                e1n = (tv[:, 1] - tv[:, 0]).astype(np.float32)
                e2n = (tv[:, 2] - tv[:, 0]).astype(np.float32)
                rows, leaf, p_slot_tri, p_slot_inst, builder = \
                    tables.pack_flat_tables(tv[:, 0].astype(np.float32), e1n,
                                            e2n, specs, leaf_size, wide_k)
                stack_bound = tables.max_stack_bound(rows, wide_k)
                if pallas_ordered:
                    check_stack_bound(stack_bound)
                    tables.check_child_boxes(rows, wide_k)
                p_fat = tables.pack_fat(rows, leaf, leaf_size)
                p_inst_b, p_inst_e = (0,), (int(rows.shape[0]),)
            else:
                p_fat, (p_inst_b, p_inst_e), stack_bound = \
                    self._pallas_instance_tables(tv, slot_range, blas,
                                                 leaf_size, wide_k,
                                                 pallas_ordered)
                p_slot_tri = np.arange(tv.shape[0], dtype=np.int32)
                p_slot_inst = np.full(tv.shape[0], -1, np.int32)
                builder = blas[0][0].builder

        em, lt_start, lt_end, lt_area = self._emissive_tables()
        n_l = len(self._lights)
        if n_l:
            # power ~ emittance x luminance x area: the emissive area of a
            # mesh light, the bounding r^2 of any other
            lum = np.array([0.2126, 0.7152, 0.0722], np.float32)
            power = np.zeros(n_l, np.float32)
            for li, (pt, _pi, _c, rad, lm) in enumerate(self._lights):
                m = self._materials[lm]
                area = (lt_area[li] if pt == PT_TRIANGLE
                        else max(rad * rad, 1e-8))
                power[li] = m.emittance * float(
                    np.dot(np.asarray(m.color, np.float32), lum)) * area
            total = float(power.sum())
            pmf = (power / total if total > 0
                   else np.full(n_l, 1.0 / n_l, np.float32))
            cdf = np.cumsum(pmf).astype(np.float32)
            cdf[-1] = 1.0
        else:
            pmf = np.zeros(0, np.float32)
            cdf = np.zeros(0, np.float32)

        def xformed(rows, col):
            return any(not np.array_equal(r[col], _IDENTITY34) for r in rows)

        def tri_attr(a, k, shape):
            return t(a[:, k] if a.size else np.zeros((0,) + shape))

        inst = [(inv, over) for _m, inv, _w, over in self._instances]
        return SceneData(
            device=dev,
            sphere_center=soa(self._spheres, 0, (3,)),
            sphere_radius=soa(self._spheres, 1, ()),
            sphere_inv=soa(self._spheres, 2, (3, 4)),
            sphere_mat=soa(self._spheres, 3, (), np.int32),
            plane_point=soa(self._planes, 0, (3,)),
            plane_normal=soa(self._planes, 1, (3,)),
            plane_mat=soa(self._planes, 2, (), np.int32),
            cube_min=soa(self._cubes, 0, (3,)),
            cube_max=soa(self._cubes, 1, (3,)),
            cube_inv=soa(self._cubes, 2, (3, 4)),
            cube_mat=soa(self._cubes, 3, (), np.int32),
            cyl_radius=soa(self._cyls, 0, ()),
            cyl_z0=soa(self._cyls, 1, ()),
            cyl_z1=soa(self._cyls, 2, ()),
            cyl_inv=soa(self._cyls, 3, (3, 4)),
            cyl_mat=soa(self._cyls, 4, (), np.int32),
            tri_n0=tri_attr(tn, 0, (3,)),
            tri_n1=tri_attr(tn, 1, (3,)),
            tri_n2=tri_attr(tn, 2, (3,)),
            tri_uv0=tri_attr(tuv, 0, (2,)),
            tri_uv1=tri_attr(tuv, 1, (2,)),
            tri_uv2=tri_attr(tuv, 2, (2,)),
            tri_mat=t(tmat, np.int32),
            tri_e1=t((tv[:, 1] - tv[:, 0]).astype(np.float32)),
            tri_e2=t((tv[:, 2] - tv[:, 0]).astype(np.float32)),
            inst_inv=soa(inst, 0, (3, 4)),
            inst_mat=soa(inst, 1, (), np.int32),
            p_fat=t(p_fat),
            p_slot_tri=t(p_slot_tri, np.int32),
            p_slot_inst=t(p_slot_inst, np.int32),
            **{name: t(a) for name, a in xla.items()},
            u_inst_range=t(inst_range(ranges["u_inst_base"],
                                      ranges["u_inst_end"]), np.int32),
            w_inst_range=t(inst_range(ranges["w_inst_base"],
                                      ranges["w_inst_end"]), np.int32),
            light_ptype=soa(self._lights, 0, (), np.int32),
            light_pindex=soa(self._lights, 1, (), np.int32),
            light_center=soa(self._lights, 2, (3,)),
            light_radius=soa(self._lights, 3, ()),
            light_mat=soa(self._lights, 4, (), np.int32),
            light_tri_start=t(lt_start, np.int32),
            light_tri_end=t(lt_end, np.int32),
            light_area=t(lt_area),
            light_cdf=t(cdf),
            light_pmf=t(pmf),
            **{name: t(a, a.dtype) for name, a in em.items()},
            materials=MaterialTable.build(self._materials, dev),
            textures=TextureAtlas.build(self._textures, dev),
            volume_data=tuple(t(v.data) for v in self._volumes),
            env_color=t(self.env_color),
            texture_angle=float(self.texture_angle),
            env_texture=int(self.env_texture),
            sphere_xform=xformed(self._spheres, 2),
            cube_xform=xformed(self._cubes, 2),
            cyl_xform=xformed(self._cyls, 3),
            max_leaf=int(leaf_size),
            wide_k=int(wide_k),
            intersector=intersector,
            use_tlas=use_tlas,
            p_flat=p_flat,
            p_ordered=bool(pallas_ordered),
            p_inst_base=p_inst_b,
            p_inst_end=p_inst_e,
            p_stack_bound=int(stack_bound),
            **ranges,
            light_types=tuple(sorted({lt[0] for lt in self._lights})),
            sdf_objects=tuple(self._sdfs),
            volumes=tuple(self._volumes),
            functions=tuple(self._functions),
            has_surface_maps=any(m.normal_texture >= 0 or m.bump_texture >= 0
                                 for m in self._materials),
            bvh_builder=builder,
        )
