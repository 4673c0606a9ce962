"""Carry a scene and a camera built by the JAX package into the port.

`scene_from_reference` turns the arrays of a ptsharp_tpu SceneData, taken
as numpy, into the port's SceneData, so one scene can run through both
packages even where a rebuild could differ; `diff_params_from_reference`
does the same for the tape's DiffParams. They take plain dicts and never
import the JAX package:

  fields: the reference's data fields by name (numpy arrays); the nested
          `materials` and `textures` tables as dicts of arrays (or any
          object with `_asdict()`).
  meta:   the reference's static metadata fields by name.

For intersector "pallas" the traversal table is the reference's fat
interleave: `p_fat`, or `p_rows` where the reference streams its tables
from HBM (`p_hbm`); flat or per-instance (`p_flat`) and the walk order
(`p_ordered`) carry over as they are. For the XLA walks ("wide", "walk",
"cluster") the reference's row tables (u_rows, w_rows, leaf_rows, the
cluster tables), each instance's ranges in them, the TLAS heads' row
counts and `use_tlas` carry over. The slot-ordered edges `tri_e1`/`tri_e2`
(the port shares the reference's slot order), the mesh lights' `em_*`
and `light_tri_*` tables and `has_surface_maps` carry over as they are.

The marched shapes: SDF trees carry over node by node (`sdf_from_reference`
reads each node's class name and fields: numbers, arrays, a transform's
4x4), volumes as their numpy grids and windows. A heightfield's `f` is a
jnp callable, which cannot run without JAX, so `scene_from_reference`
takes the matching torch callables (`functions=[...]`, one per
heightfield, in order).

Each function puts the tensors on the card unless device="cpu" is asked
for.
"""

from __future__ import annotations

import numpy as np
import torch

from ptsharp_tpu_torch.accel import tables
from ptsharp_tpu_torch.camera import Camera
from ptsharp_tpu_torch.core import device as devices
from ptsharp_tpu_torch.geometry import sdf as sdf_mod
from ptsharp_tpu_torch.geometry.function import Heightfield
from ptsharp_tpu_torch.geometry.volume import VolumeGrid, VolumeWindow
from ptsharp_tpu_torch.materials import MaterialTable
from ptsharp_tpu_torch.scene import (
    SceneData, check_stack_bound, inst_range, no_xla_tables,
)
from ptsharp_tpu_torch.tape import DiffParams
from ptsharp_tpu_torch.textures import TextureAtlas


# the XLA walks' tables, and the per-instance ranges in them
_XLA_TABLES = ("u_rows", "leaf_rows", "w_rows", "cluster_bmin",
               "cluster_bmax", "cluster_rows")
_XLA_RANGES = ("u_inst_base", "u_inst_end", "w_inst_base", "w_inst_end",
               "inst_cluster_base", "inst_cluster_end")
_ARRAY_FIELDS = (
    "sphere_center", "sphere_radius", "sphere_inv", "sphere_mat",
    "plane_point", "plane_normal", "plane_mat",
    "cube_min", "cube_max", "cube_inv", "cube_mat",
    "cyl_radius", "cyl_z0", "cyl_z1", "cyl_inv", "cyl_mat",
    "tri_n0", "tri_n1", "tri_n2", "tri_uv0", "tri_uv1", "tri_uv2", "tri_mat",
    "tri_e1", "tri_e2",
    "inst_inv", "inst_mat", "p_rows", "p_fat", "p_slot_tri", "p_slot_inst",
    "light_ptype", "light_pindex", "light_center", "light_radius",
    "light_mat", "light_tri_start", "light_tri_end", "light_area",
    "light_cdf", "light_pmf", "em_v0", "em_e1", "em_e2", "em_nrm", "em_cdf",
    "em_mat", "env_color", "texture_angle",
) + _XLA_TABLES + _XLA_RANGES
_META_FIELDS = (
    "use_tlas", "sdf_objects", "volumes", "functions", "has_surface_maps",
    "light_types", "intersector", "p_flat", "p_ordered", "p_hbm", "wide_k",
    "env_texture", "sphere_xform", "cube_xform", "cyl_xform", "max_leaf",
    "p_inst_base", "p_inst_end", "tlas_end", "w_tlas_end",
)


# SDF primitives: class name -> its fields
_SDF_PRIMITIVES = {
    "SdfSphere": ("radius", "exponent"),
    "SdfCube": ("size",),
    "SdfCylinder": ("radius", "height"),
    "SdfCapsule": ("a", "b", "radius", "exponent"),
    "SdfTorus": ("major", "minor", "major_exponent", "minor_exponent"),
}
_SDF_OPERATORS = ("SdfUnion", "SdfDifference", "SdfIntersection")


def _number(x):
    a = np.asarray(x, np.float32)
    return float(a) if a.ndim == 0 else a


def sdf_from_reference(node) -> sdf_mod.Sdf:
    """The port's copy of a reference SDF tree, read node by node by class
    name and fields."""
    name = type(node).__name__
    if name in _SDF_PRIMITIVES:
        return getattr(sdf_mod, name)(**{f: _number(getattr(node, f))
                                         for f in _SDF_PRIMITIVES[name]})
    if name in _SDF_OPERATORS:
        return getattr(sdf_mod, name)(*(sdf_from_reference(c)
                                        for c in node.items))
    if name == "SdfTransform":
        return sdf_mod.SdfTransform(sdf_from_reference(node.sdf),
                                    np.asarray(node.matrix, np.float32))
    if name == "SdfScale":
        return sdf_mod.SdfScale(sdf_from_reference(node.sdf),
                                _number(node.factor))
    if name == "SdfRepeat":
        return sdf_mod.SdfRepeat(sdf_from_reference(node.sdf), node.step,
                                 node._lo, node._hi)
    raise ValueError(f"no SDF node {name!r} in the port")


def volume_from_reference(vol) -> VolumeGrid:
    """The port's VolumeGrid of a reference one: its numpy grid, windows
    and box."""
    return VolumeGrid(
        data=np.asarray(vol.data, np.float32),
        windows=[VolumeWindow(float(w.lo), float(w.hi), int(w.material_id))
                 for w in vol.windows],
        bmin=np.asarray(vol.bmin, np.float32),
        bmax=np.asarray(vol.bmax, np.float32))


def _as_dict(x) -> dict:
    return dict(x._asdict()) if hasattr(x, "_asdict") else dict(x)


def reference_arrays(ref_scene) -> tuple[dict, dict]:
    """(fields, meta) of a reference SceneData object, read by attribute
    name, with every array as numpy."""
    fields = {name: np.asarray(getattr(ref_scene, name))
              for name in _ARRAY_FIELDS}
    for name in ("materials", "textures"):
        fields[name] = {k: np.asarray(v) for k, v in
                        _as_dict(getattr(ref_scene, name)).items()}
    fields["volume_data"] = [np.asarray(v) for v in ref_scene.volume_data]
    meta = {name: getattr(ref_scene, name) for name in _META_FIELDS}
    return fields, meta


def scene_from_reference(fields: dict, meta: dict, device=devices.DEFAULT,
                         functions=None) -> SceneData:
    """`functions`: the torch callables of the reference's heightfields,
    one each, in order (their jnp `f` cannot run here); ValueError where
    the reference has heightfields and they are not given."""
    dev = devices.resolve(device)
    ref_functions = tuple(meta["functions"])
    if ref_functions and (functions is None
                          or len(functions) != len(ref_functions)):
        raise ValueError(
            f"the reference scene has {len(ref_functions)} heightfield(s), "
            f"whose f is a jnp callable that cannot run without JAX: pass "
            f"their torch counterparts as functions=[...], one each")
    n_inst = np.asarray(fields["inst_inv"]).shape[0]
    pallas = meta["intersector"] == "pallas"
    slot_tri = np.asarray(fields["p_slot_tri"], np.int32)
    slot_inst = np.asarray(fields["p_slot_inst"], np.int32)
    if n_inst and pallas:
        fat = np.asarray(fields["p_rows"] if meta["p_hbm"]
                         else fields["p_fat"], np.float32)
        k = int(meta["wide_k"])
        # one range (flat), or each mesh's (non-flat; instances share them)
        spans = sorted(set(zip(meta["p_inst_base"], meta["p_inst_end"])))
        stack_bound = max(tables.max_stack_bound(fat[0::2], k, int(b), int(e))
                          for b, e in spans)
        if meta["p_ordered"]:
            check_stack_bound(stack_bound)
            tables.check_child_boxes(fat[0::2], k)
        if not meta["p_flat"]:
            # kernel slots are scene slots; the instance is the loop's
            n_slots = np.asarray(fields["tri_n0"]).shape[0]
            slot_tri = np.arange(n_slots, dtype=np.int32)
            slot_inst = np.full(n_slots, -1, np.int32)
    else:
        fat = np.zeros((0, tables.ROW), np.float32)
        stack_bound = 0

    def t(name, dtype=np.float32):
        a = np.ascontiguousarray(np.asarray(fields[name]), dtype)
        return torch.from_numpy(a.copy()).to(dev)

    if pallas:
        xla, ranges = no_xla_tables(int(meta["max_leaf"]), int(meta["wide_k"]))
    else:
        xla = {name: fields[name] for name in _XLA_TABLES}
        ranges = {name: tuple(int(x) for x in np.asarray(fields[name]))
                  for name in _XLA_RANGES}
        ranges.update((name, int(meta[name]))
                      for name in ("tlas_end", "w_tlas_end"))
    ranges_t = {name: torch.from_numpy(inst_range(
                    ranges[f"{w}_inst_base"], ranges[f"{w}_inst_end"])).to(dev)
                for name, w in (("u_inst_range", "u"), ("w_inst_range", "w"))}

    mats = _as_dict(fields["materials"])
    tex = _as_dict(fields["textures"])
    return SceneData(
        device=dev,
        sphere_center=t("sphere_center"),
        sphere_radius=t("sphere_radius"),
        sphere_inv=t("sphere_inv"),
        sphere_mat=t("sphere_mat", np.int32),
        plane_point=t("plane_point"),
        plane_normal=t("plane_normal"),
        plane_mat=t("plane_mat", np.int32),
        cube_min=t("cube_min"),
        cube_max=t("cube_max"),
        cube_inv=t("cube_inv"),
        cube_mat=t("cube_mat", np.int32),
        cyl_radius=t("cyl_radius"),
        cyl_z0=t("cyl_z0"),
        cyl_z1=t("cyl_z1"),
        cyl_inv=t("cyl_inv"),
        cyl_mat=t("cyl_mat", np.int32),
        tri_n0=t("tri_n0"),
        tri_n1=t("tri_n1"),
        tri_n2=t("tri_n2"),
        tri_uv0=t("tri_uv0"),
        tri_uv1=t("tri_uv1"),
        tri_uv2=t("tri_uv2"),
        tri_mat=t("tri_mat", np.int32),
        tri_e1=t("tri_e1"),
        tri_e2=t("tri_e2"),
        inst_inv=t("inst_inv"),
        inst_mat=t("inst_mat", np.int32),
        p_fat=torch.from_numpy(fat.copy()).to(dev),
        p_slot_tri=torch.from_numpy(slot_tri.copy()).to(dev),
        p_slot_inst=torch.from_numpy(slot_inst.copy()).to(dev),
        **{name: torch.from_numpy(np.array(a, np.float32)).to(dev)
           for name, a in xla.items()},
        **ranges_t,
        light_ptype=t("light_ptype", np.int32),
        light_pindex=t("light_pindex", np.int32),
        light_center=t("light_center"),
        light_radius=t("light_radius"),
        light_mat=t("light_mat", np.int32),
        light_tri_start=t("light_tri_start", np.int32),
        light_tri_end=t("light_tri_end", np.int32),
        light_area=t("light_area"),
        light_cdf=t("light_cdf"),
        light_pmf=t("light_pmf"),
        em_v0=t("em_v0"),
        em_e1=t("em_e1"),
        em_e2=t("em_e2"),
        em_nrm=t("em_nrm"),
        em_cdf=t("em_cdf"),
        em_mat=t("em_mat", np.int32),
        materials=MaterialTable.from_arrays(mats, dev),
        textures=TextureAtlas.from_arrays(tex["data"], tex["sizes"], dev),
        volume_data=tuple(torch.from_numpy(np.array(v, np.float32)).to(dev)
                          for v in fields.get("volume_data", ())),
        env_color=t("env_color"),
        texture_angle=float(np.asarray(fields["texture_angle"])),
        env_texture=int(meta["env_texture"]),
        sphere_xform=bool(meta["sphere_xform"]),
        cube_xform=bool(meta["cube_xform"]),
        cyl_xform=bool(meta["cyl_xform"]),
        max_leaf=int(meta["max_leaf"]),
        wide_k=int(meta["wide_k"]),
        intersector=str(meta["intersector"]),
        use_tlas=bool(meta["use_tlas"]),
        p_flat=bool(meta["p_flat"]),
        p_ordered=bool(meta["p_ordered"]),
        p_inst_base=tuple(int(b) for b in meta["p_inst_base"]),
        p_inst_end=tuple(int(e) for e in meta["p_inst_end"]),
        p_stack_bound=int(stack_bound),
        **ranges,
        light_types=tuple(int(x) for x in meta["light_types"]),
        sdf_objects=tuple((sdf_from_reference(node), int(mid),
                           tuple(map(float, lo)), tuple(map(float, hi)))
                          for node, mid, lo, hi in meta["sdf_objects"]),
        volumes=tuple(volume_from_reference(v) for v in meta["volumes"]),
        functions=tuple(
            (Heightfield(f=f, bmin=np.asarray(hf.bmin, np.float32),
                         bmax=np.asarray(hf.bmax, np.float32)), int(mid))
            for f, (hf, mid) in zip(functions or (), ref_functions)),
        has_surface_maps=bool(meta["has_surface_maps"]),
        bvh_builder="reference",
    )


def camera_from_reference(fields: dict,
                          device=devices.DEFAULT) -> Camera:
    """fields: the reference Camera's fields by name (numpy arrays)."""
    device = devices.resolve(device)
    return Camera(**{name: torch.as_tensor(np.array(fields[name]),
                                           dtype=torch.float32, device=device)
                     for name in Camera._fields})


def diff_params_from_reference(fields: dict,
                               device=devices.DEFAULT) -> DiffParams:
    """fields: the reference DiffParams' leaves by name (numpy arrays), or
    any object with `_asdict()`."""
    dev = devices.resolve(device)
    fields = _as_dict(fields)
    return DiffParams(*(torch.from_numpy(np.array(fields[name], np.float32))
                        .to(dev) for name in DiffParams._fields))
