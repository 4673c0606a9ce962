"""The port's host scene build against the JAX package's.

Tolerance: byte-equal. The fat traversal table, the kernel-slot maps,
max_stack_bound, the walk order, the slot-ordered triangle attributes and
the material table must be identical for the two-mesh scene of
tests/test_tpu_compiled.py, for _bunny_mesh(3) at leaf 14, K=8, and for
examples.dragon_hd(subdivisions=3, intersector="pallas", wide_k=8) with
the preorder walk. split_fat of the port's fat table must be the JAX
scene's own node and leaf tables, p_rows and p_leaf, for those scenes
and for the two-mesh scene at K=4.
"""

import numpy as np
import pytest
import torch

from ptsharp_tpu import examples as jex
from ptsharp_tpu.geometry import mesh as jmesh
from ptsharp_tpu.materials import diffuse_material as jdiffuse
from ptsharp_tpu.pallas import hbm_kernel, ordered_kernel
from ptsharp_tpu.scene import SceneBuilder as JBuilder

from ptsharp_tpu_torch import examples as tex
from ptsharp_tpu_torch import scene as tscene
from ptsharp_tpu_torch.accel import tables
from ptsharp_tpu_torch.geometry import mesh as tmesh
from ptsharp_tpu_torch.materials import diffuse_material as tdiffuse
from ptsharp_tpu_torch.scene import SceneBuilder as TBuilder


def _two_mesh(builder, mesh, diffuse, k=8, **kw):
    b = builder()
    b.add_mesh(mesh.sphere_mesh([0, 0.4, 0], 1.0, subdivisions=3),
               diffuse([0.5, 0.5, 0.5]))
    b.add_mesh(mesh.cube_mesh([1.6, -0.3, -0.3], [2.2, 0.3, 0.3]),
               diffuse([0.9, 0.6, 0.2]))
    return b.build(leaf_size=8, intersector="pallas", wide_k=k, **kw)


def _bunny(builder, ex, diffuse, **kw):
    b = builder()
    b.add_mesh(ex._bunny_mesh(3), diffuse([0.5, 0.5, 0.5]))
    return b.build(leaf_size=14, intersector="pallas", wide_k=8, **kw)


def _dragon_hd3(ex, **kw):
    return ex.dragon_hd(30, 17, subdivisions=3, intersector="pallas",
                        wide_k=8, pallas_ordered=False, **kw)[0]


SCENES = {
    "two_mesh": (lambda: _two_mesh(JBuilder, jmesh, jdiffuse),
                 lambda: _two_mesh(TBuilder, tmesh, tdiffuse,
                                   device="cpu")),
    "bunny3": (lambda: _bunny(JBuilder, jex, jdiffuse),
               lambda: _bunny(TBuilder, tex, tdiffuse, device="cpu")),
    "dragon_hd3_preorder": (lambda: _dragon_hd3(jex),
                            lambda: _dragon_hd3(tex, device="cpu")),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def pair(request):
    make_ref, make_port = SCENES[request.param]
    return make_ref(), make_port()


def _ref_fat(sj):
    if sj.p_hbm:
        return np.asarray(sj.p_rows)
    return np.asarray(hbm_kernel.pack_fat(sj.p_rows, sj.p_leaf, sj.max_leaf))


def test_fat_table_byte_equal(pair):
    sj, st = pair
    fat = st.p_fat.numpy()
    assert fat.shape[1] == 128 and fat.shape[0] % 2 == 0
    np.testing.assert_array_equal(fat.view(np.int32),
                                  _ref_fat(sj).view(np.int32))
    if not sj.p_hbm:  # the reference's own fat copy too
        np.testing.assert_array_equal(fat.view(np.int32),
                                      np.asarray(sj.p_fat).view(np.int32))


def _assert_split_equal(sj, st):
    rows, leaf = tables.split_fat(st.p_fat.numpy(), st.max_leaf)
    assert rows.flags.c_contiguous and leaf.flags.c_contiguous
    np.testing.assert_array_equal(rows.view(np.int32),
                                  np.asarray(sj.p_rows).view(np.int32))
    np.testing.assert_array_equal(leaf.view(np.int32),
                                  np.asarray(sj.p_leaf).view(np.int32))


def test_split_fat_is_the_reference_rows_and_leaf(pair):
    sj, st = pair
    assert not sj.p_hbm  # VMEM-scale: the reference keeps both forms
    _assert_split_equal(sj, st)


def test_split_fat_at_k4():
    sj = _two_mesh(JBuilder, jmesh, jdiffuse, k=4)
    st = _two_mesh(TBuilder, tmesh, tdiffuse, k=4, device="cpu")
    assert st.wide_k == 4
    _assert_split_equal(sj, st)


def test_slot_maps_byte_equal(pair):
    sj, st = pair
    np.testing.assert_array_equal(st.p_slot_tri.numpy(),
                                  np.asarray(sj.p_slot_tri))
    np.testing.assert_array_equal(st.p_slot_inst.numpy(),
                                  np.asarray(sj.p_slot_inst))
    assert st.p_inst_base == tuple(sj.p_inst_base)
    assert st.p_inst_end == tuple(sj.p_inst_end)


def test_max_stack_bound_equal(pair):
    sj, st = pair
    ref = ordered_kernel.max_stack_bound(np.asarray(sj.p_rows), sj.wide_k)
    assert st.p_stack_bound == ref
    assert tables.max_stack_bound(st.p_fat.numpy()[0::2], st.wide_k) == ref
    assert 0 < ref <= 64


@pytest.mark.parametrize("name", ["tri_n0", "tri_n1", "tri_n2", "tri_uv0",
                                  "tri_uv2", "tri_mat", "inst_inv",
                                  "inst_mat"])
def test_triangle_attributes_byte_equal(pair, name):
    sj, st = pair
    a = getattr(st, name).numpy()
    b = np.asarray(getattr(sj, name))
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def test_walk_order_equal(pair):
    sj, st = pair
    assert st.p_ordered == bool(sj.p_ordered)


def test_material_table_byte_equal(pair):
    sj, st = pair
    for name in st.materials._fields:
        a = getattr(st.materials, name).numpy()
        b = np.asarray(getattr(sj.materials, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("ordered", [True, False])
def test_stack_bound_limits_only_the_ordered_walk(monkeypatch, ordered):
    """Past the ordered kernels' stack capacity an ordered scene's build
    raises; a preorder scene keeps no stack and builds."""
    monkeypatch.setattr(tscene, "STACK_CAPACITY", 2)
    b = TBuilder()
    b.add_mesh(tmesh.sphere_mesh([0, 0.4, 0], 1.0, subdivisions=3),
               tdiffuse([0.5, 0.5, 0.5]))
    if ordered:
        with pytest.raises(ValueError, match="stack"):
            b.build(leaf_size=8, intersector="pallas", wide_k=8,
                    device="cpu")
    else:
        st = b.build(leaf_size=8, intersector="pallas", wide_k=8,
                     pallas_ordered=False, device="cpu")
        assert st.p_stack_bound > 2 and not st.p_ordered
        assert st.p_fat.dtype == torch.float32


def test_bunny_mesh_copy_is_identical():
    a, b = tex._bunny_mesh(3), jex._bunny_mesh(3)
    np.testing.assert_array_equal(a.v, b.v)
    np.testing.assert_array_equal(a.n, b.n)
    np.testing.assert_array_equal(a.uv, b.uv)
