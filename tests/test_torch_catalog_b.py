"""The rest of the catalog, second part: suzanne, gopher, cylinder_field,
hits and craft rendered by the port against the JAX package at 32x24,
1 spp, from the same key, through convert and through the port's own
build (tests/test_torch_catalog_a.py's check_scene and its tolerances;
hits and craft are OUTLIERS there, and tests/test_torch_catalog_c.py
shows why)."""

import pytest

from tests.test_torch_catalog_a import check_scene

SCENES = ("suzanne", "gopher", "cylinder_field", "hits", "craft")


@pytest.mark.parametrize("name", SCENES)
def test_catalog_render_matches(name):
    scene = check_scene(name)[0]
    if name == "suzanne":
        assert scene.intersector == "wide" and not scene.use_tlas
    elif name == "craft":  # hundreds of textured cubes: the TLAS
        assert scene.use_tlas and scene.textures.nontrivial
    else:
        assert not scene.has_meshes and not scene.use_tlas
