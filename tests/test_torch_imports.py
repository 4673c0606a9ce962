"""The port stands alone: importing ptsharp_tpu_torch and every one of its
modules, in a fresh interpreter, loads neither jax nor ptsharp_tpu; the
whole catalog builds, and iterative_render takes every option of the JAX
package's. The traversal layers point one way: the plain walks import no
kernel module, the kernel loader nothing of the package, and nothing
reaches a private name of the kernel wrappers."""

import ast
import glob
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest

import ptsharp_tpu_torch
from ptsharp_tpu_torch import convert, examples, film
from ptsharp_tpu_torch.materials import diffuse_material, light_material
from ptsharp_tpu_torch.renderer import RenderConfig, Renderer
from ptsharp_tpu_torch.scene import SceneBuilder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = sorted(m.name for m in pkgutil.walk_packages(
    ptsharp_tpu_torch.__path__, "ptsharp_tpu_torch."))


def test_every_module_imports_without_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'ptsharp_tpu' or m.startswith('ptsharp_tpu.')]\n"
        "print(len(sys.modules)); sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert len(MODULES) >= 20


@pytest.mark.parametrize("module", ["ptsharp_tpu_torch.accel.traverse",
                                    "ptsharp_tpu_torch.accel.cluster",
                                    "ptsharp_tpu_torch.core.device",
                                    "ptsharp_tpu_torch.tape",
                                    "ptsharp_tpu_torch.diff",
                                    "ptsharp_tpu_torch.core.transform",
                                    "ptsharp_tpu_torch.core.color",
                                    "ptsharp_tpu_torch.core.poisson",
                                    "ptsharp_tpu_torch.geometry.march",
                                    "ptsharp_tpu_torch.geometry.sdf",
                                    "ptsharp_tpu_torch.geometry.volume",
                                    "ptsharp_tpu_torch.geometry.function",
                                    "ptsharp_tpu_torch.geometry.mc",
                                    "ptsharp_tpu_torch.geometry.sh_shape",
                                    "ptsharp_tpu_torch.io.obj",
                                    "ptsharp_tpu_torch.io.stl",
                                    "ptsharp_tpu_torch.io.mol",
                                    "ptsharp_tpu_torch.checkpoint",
                                    "ptsharp_tpu_torch.denoise",
                                    "ptsharp_tpu_torch.viewer",
                                    "ptsharp_tpu_torch.profiling",
                                    "ptsharp_tpu_torch.version",
                                    "ptsharp_tpu_torch.examples",
                                    "ptsharp_tpu_torch.parallel.mesh",
                                    "ptsharp_tpu_torch.parallel.distributed",
                                    "ptsharp_tpu_torch.parallel.shard",
                                    "ptsharp_tpu_torch.parallel.entry"])
def test_new_module_imports_without_jax(module):
    """The XLA walks' modules, the device default, the tape, the
    differentiable render, the transforms and colour constructors, the
    marched shapes, meshing and mesh I/O, the checkpoint, denoiser,
    viewer, profiling and version modules, the catalog and the sharding
    modules, each alone."""
    assert module in MODULES
    code = (f"import importlib, sys; importlib.import_module({module!r})\n"
            "sys.exit(any(m.split('.')[0] in ('jax', 'ptsharp_tpu')"
            " for m in sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imports(path):
    """(module, names) of every import in the file at `path`, relative to
    the repository: names None for `import module`."""
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, None
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, [a.name for a in node.names]


def _private_wrapper_names(path):
    """The underscore names that the file at `path` takes from
    kernels.traverse, by import or as an attribute of the module."""
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read())
    wrappers = "ptsharp_tpu_torch.kernels.traverse"
    aliases, found = set(), []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == wrappers:
            found += [a.name for a in node.names if a.name.startswith("_")]
        elif isinstance(node, ast.ImportFrom) \
                and node.module == "ptsharp_tpu_torch.kernels":
            aliases |= {a.asname or a.name for a in node.names
                        if a.name == "traverse"}
        elif isinstance(node, ast.Import):
            aliases |= {a.asname for a in node.names
                        if a.name == wrappers and a.asname}
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr.startswith("_") \
                and isinstance(node.value, ast.Name) \
                and node.value.id in aliases:
            found.append(node.attr)
    return found


@pytest.mark.parametrize("arrow", ["plain_walks", "loader", "private"])
def test_traversal_imports_point_one_way(arrow):
    """accel/traverse.py (the plain walks) imports no module of kernels/;
    kernels/build.py (the library and its one launch path) imports no
    module of the package; and no file of the package, its tests or the
    card scripts takes an underscore name from kernels.traverse."""
    if arrow == "plain_walks":
        bad = [m for m, _n in _imports("ptsharp_tpu_torch/accel/traverse.py")
               if m.startswith("ptsharp_tpu_torch.kernels")
               or (m == "ptsharp_tpu_torch" and "kernels" in (_n or ()))]
    elif arrow == "loader":
        bad = [m for m, _n in _imports("ptsharp_tpu_torch/kernels/build.py")
               if m.split(".")[0] == "ptsharp_tpu_torch"]
    else:
        files = sorted(
            os.path.relpath(p, REPO) for pattern in (
                "ptsharp_tpu_torch/**/*.py", "tests/*.py", "chip_*.py")
            for p in glob.glob(os.path.join(REPO, pattern), recursive=True))
        files.remove(os.path.join("ptsharp_tpu_torch", "kernels",
                                  "traverse.py"))
        assert len(files) > 80
        bad = [(path, name) for path in files
               for name in _private_wrapper_names(path)]
    assert not bad


@pytest.mark.parametrize("entry", ["build", "example", "look_at",
                                   "film", "scene_from_reference",
                                   "camera_from_reference",
                                   "diff_params_from_reference"])
def test_entry_points_default_to_the_card(entry):
    """Without a card, each entry point's default device raises; nothing
    moves to the CPU on its own."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults run on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "build":
            _plain_builder().build()
        elif entry == "example":
            examples.cornell(8, 8)
        elif entry == "look_at":
            ptsharp_tpu_torch.Camera.look_at([0, 1, -4], [0, 1, 0],
                                             [0, 1, 0], 40.0)
        elif entry == "film":
            ptsharp_tpu_torch.Film.zeros(2, 2)
        elif entry == "scene_from_reference":
            convert.scene_from_reference({}, {})
        elif entry == "diff_params_from_reference":
            convert.diff_params_from_reference({})
        else:
            convert.camera_from_reference({})


def test_public_names_match_the_reference_layout():
    for name in ("SceneBuilder", "SceneData", "Camera", "Film",
                 "IntegratorConfig", "Renderer", "RenderConfig",
                 "trace_tape_radiance"):
        assert hasattr(ptsharp_tpu_torch, name)
        assert name in ptsharp_tpu_torch.__all__
    from ptsharp_tpu_torch.integrator import trace, trace_compacted_static
    from ptsharp_tpu_torch.intersect import closest_hit, occlusion_query
    assert all(callable(f) for f in (trace, trace_compacted_static,
                                     closest_hit, occlusion_query,
                                     examples.build))


def _plain_builder():
    b = SceneBuilder()
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.5, 0.5, 0.5]))
    return b


@pytest.mark.parametrize("what", ["example"])
def test_outside_the_slice_raises(what):
    """Nothing is outside the slice any more: "dragon" builds, and only a
    name the catalog does not hold raises, as in the JAX package."""
    assert examples.build("dragon", device="cpu")[0].has_meshes
    with pytest.raises(KeyError):
        examples.build("no_such_scene", device="cpu")


def test_iterative_render_options_outside_the_slice_raise():
    """denoise, checkpoints and the viewer no longer raise."""
    b = _plain_builder()
    b.add_sphere([0, 3, 0], 0.5, light_material([1, 1, 1], 5.0))
    scene = b.build(device="cpu")
    cam = ptsharp_tpu_torch.Camera.look_at([0, 1, -4], [0, 1, 0],
                                           [0, 1, 0], 40.0, device="cpu")
    r = Renderer(scene, cam, RenderConfig(18, 18, spp=1))
    out = r.iterative_render(1, denoise=True)
    assert float(out.n.mean()) == 1.0
    out = r.iterative_render(2)
    assert float(out.n.mean()) == 2.0 and r.rays_traced > 0


def test_save_png_writes_an_image(tmp_path):
    path = tmp_path / "out.png"
    film.save_png(np.full((4, 5, 3), 0.5, np.float32), str(path))
    assert path.stat().st_size > 0
