"""The scenes of the port's sharding tests (tests/test_torch_parallel.py,
tests/test_torch_distributed.py): test_parallel.py's spheres and plane and
test_distributed.py's cube, written once for either package's builder.
Imports neither jax nor ptsharp_tpu, so the gloo ranks that the tests
spawn build them too."""

from ptsharp_tpu_torch.camera import Camera
from ptsharp_tpu_torch.geometry.mesh import cube_mesh
from ptsharp_tpu_torch.integrator import IntegratorConfig
from ptsharp_tpu_torch.materials import diffuse_material, light_material
from ptsharp_tpu_torch.scene import SceneBuilder


def spheres(builder, diffuse, light, _cube=None):
    """test_parallel.py's scene."""
    b = builder()
    b.add_sphere([0, 1, 0], 1.0, diffuse([0.6, 0.3, 0.2]))
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse([0.7, 0.7, 0.7]))
    b.add_sphere([3, 6, -3], 1.5, light([1, 1, 1], 6.0))
    b.set_environment(color=[0.05, 0.05, 0.05])
    return b.build()


def cube(builder, diffuse, light, cube_fn):
    """test_distributed.py's scene."""
    b = builder()
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse([0.7, 0.7, 0.7]))
    b.add_mesh(cube_fn([-0.5, 0, -0.5], [0.5, 1, 0.5]),
               diffuse([0.6, 0.3, 0.2]))
    b.add_sphere([2, 4, -2], 1.0, light([1, 1, 1], 8.0))
    return b.build(leaf_size=4)


# name: (scene, eye, center, max_bounces)
SCENES = {
    "spheres": (spheres, [0, 2, -6], [0, 1, 0], 2),
    "cube": (cube, [0, 1.5, -4], [0, 0.5, 0], 2),
}


class _CpuBuilder(SceneBuilder):
    def build(self, **kw):
        return super().build(device="cpu", **kw)


def port_case(name):
    """(scene, camera, config) of the port, built by its SceneBuilder."""
    make, eye, center, bounces = SCENES[name]
    scene = make(_CpuBuilder, diffuse_material, light_material, cube_mesh)
    cam = Camera.look_at(eye, center, [0, 1, 0], 40.0, device="cpu")
    return scene, cam, IntegratorConfig(max_bounces=bounces)
