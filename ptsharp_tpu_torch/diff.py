"""Differentiable rendering entry points.

Counterpart of ptsharp_tpu/diff.py. The integrator is a function of the
scene's tensors with every discrete decision and all traversal detached,
so autograd through `render_image` with respect to the material table,
the texture atlas and the environment color is well defined: the
reparameterized estimator of SURVEY.md section 7, step 8.

Typical use (on the card; build the scene and camera with device="cpu"
for the CPU):

    colors = scene.materials.color.clone().requires_grad_()
    s = dataclasses.replace(
        scene, materials=scene.materials._replace(color=colors))
    img = render_image(s, cam, cfg, rng.PRNGKey(0), w, h, spp)
    torch.mean((img - target) ** 2).backward()   # colors.grad
"""

from __future__ import annotations

from dataclasses import replace

import torch

from ptsharp_tpu_torch.camera import Camera
from ptsharp_tpu_torch.core import rng
from ptsharp_tpu_torch.integrator import IntegratorConfig, trace
from ptsharp_tpu_torch.scene import SceneData
from ptsharp_tpu_torch.tape import trace_tape_radiance


def render_image(scene: SceneData, camera: Camera, cfg: IntegratorConfig,
                 key, width: int, height: int, spp: int,
                 use_tape: bool = False) -> torch.Tensor:
    """Mean radiance image (H, W, 3) on the scene's device: the film-free
    differentiable render of optimization loops and gradient tests. `key`
    is a core.rng key; one wavefront of width * height * spp rays.

    use_tape: gradients by the analytic tape backward (tape.py): the same
    radiance, on its parameter contract (material color, emittance and
    tint, the environment color, the texture texels); it falls back to
    autograd through trace() where the tape does not apply."""
    dev = scene.device
    yy, xx = torch.meshgrid(torch.arange(height, device=dev),
                            torch.arange(width, device=dev), indexing="ij")
    pix_x = torch.broadcast_to(xx[None], (spp, height, width)).reshape(-1)
    pix_y = torch.broadcast_to(yy[None], (spp, height, width)).reshape(-1)
    kj, kt = rng.split(key)
    ju, jv = rng.uniform(kj, (2, pix_x.shape[0]), device=dev)
    org, dirn = camera.to(dev).cast_rays(pix_x, pix_y, width, height, ju, jv)
    tracer = trace_tape_radiance if use_tape else trace
    result = tracer(scene, cfg, org, dirn, kt)
    return torch.mean(result.radiance.reshape(spp, height, width, 3), dim=0)


def material_color_grad(scene: SceneData, camera: Camera,
                        cfg: IntegratorConfig, key, width: int, height: int,
                        spp: int, target: torch.Tensor,
                        use_tape: bool = False) -> torch.Tensor:
    """Gradient of the image MSE against `target` with respect to the
    material color table (M, 3)."""
    with torch.enable_grad():
        colors = scene.materials.color.detach().clone().requires_grad_()
        s = replace(scene, materials=scene.materials._replace(color=colors))
        img = render_image(s, camera, cfg, key, width, height, spp,
                           use_tape=use_tape)
        (g,) = torch.autograd.grad(torch.mean((img - target) ** 2), colors)
    return g
