"""SPMD rendering over the ranks of a (dp, sp) mesh.

Counterpart of ptsharp_tpu/parallel/shard.py, where shard_map runs one
program on every device of a jax Mesh. Here every rank of the process
group runs the same Python:

  * image rows      -> "dp" axis: rank (i, j) owns rows
                       i * H/dp ... (i + 1) * H/dp
  * samples / pixel -> "sp" axis: it traces spp/sp samples of them, on
                       its own key, fold_in(fold_in(key, i), j)
  * scene + BVH     -> replicated on every rank
  * film merge      -> each rank writes its rows' sample mean into a zeroed
                       (H, W, 3) image; one all_reduce (SUM) over the
                       group and a division by sp give every rank the
                       whole image (adding zeros is exact, so at sp <= 2
                       the bits do not depend on the ranks' order)
  * gradients       -> each rank's graph holds its own rows and samples;
                       its backward gives its share of the gradient, and
                       one all_reduce (SUM) of the shares gives the
                       gradient of the whole image's loss

The only collectives are all_reduce (SUM) over the default group, which
NCCL runs between cards and gloo between CPU processes or on CUDA
tensors of ranks that share a card.
"""

from __future__ import annotations

from dataclasses import replace

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ptsharp_tpu_torch import profiling
from ptsharp_tpu_torch.camera import Camera
from ptsharp_tpu_torch.core import rng, vec
from ptsharp_tpu_torch.integrator import IntegratorConfig, trace
from ptsharp_tpu_torch.parallel.mesh import Mesh
from ptsharp_tpu_torch.scene import SceneData
from ptsharp_tpu_torch.tape import trace_tape_radiance


def render_shard(scene: SceneData, camera: Camera, cfg: IntegratorConfig,
                 key, width: int, height: int, spp: int, dp: int, sp: int,
                 dp_index: int, sp_index: int,
                 use_tape: bool = False) -> torch.Tensor:
    """Rank (dp_index, sp_index)'s share of a dp x sp sharded render: the
    mean radiance (H/dp, W, 3) of its spp/sp samples of its rows, the body
    of the JAX package's shard_map before its pmean over "sp". Any mesh
    can be rebuilt in one process from these calls."""
    if height % dp != 0:
        raise AssertionError(f"height {height} % dp {dp} != 0")
    if spp % sp != 0:
        raise AssertionError(f"spp {spp} % sp {sp} != 0")
    rows_per = height // dp
    spp_per = spp // sp
    dev = scene.device
    lkey = rng.fold_in(rng.fold_in(key, dp_index), sp_index)
    ys = dp_index * rows_per + torch.arange(rows_per, device=dev)
    yy, xx = torch.meshgrid(ys, torch.arange(width, device=dev),
                            indexing="ij")
    shape = (spp_per, rows_per, width)
    pix_x = torch.broadcast_to(xx[None], shape).reshape(-1)
    pix_y = torch.broadcast_to(yy[None], shape).reshape(-1)
    kj, kt = rng.split(lkey)
    ju, jv = rng.uniform(kj, (2, pix_x.shape[0]), device=dev)
    org, dirn = camera.to(dev).cast_rays(pix_x, pix_y, width, height, ju, jv)
    tracer = trace_tape_radiance if use_tape else trace
    result = tracer(scene, cfg, org, dirn, kt)
    return torch.mean(result.radiance.reshape(spp_per, rows_per, width, 3),
                      dim=0)


class _SumRanks(torch.autograd.Function):
    """all_reduce (SUM) over the default group; the backward passes the
    gradient through unchanged, so each rank's backward stays in its own
    graph and yields its share."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, g):
        return g


def render_image_sharded(scene: SceneData, camera: Camera,
                         cfg: IntegratorConfig, key, width: int, height: int,
                         spp: int, mesh: Mesh,
                         use_tape: bool = False) -> torch.Tensor:
    """Mean-radiance render (H, W, 3) sharded rows x samples over the
    mesh; every rank returns the whole image. height must divide by the
    mesh's dp, spp by its sp.

    Differentiable: this rank's rows and samples carry its graph, so a
    backward from a loss of the whole image gives this rank's share of the
    gradient; the shares sum to the gradient over the ranks (as
    make_train_step sums them). use_tape routes the shard's trace through
    the analytic tape backward (tape.py), with the same radiance."""
    part = render_shard(scene, camera, cfg, key, width, height, spp,
                        mesh.dp, mesh.sp, mesh.dp_index, mesh.sp_index,
                        use_tape=use_tape)
    rows_per = part.shape[0]
    row0 = mesh.dp_index * rows_per
    img = F.pad(part, (0, 0, 0, 0, row0, height - row0 - rows_per))
    if mesh.size > 1:
        img = _SumRanks.apply(img)
    return vec.div(img, mesh.sp)


def loss_and_grad(scene: SceneData, camera: Camera, cfg: IntegratorConfig,
                  key, target: torch.Tensor, width: int, height: int,
                  spp: int, mesh: Mesh, use_tape: bool = True):
    """(loss, g): the whole image's mean((img - target)**2) and its
    gradient with respect to scene.materials.color, equal on every
    rank."""
    with torch.enable_grad():
        colors = scene.materials.color.detach().clone().requires_grad_()
        s = replace(scene, materials=scene.materials._replace(color=colors))
        with profiling.span("pt.forward"):
            img = render_image_sharded(s, camera, cfg, key, width, height,
                                       spp, mesh, use_tape=use_tape)
            loss = vec.div(torch.sum((img - target) ** 2), img.numel())
        with profiling.span("pt.backward"):
            (g,) = torch.autograd.grad(loss, colors)
    if mesh.size > 1:
        dist.all_reduce(g)
    return loss.detach(), g


def make_train_step(camera: Camera, cfg: IntegratorConfig, width: int,
                    height: int, spp: int, mesh: Mesh, lr: float = 0.5,
                    use_tape: bool = True):
    """Differentiable-render training step: SGD on the material color
    table toward a target image. step(scene, key, target) -> (new_scene,
    loss) runs the sharded forward, this rank's backward (the analytic
    tape unless use_tape is False), the gradient's all_reduce and the
    update clamp(color - lr * g, 0, 1); the loss and the new colors are
    the same bits on every rank."""

    def step(scene: SceneData, key, target: torch.Tensor):
        with profiling.span("pt.step"):
            loss, g = loss_and_grad(scene, camera, cfg, key, target, width,
                                    height, spp, mesh, use_tape=use_tape)
            with profiling.span("pt.update"):
                new_colors = torch.clamp(scene.materials.color - lr * g,
                                         0.0, 1.0)
                new_scene = replace(scene, materials=scene.materials._replace(
                    color=new_colors))
            return new_scene, loss

    return step
