"""The entry points of __graft_entry__.py, on the port.

entry(device)            -> (fn, example_args): one differentiable render
                            of the Cornell flagship scene.
dryrun_multichip(n, device)
                         -> an n-rank (dp, sp) mesh that runs one sharded
                            render and ONE full training step (sharded
                            forward, backward, gradient all_reduce, SGD
                            update) on tiny shapes, and prints
                            "dryrun_multichip(n): mesh dp=.. sp=.. loss=.. OK".

One rank a device: on the card, one NCCL rank a card; on the CPU, n gloo
processes. dryrun_multichip starts the n ranks itself, each as

    python -m ptsharp_tpu_torch.parallel.entry <port> <n> <rank> <cuda|cpu>
"""

from __future__ import annotations

import os
import sys

import torch

from ptsharp_tpu_torch import examples
from ptsharp_tpu_torch.camera import Camera
from ptsharp_tpu_torch.core import device as devices
from ptsharp_tpu_torch.core import rng
from ptsharp_tpu_torch.diff import render_image
from ptsharp_tpu_torch.geometry.mesh import cube_mesh
from ptsharp_tpu_torch.integrator import IntegratorConfig
from ptsharp_tpu_torch.materials import diffuse_material, light_material
from ptsharp_tpu_torch.parallel import distributed
from ptsharp_tpu_torch.parallel.shard import (
    make_train_step, render_image_sharded,
)
from ptsharp_tpu_torch.scene import SceneBuilder

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RANK_TIMEOUT = 600  # seconds a spawned rank may take


def entry(device=devices.DEFAULT):
    """A forward step on the flagship Cornell scene: fn(scene, key) is its
    64 x 64, 2 spp differentiable render."""
    scene, cam, _rcfg, icfg = examples.build("cornell", device=device)

    def fn(scene, key):
        return render_image(scene, cam, icfg, key, 64, 64, 2)

    return fn, (scene, rng.PRNGKey(0))


def _dryrun(n_devices: int, device) -> str:
    """The sharded render and one training step, as this rank of the
    default group."""
    sp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    dp = n_devices // sp
    mesh = distributed.global_mesh(dp, sp, device)

    # tiny Cornell + a cube mesh so the BVH path shards too
    b = SceneBuilder()
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.7, 0.7, 0.7]))
    b.add_mesh(cube_mesh([-0.5, 0, -0.5], [0.5, 1, 0.5]),
               diffuse_material([0.6, 0.3, 0.2]))
    b.add_sphere([2, 4, -2], 1.0, light_material([1, 1, 1], 8.0))
    # the production mesh path: the fat table and the ordered kernels
    # (#1 closest-hit, #2 any-hit shadows) under the sharded train step
    scene = b.build(leaf_size=4, intersector="pallas", wide_k=8,
                    device=mesh.device)
    cam = Camera.look_at([0, 1.5, -4], [0, 0.5, 0], [0, 1, 0], 40.0,
                         device=mesh.device)
    icfg = IntegratorConfig(max_bounces=2)

    height = max(8, dp * 4)
    width = 8
    spp = 2 * sp

    img = render_image_sharded(scene, cam, icfg, rng.PRNGKey(0), width,
                               height, spp, mesh)
    if img.shape != (height, width, 3) or not bool(
            torch.isfinite(img).all()):
        raise AssertionError(f"sharded render: {tuple(img.shape)}, finite "
                             f"{bool(torch.isfinite(img).all())}")

    step = make_train_step(cam, icfg, width, height, spp, mesh, lr=0.1)
    target = torch.zeros((height, width, 3), device=mesh.device)
    new_scene, loss = step(scene, rng.PRNGKey(1), target)
    if not (bool(torch.isfinite(loss))
            and bool(torch.isfinite(new_scene.materials.color).all())):
        raise AssertionError("the train step's loss or colors are not finite")
    return (f"dryrun_multichip({n_devices}): mesh dp={dp} sp={sp} "
            f"loss={float(loss):.6f} OK")


def dryrun_multichip(n_devices: int, device=devices.DEFAULT) -> None:
    """Run the sharded training step on an n-rank mesh: one rank a card
    over NCCL (device "cuda"), or n gloo processes (device "cpu")."""
    dev = devices.resolve(device)
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise AssertionError(f"need {n_devices} devices, have "
                             f"{torch.cuda.device_count()}")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                   if p])
    port = distributed.free_port()
    outs = distributed.run_ranks(
        [[sys.executable, "-m", "ptsharp_tpu_torch.parallel.entry", str(port),
          str(n_devices), str(rank), dev.type] for rank in range(n_devices)],
        RANK_TIMEOUT, cwd=_ROOT, env=env)
    ok = [line for line in outs[0].splitlines()
          if line.startswith("dryrun_multichip(")]
    if len(ok) != 1:
        raise RuntimeError(f"dryrun_multichip({n_devices}): rank 0 printed "
                           f"no result:\n{outs[0][-3000:]}")
    print(ok[0], flush=True)


def _rank_main(argv) -> int:
    port, n, rank, kind = int(argv[0]), int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)
    device = f"cuda:{rank}" if kind == "cuda" else "cpu"
    distributed.initialize(f"localhost:{port}", n, rank, device=device)
    try:
        line = _dryrun(n, device)
    finally:
        distributed.shutdown()
    if rank == 0:
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1:]))
