"""One rank of the four-rank train cell (traffic/train_4card.json) at toy
size on the CPU, with the gradient's all_reduce left out (the exchange
between chips) unless `sound`, for test_perfbench_faults:
python -c "from perfbench.tests import rank_fault; rank_fault.main(rank,
port, sound)"."""

import sys

import torch


def _no_exchange(scene, camera, cfg, key, target, width, height, spp, mesh,
                 use_tape=True):
    """parallel/shard.loss_and_grad without its gradient all_reduce: each
    rank keeps its own share."""
    from dataclasses import replace

    from ptsharp_tpu_torch.core import vec
    from ptsharp_tpu_torch.parallel import shard

    with torch.enable_grad():
        colors = scene.materials.color.detach().clone().requires_grad_()
        s = replace(scene, materials=scene.materials._replace(color=colors))
        img = shard.render_image_sharded(s, camera, cfg, key, width, height,
                                         spp, mesh, use_tape=use_tape)
        loss = vec.div(torch.sum((img - target) ** 2), img.numel())
        (g,) = torch.autograd.grad(loss, colors)
    return loss.detach(), g


def main(rank: int, port: int, sound: bool = False, seed: int = 13) -> None:
    from perfbench import run
    from ptsharp_tpu_torch.parallel import shard

    def hook(step):
        if not sound:
            shard.loss_and_grad = _no_exchange
        return step

    sys.exit(run.main(["--workload", "bunny.train_4card", "--seed",
                       str(seed), "--seconds", "1", "--trace", "0",
                       "--cpu-toy", "--rank", str(rank), "--port",
                       str(port)], hooks={"step": hook}))
