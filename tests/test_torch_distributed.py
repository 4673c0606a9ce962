"""Real torch.distributed ranks of the port (ptsharp_tpu_torch/parallel/):
gloo processes on the CPU, each calling distributed.initialize at a
localhost rendezvous, as test_distributed.py runs the JAX package's.

Four ranks on a dp=2, sp=2 mesh render test_distributed's cube scene and
take make_train_step steps. Every rank's image equals the one-process
emulation (test_torch_parallel.emulate) bit for bit; the losses, the
gradients and the new colors are the same bits on every rank; the
gradient equals autograd over the emulated mesh's one graph (rtol 1e-5:
the all_reduce adds the ranks' shares in its own order), the loss the
JAX package's make_train_step on a 2 x 2 virtual mesh (rtol 1e-4) and
the step's change of the colors the JAX step's (rtol 1e-3, atol 1e-3 of
its largest); two steps toward black lower the loss. Two ranks read
process_summary. The children import neither jax nor ptsharp_tpu.
"""

import os
import sys
import tempfile
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptsharp_tpu.parallel import shard as jshard

from ptsharp_tpu_torch.core import rng
from ptsharp_tpu_torch.parallel import distributed

from tests.test_torch_parallel import (
    emulate, emulated_loss_grad, jax_case, jax_mesh,
)
from tests.torch_parallel_cases import port_case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = H = 8
SPP = 4
LR = 0.1
RANK_TIMEOUT = 300

_CHILD = f"W, H, SPP, LR = {W}, {H}, {SPP}, {LR}\n" + textwrap.dedent("""
import sys
import torch
torch.set_num_threads(1)
from ptsharp_tpu_torch.core import rng
from ptsharp_tpu_torch.parallel import distributed, shard
from tests.torch_parallel_cases import port_case

assert not any(m.split(".")[0] in ("jax", "ptsharp_tpu") for m in sys.modules)
port, n, rank = (int(a) for a in sys.argv[1:4])
out = sys.argv[4]
distributed.initialize(f"localhost:{port}", n, rank, device="cpu")
try:
    res = {"summary": distributed.process_summary()}
    if n == 4:
        mesh = distributed.global_mesh(dp=2, sp=2)
        scene, cam, cfg = port_case("cube")
        res["index"] = (mesh.dp_index, mesh.sp_index)
        res["img"] = shard.render_image_sharded(
            scene, cam, cfg, rng.PRNGKey(0), W, H, SPP, mesh)
        target = torch.zeros(H, W, 3)
        res["loss"], res["grad"] = shard.loss_and_grad(
            scene, cam, cfg, rng.PRNGKey(1), target, W, H, SPP, mesh)
        step = shard.make_train_step(cam, cfg, W, H, SPP, mesh, lr=LR)
        scene1, res["loss1"] = step(scene, rng.PRNGKey(1), target)
        res["colors1"] = scene1.materials.color
        res["loss2"] = step(scene1, rng.PRNGKey(2), target)[1]
    torch.save(res, f"{out}/rank{rank}.pt")
finally:
    distributed.shutdown()
""")


def run_ranks(n):
    """Each rank's saved results."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    port = distributed.free_port()
    with tempfile.TemporaryDirectory() as out:
        distributed.run_ranks(
            [[sys.executable, "-c", _CHILD, str(port), str(n), str(r), out]
             for r in range(n)], RANK_TIMEOUT, cwd=REPO, env=env)
        return [torch.load(os.path.join(out, f"rank{r}.pt"))
                for r in range(n)]


def test_two_ranks_process_summary():
    for rank, res in enumerate(run_ranks(2)):
        assert res["summary"] == {"process_index": rank, "process_count": 2,
                                  "local_devices": 1, "global_devices": 2,
                                  "platform": "cpu"}


@pytest.fixture(scope="module")
def four_ranks():
    return run_ranks(4)


def test_four_ranks_render_the_emulated_image(four_ranks):
    """dp=2, sp=2: each rank holds the whole image, bit-equal to the
    one-process emulation; the ranks sit row-major on the mesh."""
    scene, cam, cfg = port_case("cube")
    want = emulate(scene, cam, cfg, rng.PRNGKey(0), W, H, SPP, 2, 2)
    for rank, res in enumerate(four_ranks):
        assert res["index"] == divmod(rank, 2)
        assert res["summary"]["process_count"] == 4
        assert torch.equal(res["img"], want)


def test_four_ranks_agree_bit_for_bit(four_ranks):
    first = four_ranks[0]
    for res in four_ranks[1:]:
        for key in ("loss", "grad", "loss1", "colors1", "loss2"):
            assert torch.equal(res[key], first[key]), key
    assert torch.equal(first["loss"], first["loss1"])


def test_four_ranks_gradient_is_the_whole_image_gradient(four_ranks):
    """The all_reduce of the ranks' shares is the gradient of the whole
    image's loss: no factor of sp or of the world size."""
    scene, cam, cfg = port_case("cube")
    loss, g = emulated_loss_grad(scene, cam, cfg, rng.PRNGKey(1),
                                 torch.zeros(H, W, 3), W, H, SPP, 2, 2,
                                 use_tape=True)
    res = four_ranks[0]
    assert torch.equal(res["loss"], loss)
    assert float(g.abs().max()) > 0
    np.testing.assert_allclose(res["grad"].numpy(), g.numpy(), rtol=1e-5,
                               atol=1e-7 * float(g.abs().max()))
    assert torch.equal(res["colors1"], torch.clamp(
        scene.materials.color - LR * res["grad"], 0.0, 1.0))


def test_four_ranks_match_the_jax_step(four_ranks):
    """The JAX package's make_train_step on a 2 x 2 virtual mesh: the same
    loss, and the same change of the colors."""
    sj, jcam, jcfg = jax_case("cube")
    step = jshard.make_train_step(jcam, jcfg, W, H, SPP, jax_mesh(2, 2),
                                  lr=LR)
    jscene, jloss = step(sj, jax.random.PRNGKey(1),
                         jnp.zeros((H, W, 3), jnp.float32))
    res = four_ranks[0]
    np.testing.assert_allclose(float(res["loss1"]), float(jloss), rtol=1e-4)
    c0 = np.asarray(sj.materials.color)
    want = c0 - np.asarray(jscene.materials.color)
    got = c0 - res["colors1"].numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1e-3 * np.abs(want).max())


def test_four_ranks_lower_the_loss(four_ranks):
    res = four_ranks[0]
    assert float(res["loss2"]) < float(res["loss1"])
