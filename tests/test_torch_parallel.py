"""The port's sharding (ptsharp_tpu_torch/parallel/) in one process against
the JAX package's shard_map on the 8 virtual CPU devices of conftest.py.

A dp x sp mesh is rebuilt in one process from its dp * sp render_shard
calls (`emulate`): each row block is the sum of its sp shares over sp, the
arithmetic of render_image_sharded's all_reduce. Held against the JAX
package's render_image_sharded (rtol 1e-4, atol 1e-5, test_torch_diff's
render tolerance) on test_parallel's spheres and plane at dp=4, sp=2 and
on test_distributed's cube at dp=2, sp=2; the gradient of the whole
image's loss against jax.grad through the JAX shard_map, by the tape and
by autograd (rtol 1e-3, atol 1e-3 max|g|, test_torch_diff's gradient
tolerance); one make_train_step step on a 1 x 1 mesh against the JAX
package's; the mesh, its asserts, initialize and the entry points
(entry, dryrun_multichip on two gloo processes). The port's scenes are
built by its own SceneBuilder and also carried across from the JAX
build with convert.scene_from_reference: both give the same bits.
"""

import dataclasses
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from ptsharp_tpu.camera import Camera as JCamera
from ptsharp_tpu.geometry.mesh import cube_mesh as jcube_mesh
from ptsharp_tpu.integrator import IntegratorConfig as JConfig
from ptsharp_tpu.materials import diffuse_material as jdiffuse
from ptsharp_tpu.materials import light_material as jlight
from ptsharp_tpu.parallel import mesh as jmesh
from ptsharp_tpu.parallel import shard as jshard
from ptsharp_tpu.scene import SceneBuilder as JBuilder

from ptsharp_tpu_torch import convert
from ptsharp_tpu_torch.core import rng, vec
from ptsharp_tpu_torch.parallel import distributed, entry, shard
from ptsharp_tpu_torch.parallel.mesh import Mesh, make_mesh, single_device_mesh

from tests.torch_parallel_cases import SCENES, port_case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RENDER_TOL = dict(rtol=1e-4, atol=1e-5)
W = H = 8
LR = 0.5
# (scene, dp, sp, spp) of the sharded renders held against the JAX package
RENDER_CASES = [("spheres", 4, 2, 8), ("cube", 2, 2, 4)]


def jax_case(name):
    make, eye, center, bounces = SCENES[name]
    scene = make(JBuilder, jdiffuse, jlight, jcube_mesh)
    cam = JCamera.look_at(eye, center, [0, 1, 0], 40.0)
    return scene, cam, JConfig(max_bounces=bounces)


def with_colors(scene, colors):
    return dataclasses.replace(
        scene, materials=scene.materials._replace(color=colors))


def emulate(scene, cam, cfg, key, width, height, spp, dp, sp,
            use_tape=False):
    """A dp x sp render_image_sharded in one process: its dp * sp shares,
    each row block's sp shares summed, then divided by sp."""
    blocks = []
    for i in range(dp):
        acc = None
        for j in range(sp):
            part = shard.render_shard(scene, cam, cfg, key, width, height,
                                      spp, dp, sp, i, j, use_tape=use_tape)
            acc = part if acc is None else acc + part
        blocks.append(vec.div(acc, sp))
    return torch.cat(blocks)


def emulated_loss_grad(scene, cam, cfg, key, target, width, height, spp,
                       dp, sp, use_tape):
    """The whole image's loss, as make_train_step writes it, and its
    gradient with respect to the material colors, by autograd over the
    emulated mesh's one graph."""
    colors = scene.materials.color.detach().clone().requires_grad_()
    img = emulate(with_colors(scene, colors), cam, cfg, key, width, height,
                  spp, dp, sp, use_tape=use_tape)
    loss = vec.div(torch.sum((img - target) ** 2), img.numel())
    (g,) = torch.autograd.grad(loss, colors)
    return loss.detach(), g


def jax_mesh(dp, sp):
    return jmesh.make_mesh(dp=dp, sp=sp, devices=jax.devices()[:dp * sp])


def jax_loss_grad(sj, cam, cfg, key, target, width, height, spp, dp, sp,
                  use_tape):
    mesh = jax_mesh(dp, sp)

    def loss(colors):
        img = jshard.render_image_sharded(
            with_colors(sj, colors), cam, cfg, key, width, height, spp, mesh,
            use_tape=use_tape)
        return jnp.mean((img - target) ** 2)

    value, g = jax.jit(jax.value_and_grad(loss))(sj.materials.color)
    return float(value), np.asarray(g)


def target_image(seed=3):
    return (np.random.default_rng(seed).random((H, W, 3)) * 0.1).astype(
        np.float32)


_JAX_RENDERS = """
import sys
import numpy as np
import tests.conftest  # the CPU platform, 8 devices, partitionable threefry
import jax
from ptsharp_tpu.parallel import shard as jshard
from tests.test_torch_parallel import RENDER_CASES, H, W, jax_case, jax_mesh

render = jax.jit(jshard.render_image_sharded, static_argnums=(2, 4, 5, 6, 7))
for name, dp, sp, spp in RENDER_CASES:
    sj, cam, cfg = jax_case(name)
    img = render(sj, cam, cfg, jax.random.PRNGKey(0), W, H, spp,
                 jax_mesh(dp, sp))
    np.save(f"{sys.argv[1]}/{name}.npy", np.asarray(img))
"""


@pytest.fixture(scope="module")
def jax_renders():
    """JAX render_image_sharded of each RENDER_CASES case, from a process
    whose XLA CPU code stops at AVX, below FMA: XLA's CPU backend
    otherwise contracts multiply-adds into fused multiply-adds, which the
    port and JAX's eager arithmetic round twice (under jit it moves a
    sample of one spheres pixel by 5e-4; eager shard_map gives the same
    numbers as this process, in ~100 s a case)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        "--xla_force_host_platform_device_count=8 --xla_cpu_max_isa=AVX"))
    with tempfile.TemporaryDirectory() as out:
        subprocess.run([sys.executable, "-c", _JAX_RENDERS, out], cwd=REPO,
                       env=env, check=True, timeout=600)
        return {name: np.load(os.path.join(out, f"{name}.npy"))
                for name, *_ in RENDER_CASES}


@pytest.mark.parametrize("name,dp,sp,spp", RENDER_CASES)
def test_sharded_render_matches_jax(jax_renders, name, dp, sp, spp):
    """The emulated mesh equals the JAX shard_map render; the scene carried
    across from the JAX build gives the same bits as the port's build."""
    want = jax_renders[name]
    sj, _jcam, _jcfg = jax_case(name)
    scene, cam, cfg = port_case(name)
    got = emulate(scene, cam, cfg, rng.PRNGKey(0), W, H, spp, dp, sp)
    np.testing.assert_allclose(got.numpy(), want, **RENDER_TOL)
    carried = convert.scene_from_reference(*convert.reference_arrays(sj),
                                           device="cpu")
    assert torch.equal(emulate(carried, cam, cfg, rng.PRNGKey(0), W, H, spp,
                               dp, sp), got)


@pytest.mark.parametrize("use_tape", [False, True])
def test_sharded_gradient_matches_jax(use_tape):
    """The gradient of mean((img - target)**2) over the whole dp=4, sp=2
    image equals jax.grad through the JAX shard_map: the true gradient,
    with no factor of sp or of the device count."""
    sj, jcam, jcfg = jax_case("spheres")
    target = target_image()
    jloss, gj = jax_loss_grad(sj, jcam, jcfg, jax.random.PRNGKey(11),
                              jnp.asarray(target), W, H, 8, 4, 2, use_tape)
    scene, cam, cfg = port_case("spheres")
    loss, g = emulated_loss_grad(scene, cam, cfg, rng.PRNGKey(11),
                                 torch.from_numpy(target), W, H, 8, 4, 2,
                                 use_tape)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-4)
    assert np.abs(gj).max() > 0
    np.testing.assert_allclose(g.numpy(), gj, rtol=1e-3,
                               atol=1e-3 * np.abs(gj).max())


def test_train_step_matches_jax():
    """One make_train_step step on a 1 x 1 mesh: the loss and the new
    colors of the JAX package's step on its single-device mesh; its
    gradient is loss_and_grad's."""
    sj, jcam, jcfg = jax_case("spheres")
    target = target_image(5)
    jstep = jshard.make_train_step(jcam, jcfg, W, H, 8,
                                   jmesh.single_device_mesh(), lr=LR)
    jscene, jloss = jstep(sj, jax.random.PRNGKey(2), jnp.asarray(target))
    scene, cam, cfg = port_case("spheres")
    mesh = single_device_mesh("cpu")
    tgt = torch.from_numpy(target)
    step = shard.make_train_step(cam, cfg, W, H, 8, mesh, lr=LR)
    new_scene, loss = step(scene, rng.PRNGKey(2), tgt)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(new_scene.materials.color.numpy(),
                               np.asarray(jscene.materials.color),
                               **RENDER_TOL)
    loss2, g = shard.loss_and_grad(scene, cam, cfg, rng.PRNGKey(2), tgt, W,
                                   H, 8, mesh)
    assert torch.equal(loss2, loss)
    assert torch.equal(torch.clamp(scene.materials.color - LR * g, 0.0, 1.0),
                       new_scene.materials.color)


def test_train_step_lowers_the_loss():
    """Two steps toward black lower the loss (test_sharded_train_step on
    the port's one-rank mesh)."""
    scene, cam, cfg = port_case("spheres")
    step = shard.make_train_step(cam, cfg, W, H, 2, make_mesh(device="cpu"),
                                 lr=LR)
    target = torch.zeros(H, W, 3)
    losses = []
    for i in range(2):
        scene, loss = step(scene, rng.PRNGKey(i), target)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_single_device_mesh_is_render_shard():
    """A 1 x 1 mesh needs no process group and returns render_shard(0, 0)
    bit for bit, by the tape too."""
    assert not dist.is_initialized()
    scene, cam, cfg = port_case("cube")
    mesh = single_device_mesh("cpu")
    assert (mesh.shape, mesh.dp_index, mesh.sp_index) == (
        {"dp": 1, "sp": 1}, 0, 0)
    for use_tape in (False, True):
        img = shard.render_image_sharded(scene, cam, cfg, rng.PRNGKey(4), W,
                                         H, 2, mesh, use_tape=use_tape)
        assert torch.equal(img, shard.render_shard(
            scene, cam, cfg, rng.PRNGKey(4), W, H, 2, 1, 1, 0, 0,
            use_tape=use_tape))


@pytest.mark.parametrize("dp,sp,height,spp", [(3, 1, 8, 2), (1, 3, 8, 2)])
def test_shard_asserts(dp, sp, height, spp):
    scene, cam, cfg = port_case("spheres")
    with pytest.raises(AssertionError, match="%"):
        shard.render_shard(scene, cam, cfg, rng.PRNGKey(0), W, height, spp,
                           dp, sp, 0, 0)


def test_mesh_layout():
    """Ranks are laid out row-major, as the JAX mesh lays out devices;
    without a process group the mesh is one rank."""
    grid = np.arange(8).reshape(4, 2)
    for rank in range(8):
        m = Mesh(4, 2, rank, torch.device("cpu"))
        assert grid[m.dp_index, m.sp_index] == rank
    assert make_mesh(device="cpu").shape == {"dp": 1, "sp": 1}
    with pytest.raises(AssertionError, match="2x1 != 1 ranks"):
        make_mesh(dp=2, device="cpu")


def test_initialize_returns_without_a_group(monkeypatch):
    """No arguments and no torchrun environment: the single-process case;
    a group that exists is kept."""
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    distributed.initialize()
    assert not dist.is_initialized()
    distributed.initialize(device="cpu")
    assert distributed.process_summary(device="cpu") == {
        "process_index": 0, "process_count": 1, "local_devices": 1,
        "global_devices": 1, "platform": "cpu"}
    port = distributed.free_port()
    distributed.initialize(f"localhost:{port}", 1, 0, device="cpu")
    try:
        assert dist.get_backend() == "gloo"
        distributed.initialize(f"localhost:{port + 1}", 2, 1, device="cpu")
        assert dist.get_world_size() == 1
        assert distributed.global_mesh().device == torch.device("cpu")
    finally:
        distributed.shutdown()
    assert not dist.is_initialized()


def test_initialize_never_falls_back():
    """NCCL, or a card, asked for where there is none raises before any
    rendezvous; nothing drops to gloo or to the CPU."""
    port = distributed.free_port()
    with pytest.raises(ValueError, match="NCCL"):
        distributed.initialize(f"localhost:{port}", 1, 0, device="cpu",
                               backend="nccl")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            distributed.initialize(f"localhost:{port}", 1, 0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry.dryrun_multichip(1)
    assert not dist.is_initialized()


def test_entry_renders_cornell():
    fn, args = entry.entry(device="cpu")
    out = fn(*args)
    assert out.shape == (64, 64, 3)
    assert bool(torch.isfinite(out).all())


def test_dryrun_multichip_on_two_gloo_processes(capsys):
    entry.dryrun_multichip(2, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip(2): mesh dp=1 sp=2 loss=")
    assert line.endswith(" OK")
