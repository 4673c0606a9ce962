"""The port's differentiable render (ptsharp_tpu_torch/diff.py): autograd
through its integrator against central finite differences on material,
emitter and texel parameters (the checks of tests/test_diff.py and of the
texture test in tests/test_modes_and_passes.py, run on the port at rtol
0.05), the compacted trace's gradient against the plain trace's (within
5% of the max), render_image and material_color_grad against the JAX
package's on the same scene and key, the tape on a textured environment,
and the Renderer staying graph-free.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptsharp_tpu import diff as jdiff
from ptsharp_tpu.camera import Camera as JCamera
from ptsharp_tpu.integrator import IntegratorConfig as JConfig
from ptsharp_tpu.materials import diffuse_material as jdiffuse
from ptsharp_tpu.materials import light_material as jlight
from ptsharp_tpu.scene import SceneBuilder as JBuilder

from ptsharp_tpu_torch import convert, diff, tape
from ptsharp_tpu_torch.camera import Camera
from ptsharp_tpu_torch.core import rng
from ptsharp_tpu_torch.geometry.mesh import cube_mesh
from ptsharp_tpu_torch.integrator import (
    IntegratorConfig, trace, trace_compacted_static,
)
from ptsharp_tpu_torch.materials import (
    Material, diffuse_material, light_material,
)
from ptsharp_tpu_torch.renderer import RenderConfig, Renderer
from ptsharp_tpu_torch.scene import SceneBuilder

CFG = IntegratorConfig(max_bounces=2)
W = H = 8
SPP = 32


def _scene(builder=SceneBuilder, diffuse=diffuse_material,
           light=light_material):
    b = builder()
    b.add_sphere([0, 1, 0], 1.0, diffuse([0.6, 0.3, 0.2]))
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse([0.7, 0.7, 0.7]))
    b.add_sphere([3, 6, -3], 1.5, light([1, 1, 1], 6.0))
    b.set_environment(color=[0.05, 0.05, 0.05])
    return b


SCENE = _scene().build(device="cpu")
CAM = Camera.look_at([0, 2, -6], [0, 1, 0], [0, 1, 0], 40.0, device="cpu")


def _with(scene, **mats):
    return dataclasses.replace(scene,
                               materials=scene.materials._replace(**mats))


def _mean_image(scene, key=11):
    return torch.mean(diff.render_image(scene, CAM, CFG, rng.PRNGKey(key), W,
                                        H, SPP))


def _fd_check(field, row, col, x0, eps, atol):
    """d(mean image)/d(materials.field[row, col]): autograd against a
    central difference; the same key on both sides (common random
    numbers), so the difference is exact up to float32 noise."""
    base = getattr(SCENE.materials, field)

    def loss(x):
        idx = (row, col) if col is not None else (row,)
        table = base.clone()
        table[idx] = x
        return _mean_image(_with(SCENE, **{field: table}))

    x = torch.tensor(x0, requires_grad=True)
    (g_ad,) = torch.autograd.grad(loss(x), x)
    with torch.no_grad():
        g_fd = (loss(torch.tensor(x0 + eps))
                - loss(torch.tensor(x0 - eps))) / (2 * eps)
    np.testing.assert_allclose(float(g_ad), float(g_fd), rtol=0.05,
                               atol=atol)
    assert float(g_ad) > 0.0
    return float(g_ad)


def test_grad_matches_fd_material_color():
    _fd_check("color", 0, 0, 0.6, 1e-2, 1e-4)


def test_grad_matches_fd_emittance():
    _fd_check("emittance", 2, None, 6.0, 5e-2, 1e-5)


def test_grad_env_color():
    env = SCENE.env_color.clone().requires_grad_()
    img = diff.render_image(dataclasses.replace(SCENE, env_color=env), CAM,
                            CFG, rng.PRNGKey(11), W, H, SPP)
    (g,) = torch.autograd.grad(img.mean(), env)
    assert bool((g >= 0).all()) and float(g.sum()) > 0


def test_texture_parameter_gradient():
    """Radiance differentiates with respect to the atlas's texels
    (bilinear sampling is smooth): autograd against a central difference
    on the texel of largest gradient."""
    b = SceneBuilder()
    tid = b.add_texture(np.full((4, 4, 3), 0.5, np.float32))
    b.add_plane([0, 0, 0], [0, 1, 0], Material(color=(1, 1, 1), texture=tid))
    b.add_sphere([0, 4, 0], 1.0, light_material([1, 1, 1], 8.0))
    b.set_environment(color=[0.1, 0.1, 0.1])
    scene = b.build(device="cpu")
    cam = Camera.look_at([0, 3, -4], [0, 0, 0], [0, 1, 0], 40.0,
                         device="cpu")
    n = 4
    xs = torch.arange(n * n)
    half = torch.full((n * n,), 0.5)
    org, dirn = cam.cast_rays(xs % n, xs // n, n, n, half, half)
    org = org.contiguous()
    icfg = IntegratorConfig(max_bounces=1)

    def loss(tex_data):
        s = dataclasses.replace(
            scene, textures=scene.textures._replace(data=tex_data))
        return torch.mean(trace(s, icfg, org, dirn, rng.PRNGKey(0)).radiance)

    data = scene.textures.data.clone().requires_grad_()
    (g,) = torch.autograd.grad(loss(data), data)
    g = g.numpy()
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    i = int(np.abs(g).reshape(-1).argmax())
    eps = 1e-2
    base = scene.textures.data.reshape(-1)
    with torch.no_grad():
        up, dn = base.clone(), base.clone()
        up[i] += eps
        dn[i] -= eps
        fd = (loss(up.reshape(data.shape))
              - loss(dn.reshape(data.shape))) / (2 * eps)
    np.testing.assert_allclose(g.reshape(-1)[i], float(fd), rtol=0.05,
                               atol=1e-6)


def test_grad_compacted_matches_plain():
    """Autograd through trace_compacted_static against the plain trace:
    the same key chain, so near-identical gradients up to the lanes a
    reservoir compaction reorders."""
    cfg = IntegratorConfig(max_bounces=6, russian_roulette=True,
                           rr_start_depth=2)
    n = 4096
    g = np.random.default_rng(5)
    org = torch.from_numpy((g.uniform(-2, 2, (n, 3)) * [1, 0.2, 1]
                            + [0, 2.0, -5.0]).astype(np.float32))
    d = g.normal(size=(n, 3)).astype(np.float32) + [0, -0.3, 1.0]
    dirn = torch.from_numpy((d / np.linalg.norm(d, axis=-1, keepdims=True))
                            .astype(np.float32))

    def grad(tracer):
        colors = SCENE.materials.color.clone().requires_grad_()
        res = tracer(_with(SCENE, color=colors), cfg, org, dirn,
                     rng.PRNGKey(11))
        return torch.autograd.grad(torch.mean(res.radiance), colors)[0]

    gp = grad(trace).numpy()
    gc = grad(lambda *a: trace_compacted_static(*a, min_cap=256)).numpy()
    assert np.abs(gp - gc).max() / max(np.abs(gp).max(), 1e-8) < 0.05


@pytest.mark.parametrize("intersector", ["wide", "pallas"])
def test_grad_through_mesh_scene_is_finite(intersector):
    """Traversal is detached; gradients with respect to the materials are
    still finite and nonzero in a mesh scene."""
    b = SceneBuilder()
    b.add_mesh(cube_mesh([-1, 0, -1], [1, 2, 1]),
               diffuse_material([0.5, 0.5, 0.5]))
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.7, 0.7, 0.7]))
    b.add_sphere([3, 6, -3], 1.5, light_material([1, 1, 1], 6.0))
    scene = b.build(leaf_size=4, intersector=intersector, device="cpu")
    target = torch.zeros(6, 6, 3)
    for use_tape in (False, True):
        g = diff.material_color_grad(scene, CAM, IntegratorConfig(
            max_bounces=2), rng.PRNGKey(11), 6, 6, 8, target,
            use_tape=use_tape).numpy()
        assert np.isfinite(g).all() and np.abs(g).sum() > 0


@pytest.fixture(scope="module")
def jax_case():
    sj = _scene(JBuilder, jdiffuse, jlight).build()
    cam = JCamera.look_at([0, 2, -6], [0, 1, 0], [0, 1, 0], 40.0)
    key = jax.random.PRNGKey(11)
    jcfg = JConfig(max_bounces=2)
    img = np.asarray(jax.jit(jdiff.render_image, static_argnums=(2, 4, 5, 6))(
        sj, cam, jcfg, key, W, H, SPP))
    target = np.full((H, W, 3), 0.05, np.float32)
    g = np.asarray(jax.jit(jdiff.material_color_grad,
                           static_argnums=(2, 4, 5, 6))(
        sj, cam, jcfg, key, W, H, SPP, jnp.asarray(target)))
    st = convert.scene_from_reference(*convert.reference_arrays(sj),
                                      device="cpu")
    ct = convert.camera_from_reference(cam._asdict(), device="cpu")
    return dict(st=st, cam=ct, img=img, grad=g, target=target)


def test_render_image_matches_jax(jax_case):
    img = diff.render_image(jax_case["st"], jax_case["cam"], CFG,
                            rng.PRNGKey(11), W, H, SPP).detach().numpy()
    np.testing.assert_allclose(img, jax_case["img"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("use_tape", [False, True])
def test_material_color_grad_matches_jax(jax_case, use_tape):
    g = diff.material_color_grad(
        jax_case["st"], jax_case["cam"], CFG, rng.PRNGKey(11), W, H, SPP,
        torch.from_numpy(jax_case["target"]), use_tape=use_tape).numpy()
    gj = jax_case["grad"]
    np.testing.assert_allclose(g, gj, rtol=1e-3, atol=1e-3 * np.abs(gj).max())


def test_diff_params_from_reference(jax_case):
    sj = _scene(JBuilder, jdiffuse, jlight).build()
    fields = dict(color=sj.materials.color, emittance=sj.materials.emittance,
                  tint=sj.materials.tint, env_color=sj.env_color,
                  tex_data=sj.textures.data)
    p = convert.diff_params_from_reference(
        {k: np.asarray(v) for k, v in fields.items()}, device="cpu")
    for got, want in zip(p, tape.DiffParams.of(jax_case["st"])):
        assert torch.equal(got, want)


def test_tape_on_a_textured_environment():
    """The tape rebuilds an environment texture's lookups from the
    recorded env uv: its texel gradients equal autograd's."""
    b = _scene()
    ty, tx = np.meshgrid(np.arange(8), np.arange(16), indexing="ij")
    sky = np.stack([0.2 + 0.1 * np.sin(tx), 0.3 + 0.05 * ty / 8.0,
                    np.full(tx.shape, 0.4)], -1).astype(np.float32)
    b.set_environment(texture_id=b.add_texture(sky), angle=0.3)
    scene = b.build(device="cpu")

    def texel_grad(use_tape):
        data = scene.textures.data.clone().requires_grad_()
        s = dataclasses.replace(scene,
                                textures=scene.textures._replace(data=data))
        img = diff.render_image(s, CAM, CFG, rng.PRNGKey(3), W, H, 4,
                                use_tape=use_tape)
        return torch.autograd.grad(img.sum(), data)[0].numpy()

    ga, gt = texel_grad(False), texel_grad(True)
    assert np.abs(ga).max() > 0
    np.testing.assert_allclose(gt, ga, rtol=1e-3, atol=1e-7)


def test_renderer_stays_graph_free():
    """Renderer renders under no_grad: a film is never part of a graph,
    even from a scene whose parameters require grad."""
    scene = _with(SCENE, color=SCENE.materials.color.clone()
                  .requires_grad_())
    r = Renderer(scene, CAM, RenderConfig(8, 8, spp=1), CFG)
    film = r.render(key=rng.PRNGKey(0))
    assert not any(f.requires_grad for f in film)
    assert torch.is_grad_enabled()
