"""The port's tape backward (ptsharp_tpu_torch/tape.py) and its autograd
path through the integrator, against each other and against the JAX
package's tape, on examples.cornell (2,048 rays) and on
examples.bunny(32, 24, subdivisions=3, intersector="pallas", wide_k=8)
(768 rays). The JAX scene is carried over with
convert.scene_from_reference; the JAX side runs its tape jitted, its mesh
queries through its plain reference walk (intersector "wide" over the
same scene's XLA tables), as tests/test_torch_integrator.py does.

Tolerances: the tape's radiance bit-equal to trace()'s; tape against
autograd per DiffParams leaf at rtol 1e-3 (tests/test_tape.py); the port
against the JAX package per leaf at rtol 1e-3, atol 1e-3 * max |g_jax|;
the remat modes against each other at rtol 1e-6.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptsharp_tpu import examples as jex
from ptsharp_tpu import integrator as jint
from ptsharp_tpu import tape as jtape

from ptsharp_tpu_torch import convert
from ptsharp_tpu_torch import integrator as tint
from ptsharp_tpu_torch import tape as ttape
from ptsharp_tpu_torch.core import rng
from ptsharp_tpu_torch.kernels import traverse

KEY = 5
LEAVES = ttape.DiffParams._fields
SHAPES = {"cornell": (64, 32), "bunny": (32, 24)}


def port_config(icfg, **kw) -> tint.IntegratorConfig:
    names = [f.name for f in dataclasses.fields(tint.IntegratorConfig)]
    return tint.IntegratorConfig(**{**{n: getattr(icfg, n) for n in names},
                                    **kw})


def camera_rays(cam, w, h, seed=0):
    """One jittered primary ray a pixel, jitter from numpy."""
    g = np.random.default_rng(seed)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ju, jv = g.random((2, w * h)).astype(np.float32)
    o, d = cam.cast_rays(jnp.asarray(xs.reshape(-1)),
                         jnp.asarray(ys.reshape(-1)), w, h,
                         jnp.asarray(ju), jnp.asarray(jv))
    return np.asarray(o), np.asarray(d)


def jax_params(sj):
    return jtape.DiffParams(
        color=sj.materials.color, emittance=sj.materials.emittance,
        tint=sj.materials.tint, env_color=jnp.asarray(sj.env_color),
        tex_data=sj.textures.data)


def jax_grads(sj, icfg, o, d, wts, tape=True):
    """The JAX package's gradients of sum(radiance * wts) per DiffParams
    leaf, by its tape or by AD through its trace."""

    def loss(p, scene):
        s = jtape._plug(scene, p)
        if tape:
            res = jtape.trace_tape_radiance(s, icfg, o, d,
                                            jax.random.PRNGKey(KEY))
        else:
            res = jint.trace(s, icfg, o, d, jax.random.PRNGKey(KEY))
        return jnp.sum(res.radiance * wts)

    g = jax.jit(jax.grad(loss))(jax_params(sj), sj)
    return {n: np.asarray(getattr(g, n)) for n in LEAVES}


def port_grads(case, tracer, cfg=None):
    """The port's radiance result and gradients of sum(radiance * wts)
    per DiffParams leaf."""
    scene = case["st"]
    leaves = [x.detach().clone().requires_grad_()
              for x in ttape.DiffParams.of(scene)]
    s = ttape.plug(scene, ttape.DiffParams(*leaves))
    res = tracer(s, cfg or case["icfg"], case["org"], case["dirn"],
                 rng.PRNGKey(KEY))
    gs = torch.autograd.grad((res.radiance * case["wts"]).sum(), leaves,
                             allow_unused=True)
    return res, {n: (np.zeros(x.shape, np.float32) if gr is None
                     else gr.numpy())
                 for n, gr, x in zip(LEAVES, gs, leaves)}


@pytest.fixture(scope="module", params=["cornell", "bunny"])
def case(request):
    name = request.param
    w, h = SHAPES[name]
    if name == "bunny":
        sj, cam, _rc, icfg = jex.bunny(w, h, subdivisions=3,
                                       intersector="pallas", wide_k=8)
    else:
        sj, cam, _rc, icfg = jex.cornell(w, h)
    st = convert.scene_from_reference(*convert.reference_arrays(sj),
                                      device="cpu")
    o, d = camera_rays(cam, w, h)
    wts = np.random.default_rng(1).random((w * h, 3)).astype(np.float32)
    walk = (dataclasses.replace(sj, intersector="wide")
            if sj.inst_inv.shape[0] else sj)
    out = dict(name=name, sj=sj, walk=walk, jicfg=icfg, st=st,
               icfg=port_config(icfg), o=o, d=d,
               org=torch.from_numpy(o.copy()),
               dirn=torch.from_numpy(d.copy()),
               wts=torch.from_numpy(wts), jwts=jnp.asarray(wts))
    out["jax_tape"] = jax_grads(walk, icfg, jnp.asarray(o), jnp.asarray(d),
                                out["jwts"])
    out["tape"] = port_grads(out, ttape.trace_tape_radiance)
    out["ad"] = port_grads(out, tint.trace)
    return out


def test_tape_primal_bit_parity(case):
    with torch.no_grad():
        plain = tint.trace(case["st"], case["icfg"], case["org"],
                           case["dirn"], rng.PRNGKey(KEY))
    res, _g = case["tape"]
    assert torch.equal(res.radiance, plain.radiance)
    assert int(res.rays_traced) == int(plain.rays_traced)
    assert torch.equal(res.albedo, plain.albedo)
    # autograd through trace computes the same forward
    assert torch.equal(case["ad"][0].radiance, plain.radiance)


@pytest.mark.parametrize("leaf", LEAVES)
def test_tape_grads_match_ad(case, leaf):
    gt = case["tape"][1][leaf]
    ga = case["ad"][1][leaf]
    np.testing.assert_allclose(gt, ga, rtol=1e-3, atol=1e-7)
    assert np.isfinite(gt).all()


@pytest.mark.parametrize("leaf", LEAVES)
def test_grads_match_jax_tape(case, leaf):
    gj = case["jax_tape"][leaf]
    gt = case["tape"][1][leaf]
    np.testing.assert_allclose(gt, gj, rtol=1e-3,
                               atol=1e-3 * max(np.abs(gj).max(), 1e-30))


def test_textured_materials_take_the_texel_gradient(case):
    """A textured material (the bunny's) takes its color from the atlas:
    its color row gets no gradient, the texels do; cornell has no texture,
    so no texel gets any."""
    tex_mat = case["st"].materials.texture.numpy()
    assert (tex_mat >= 0).any() == (case["name"] == "bunny")
    for grads in (case["tape"][1], case["ad"][1]):
        assert (np.abs(grads["tex_data"]).max() > 0) == (tex_mat >= 0).any()
        assert np.all(grads["color"][tex_mat >= 0] == 0)
        assert np.abs(grads["color"][tex_mat < 0]).max() > 0


def test_rr_probability_is_detached():
    """Cornell runs Russian roulette from depth 2: the port's autograd
    gradient through trace() equals the JAX package's, whose survival
    probability is stop_gradient'ed; a probability that carried gradient
    would move the color and tint gradients."""
    w, h = 32, 32
    sj, cam, _rc, icfg = jex.cornell(w, h)
    assert icfg.russian_roulette and icfg.max_bounces > icfg.rr_start_depth
    o, d = camera_rays(cam, w, h, seed=3)
    wts = np.random.default_rng(4).random((w * h, 3)).astype(np.float32)
    gj = jax_grads(sj, icfg, jnp.asarray(o), jnp.asarray(d),
                   jnp.asarray(wts), tape=False)
    case = dict(st=convert.scene_from_reference(*convert.reference_arrays(sj),
                                                device="cpu"),
                icfg=port_config(icfg), org=torch.from_numpy(o.copy()),
                dirn=torch.from_numpy(d.copy()), wts=torch.from_numpy(wts))
    _res, gt = port_grads(case, tint.trace)
    for leaf in ("color", "emittance", "tint"):
        np.testing.assert_allclose(gt[leaf], gj[leaf], rtol=1e-3,
                                   atol=1e-3 * np.abs(gj[leaf]).max())


def test_remat_modes_agree(case):
    """remat "full", "hits" and off give the same gradients."""
    ref = case["ad"][1]
    for kw in ({"remat_policy": "hits"}, {"remat": False}):
        _res, g = port_grads(case, tint.trace, port_config(case["icfg"],
                                                           **kw))
        for leaf in LEAVES:
            np.testing.assert_allclose(g[leaf], ref[leaf], rtol=1e-6,
                                       atol=1e-30)


def test_remat_checkpoints_re_run_the_depths(monkeypatch):
    """Under remat "full" the backward re-runs each scanned depth's
    closest-hit and shadow query; under "hits" the shadow query only; off,
    and under the tape, nothing. Counted by wrapping the port's queries
    (the kernel wrappers count only card launches)."""
    from ptsharp_tpu_torch import examples

    scene, cam, _rc, icfg = examples.bunny(8, 6, subdivisions=2,
                                           intersector="pallas", wide_k=8,
                                           device="cpu")
    w, h = 8, 6
    xs = torch.arange(w * h)
    org, dirn = cam.cast_rays(xs % w, xs // w, w, h,
                              torch.full((w * h,), 0.5),
                              torch.full((w * h,), 0.5))
    calls = {"closest": 0, "any": 0}

    def counting(kind, fn):
        def wrapped(*a, **kw):
            calls[kind] += 1
            return fn(*a, **kw)
        return wrapped

    def backward_calls(tracer, cfg):
        color = scene.materials.color.clone().requires_grad_()
        s = dataclasses.replace(
            scene, materials=scene.materials._replace(color=color))
        loss = tracer(s, cfg, org.contiguous(), dirn, rng.PRNGKey(1)) \
            .radiance.sum()
        calls.update(closest=0, any=0)
        loss.backward()
        return dict(calls)

    monkeypatch.setattr(traverse, "closest_hit",
                        counting("closest", traverse.closest_hit))
    monkeypatch.setattr(traverse, "any_hit",
                        counting("any", traverse.any_hit))
    depths = icfg.max_bounces
    assert backward_calls(tint.trace, icfg) == {"closest": depths,
                                                 "any": depths}
    assert backward_calls(tint.trace, port_config(
        icfg, remat_policy="hits")) == {"closest": 0, "any": depths}
    assert backward_calls(tint.trace, port_config(icfg, remat=False)) \
        == {"closest": 0, "any": 0}
    assert backward_calls(ttape.trace_tape_radiance, icfg) == {
        "closest": 0, "any": 0}


def test_tape_supported_follows_the_modes():
    scene = types.SimpleNamespace()
    assert ttape.tape_supported(scene, tint.IntegratorConfig())
    assert ttape.tape_supported(scene, tint.IntegratorConfig(
        light_mode="power"))
    for mode in ({"specular_mode": "first"}, {"specular_mode": "all"},
                 {"light_mode": "all"}):
        fields = {"specular_mode": "naive", "light_mode": "random", **mode}
        assert not ttape.tape_supported(scene,
                                        types.SimpleNamespace(**fields))


@pytest.mark.parametrize("arg", ["org", "dirn", "t", "fat"])
def test_launchers_raise_on_inputs_that_require_grad(arg):
    """A wrapper reads raw pointers on the card, so it refuses a tensor
    that requires grad on every device rather than cut the graph."""
    from ptsharp_tpu_torch import examples

    scene = examples.bunny(8, 6, subdivisions=1, intersector="pallas",
                           wide_k=8, device="cpu")[0]
    g = np.random.default_rng(0)
    d = g.normal(size=(16, 3)).astype(np.float32)
    args = dict(fat=scene.p_fat.clone(),
                org=torch.zeros(16, 3) + torch.tensor([0.0, 1.0, -3.0]),
                dirn=torch.from_numpy(d / np.linalg.norm(d, axis=1)[:, None]),
                t=torch.full((16,), 1e9))
    args[arg].requires_grad_()
    for wrapper in (traverse.closest_hit, traverse.any_hit,
                    traverse.closest_hit_preorder, traverse.any_hit_preorder):
        with pytest.raises(ValueError, match="require grad"):
            wrapper(args["fat"], args["org"], args["dirn"], args["t"],
                    scene.p_inst_base[0], scene.p_inst_end[0],
                    scene.max_leaf, scene.wide_k)
