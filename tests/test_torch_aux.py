"""The port's auxiliary modules against the JAX package's, from the same
numpy-seeded inputs: color (kelvin bit for bit over runway's temperatures
and a sweep, mix, from_srgb), sampling and vec helpers, the film's AOV
images, the triangle oracle, integrator.trace_compacted (per lane on
8,192 Russian-roulette cornell rays, and its fallbacks), checkpoints in
both directions, iterative_render's resume (bit for bit), the denoiser,
the PNG encoder, the viewer, profiling, the command line and the beads
animation.

Tolerances: bit equality where stated; kelvin bit for bit; the float32
helpers whose JAX versions run XLA's transcendentals (uniform_disc,
uniform_sphere, from_srgb) within 2e-7 absolute; intersect_triangles'
hit t within rtol 1e-5 where both hit (the hit sets equal but for 1e-4
of pairs); trace_compacted under tests/test_torch_integrator.py's rule
(per-lane radiance within rtol 1e-4, atol 1e-4 on >= 99.5% of lanes, the
mean within 1e-3, rays within 0.5%); the denoiser within rtol 1e-5, atol
1e-6 (exp differs by an ulp between the two).
"""

import dataclasses
import os
import socket
import subprocess
import sys
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptsharp_tpu import checkpoint as jckpt
from ptsharp_tpu import examples as jex
from ptsharp_tpu import integrator as jint
from ptsharp_tpu import denoise as jden
from ptsharp_tpu import film as jfilm
from ptsharp_tpu.core import color as jcolor
from ptsharp_tpu.core import sampling as jsamp
from ptsharp_tpu.core import vec as jvec
from ptsharp_tpu.geometry import primitives as jprim

from ptsharp_tpu_torch import checkpoint as tckpt
from ptsharp_tpu_torch import convert
from ptsharp_tpu_torch import denoise as tden
from ptsharp_tpu_torch import examples as tex
from ptsharp_tpu_torch import film as tfilm
from ptsharp_tpu_torch import integrator as tint
from ptsharp_tpu_torch import profiling, version
from ptsharp_tpu_torch.accel import bvh as tbvh
from ptsharp_tpu_torch.accel import native as tnative
from ptsharp_tpu_torch.camera import Camera
from ptsharp_tpu_torch.core import color as tcolor
from ptsharp_tpu_torch.core import rng
from ptsharp_tpu_torch.core import sampling as tsamp
from ptsharp_tpu_torch.core import vec as tvec
from ptsharp_tpu_torch.geometry import primitives as tprim
from ptsharp_tpu_torch.materials import diffuse_material, light_material
from ptsharp_tpu_torch.renderer import RenderConfig, Renderer
from ptsharp_tpu_torch.scene import SceneBuilder
from ptsharp_tpu_torch.textures import TextureAtlas
from ptsharp_tpu_torch.viewer import ViewerServer

from tests.test_torch_integrator import assert_radiance_parity, port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNWAY_K = sorted({2000.0 + (i % 20) * 700.0 for i in range(60)} | {6500.0})


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---- color, sampling, vec -------------------------------------------------


@pytest.mark.parametrize("which", ["runway", "sweep"])
def test_kelvin_bit_equal(which):
    ks = RUNWAY_K if which == "runway" else np.linspace(1000, 40000, 1561)
    for k in ks:
        got = tcolor.kelvin(float(k))
        assert got.dtype == torch.float32 and got.shape == (3,)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jcolor.kelvin(float(k))))


def test_color_helpers_match():
    g = np.random.default_rng(0)
    a = g.uniform(-0.2, 1.3, (64, 3)).astype(np.float32)
    b = g.uniform(0, 1, (64, 3)).astype(np.float32)
    pct = g.uniform(0, 1, 64).astype(np.float32)
    for p in (0.3, pct):
        np.testing.assert_array_equal(
            tcolor.mix(_t(a), _t(b), p if isinstance(p, float) else _t(p))
            .numpy(), np.asarray(jcolor.mix(jnp.asarray(a), jnp.asarray(b),
                                            p)))
    np.testing.assert_allclose(tcolor.from_srgb(_t(a)).numpy(),
                               np.asarray(jcolor.from_srgb(jnp.asarray(a))),
                               rtol=0, atol=2e-7)
    np.testing.assert_array_equal(tcolor.BLACK, jcolor.BLACK)
    np.testing.assert_array_equal(tcolor.WHITE, jcolor.WHITE)


def test_sampling_helpers_match():
    g = np.random.default_rng(1)
    u1, u2 = g.random((2, 4096)).astype(np.float32)
    for name in ("uniform_disc", "uniform_sphere"):
        got = getattr(tsamp, name)(_t(u1), _t(u2))
        want = getattr(jsamp, name)(jnp.asarray(u1), jnp.asarray(u2))
        got = torch.stack(got, -1) if isinstance(got, tuple) else got
        want = np.stack(want, -1) if isinstance(want, tuple) else want
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=2e-7, err_msg=name)
    key = rng.PRNGKey(7)
    jkey = jax.random.PRNGKey(7)
    keys = rng.split(key, 6).reshape(2, 3, 2)
    jkeys = jax.random.split(jkey, 6).reshape(2, 3, 2)
    for got, want in ((tsamp.uniforms(key, 3), jsamp.uniforms(jkey, 3)),
                      (tsamp.uniforms(keys, 4), jsamp.uniforms(jkeys, 4)),
                      ((tsamp.uniforms(key, (5, 2), 3),),
                       (jsamp.uniforms(jkey, (5, 2), 3),))):
        assert len(got) == len(want)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_vec_helpers_match():
    g = np.random.default_rng(2)
    a = g.normal(size=(512, 3)).astype(np.float32)
    b = g.normal(size=(512, 3)).astype(np.float32)
    a[:8] = [[1, 1, 2], [2, 1, 1], [1, 2, 1], [1, 1, 1], [0, 0, 0],
             [-3, 3, 3], [3, -3, 3], [3, 3, -3]]  # ties
    for name in ("min_axis", "min_component", "max_component"):
        np.testing.assert_array_equal(
            getattr(tvec, name)(_t(a)).numpy(),
            np.asarray(getattr(jvec, name)(jnp.asarray(a))), err_msg=name)
    np.testing.assert_allclose(
        tvec.distance(_t(a), _t(b)).numpy(),
        np.asarray(jvec.distance(jnp.asarray(a), jnp.asarray(b))),
        rtol=2e-7)


def test_film_images_match():
    g = np.random.default_rng(3)
    fields = dict(mean=g.random((6, 5, 3)), m2=g.random((6, 5, 3)),
                  n=g.integers(0, 9, (6, 5)).astype(np.float64),
                  albedo=g.random((6, 5, 3)) * 2,
                  normal=g.normal(size=(6, 5, 3)))
    fields = {k: v.astype(np.float32) for k, v in fields.items()}
    ft = tfilm.Film(**{k: _t(v) for k, v in fields.items()})
    fj = jfilm.Film(**{k: jnp.asarray(v) for k, v in fields.items()})
    for name in ("samples_image", "albedo_image", "normal_image"):
        np.testing.assert_array_equal(getattr(ft, name)().numpy(),
                                      np.asarray(getattr(fj, name)()),
                                      err_msg=name)


def test_triangle_oracle_and_small_helpers():
    g = np.random.default_rng(4)
    org = g.uniform(-2, 2, (256, 3)).astype(np.float32)
    dirn = g.normal(size=(256, 3)).astype(np.float32)
    v0, v1, v2 = g.uniform(-1, 1, (3, 64, 3)).astype(np.float32)
    got = tprim.intersect_triangles(*map(_t, (org, dirn, v0, v1, v2)))
    want = jprim.intersect_triangles(*map(jnp.asarray,
                                          (org, dirn, v0, v1, v2)))
    tt, tj = got[0].numpy(), np.asarray(want[0])
    both = (tt < 1e8) & (tj < 1e8)
    assert both.sum() > 100 and ((tt < 1e8) != (tj < 1e8)).mean() < 1e-4
    np.testing.assert_allclose(tt[both], tj[both], rtol=1e-5)
    for x, y in zip(got[1:], want[1:]):
        np.testing.assert_allclose(x.numpy()[both], np.asarray(y)[both],
                                   rtol=1e-4, atol=1e-5)
    atlas = TextureAtlas.empty("cpu")
    assert atlas.data.shape == (1, 1, 1, 3) and not atlas.nontrivial
    assert isinstance(tnative.available(), bool)
    before = dict(tbvh.build_counts)
    lo = g.uniform(-1, 0, (40, 3)).astype(np.float32)
    out = tbvh.build(lo, lo + 0.5, 4)
    assert tbvh.last_builder == out.builder
    assert tbvh.build_counts[out.builder] == before[out.builder] + 1
    from ptsharp_tpu.version import __version__

    assert version.__version__ == __version__


# ---- trace_compacted ------------------------------------------------------


@pytest.fixture(scope="module")
def cornell_rr():
    """8,192 cornell camera rays (64x64 pixels, two passes of jitter) under
    its RR config, carried into the port."""
    sj, cam, _rc, icfg = jex.build("cornell")
    n, w = 8192, 64
    xs = jnp.arange(n, dtype=jnp.int32)
    kj, kt = jax.random.split(jax.random.PRNGKey(0))
    ju, jv = jax.random.uniform(kj, (2, n))
    org, dirn = cam.cast_rays(xs % w, (xs // w) % w, w, w, ju, jv)
    st = convert.scene_from_reference(*convert.reference_arrays(sj),
                                       device="cpu")
    return dict(sj=sj, st=st, icfg=icfg, key=kt, org=org, dirn=dirn,
                o=_t(np.asarray(org)), d=_t(np.asarray(dirn)),
                tkey=torch.from_numpy(np.asarray(kt).astype(np.int64)))


def test_trace_compacted_matches(cornell_rr):
    c = cornell_rr
    assert c["icfg"].russian_roulette
    want = jint.trace_compacted(c["sj"], c["icfg"], c["org"], c["dirn"],
                                c["key"])
    got = tint.trace_compacted(c["st"], port_config(c["icfg"]), c["o"],
                               c["d"], c["tkey"])
    # the compaction engages: fewer than half the lanes survive depth 3
    state = tint._trace_prefix(c["st"], port_config(c["icfg"]), c["o"],
                               c["d"], c["tkey"], None, 1, 3)[0]
    assert 0 < int(state.alive.sum()) <= 4096
    assert_radiance_parity(got.radiance.numpy(), np.asarray(want.radiance),
                           int(got.rays_traced), int(want.rays_traced))
    np.testing.assert_allclose(got.albedo.numpy(), np.asarray(want.albedo),
                               atol=1e-4)


@pytest.mark.parametrize("case", ["no_rr", "split", "nothing_culled"])
def test_trace_compacted_fallbacks(cornell_rr, case):
    """No RR, a split specular mode, or a buffer that would not shrink:
    the port's trace_compacted is its trace bit for bit, and meets the
    rule against the JAX package's trace_compacted."""
    c = cornell_rr
    fields = {"no_rr": dict(russian_roulette=False, max_bounces=3),
              "split": dict(specular_mode="first"),
              "nothing_culled": {}}[case]
    icfg = dataclasses.replace(c["icfg"], **fields)
    kw = {"min_cap": 8192} if case == "nothing_culled" else {}
    n = 2048 if case == "split" else 8192
    o, d = c["o"][:n], c["d"][:n]
    got = tint.trace_compacted(c["st"], port_config(icfg), o, d, c["tkey"],
                               **kw)
    plain = tint.trace(c["st"], port_config(icfg), o, d, c["tkey"])
    assert torch.equal(got.radiance, plain.radiance)
    assert int(got.rays_traced) == int(plain.rays_traced)
    want = jint.trace_compacted(c["sj"], icfg, c["org"][:n], c["dirn"][:n],
                                c["key"], **kw)
    assert_radiance_parity(got.radiance.numpy(), np.asarray(want.radiance),
                           int(got.rays_traced), int(want.rays_traced))


def test_compact_state_matches():
    g = np.random.default_rng(5)
    r, cap = 64, 32
    alive = g.random(r) < 0.3
    fields = dict(org=np.arange(r * 3, dtype=np.float32).reshape(r, 3),
                  dirn=g.normal(size=(r, 3)).astype(np.float32),
                  throughput=g.random((r, 3)).astype(np.float32),
                  radiance=g.random((r, 3)).astype(np.float32),
                  emission_ok=g.random(r) < 0.5, alive=alive)
    st, src = tint._compact_state(
        tint.RayState(**{k: _t(v) for k, v in fields.items()}), cap)
    sj, srcj = jint._compact_state(
        jint.RayState(**{k: jnp.asarray(v) for k, v in fields.items()}), cap)
    np.testing.assert_array_equal(src.numpy(), np.asarray(srcj))
    for name in tint.RayState._fields:
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(sj, name)))
    assert bool(st.alive[:alive.sum()].all())


# ---- checkpoint, resume, denoise ------------------------------------------


def _seeded_film(h=4, w=5, seed=6):
    g = np.random.default_rng(seed)
    return {k: g.random(shape).astype(np.float32) for k, shape in (
        ("mean", (h, w, 3)), ("m2", (h, w, 3)), ("n", (h, w)),
        ("albedo", (h, w, 3)), ("normal", (h, w, 3)))}


def test_checkpoints_cross_between_packages(tmp_path):
    arrays = _seeded_film()
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jckpt.save_checkpoint(jpath, jfilm.Film(**{
        k: jnp.asarray(v) for k, v in arrays.items()}), 7,
        jax.random.PRNGKey(3))
    film, it, key = tckpt.load_checkpoint(jpath, device="cpu")
    assert it == 7 and key.dtype == torch.int64
    assert torch.equal(key, rng.PRNGKey(3))
    for name, a in arrays.items():
        np.testing.assert_array_equal(getattr(film, name).numpy(), a)
    tkey = rng.fold_in(rng.PRNGKey(9), 2)
    tckpt.save_checkpoint(tpath, tfilm.Film(**{
        k: _t(v) for k, v in arrays.items()}), 11, tkey)
    assert not os.path.exists(tpath + ".tmp.npz")
    film_j, it_j, key_j = jckpt.load_checkpoint(tpath)
    assert it_j == 11 and key_j.dtype == jnp.uint32
    np.testing.assert_array_equal(
        np.asarray(key_j),
        np.asarray(jax.random.fold_in(jax.random.PRNGKey(9), 2)))
    for name, a in arrays.items():
        np.testing.assert_array_equal(np.asarray(getattr(film_j, name)), a)
    with np.load(tpath) as zt, np.load(jpath) as zj:
        assert sorted(zt.files) == sorted(zj.files)
        assert int(zt["version"]) == jckpt.FORMAT_VERSION


def _small_scene():
    b = SceneBuilder()
    b.add_sphere([0, 1, 0], 1.0, diffuse_material([0.6, 0.3, 0.2]))
    b.add_sphere([2, 4, -2], 1.0, light_material([1, 1, 1], 8.0))
    scene = b.build(device="cpu")
    cam = Camera.look_at([0, 1, -4], [0, 1, 0], [0, 1, 0], 40.0,
                         device="cpu")
    return scene, cam


def test_iterative_render_resume_bit_equal(tmp_path):
    scene, cam = _small_scene()

    def mk():
        return Renderer(scene, cam, RenderConfig(8, 8, spp=2),
                        tint.IntegratorConfig(max_bounces=2))

    key = rng.PRNGKey(5)
    full = mk().iterative_render(4, key=key)
    p = str(tmp_path / "state.npz")
    mk().iterative_render(2, key=key, checkpoint_path=p, checkpoint_every=1)
    with np.load(p) as z:
        assert int(z["iteration"]) == 2
    resumed = mk().iterative_render(4, key=key, checkpoint_path=p,
                                    checkpoint_every=1)
    for a, b in zip(full, resumed):
        assert torch.equal(a, b)
    with np.load(p) as z:
        assert int(z["iteration"]) == 4


def test_atrous_denoise_matches():
    g = np.random.default_rng(8)
    h, w = 24, 32
    color = g.uniform(0, 1.5, (h, w, 3)).astype(np.float32)
    albedo = g.uniform(0, 1, (h, w, 3)).astype(np.float32)
    normal = g.normal(size=(h, w, 3)).astype(np.float32)
    for guides in ((albedo, normal), (None, None)):
        got = tden.atrous_denoise(_t(color), *[None if x is None else _t(x)
                                               for x in guides])
        want = jden.atrous_denoise(jnp.asarray(color), *[
            None if x is None else jnp.asarray(x) for x in guides])
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    for dy, dx in ((2, -3), (-4, 1), (0, 8)):
        np.testing.assert_array_equal(
            tden._shift2d(_t(color), dy, dx).numpy(),
            np.asarray(jden._shift2d(jnp.asarray(color), dy, dx)))
    arrays = _seeded_film(h, w)
    got = tden.denoise_film(tfilm.Film(**{k: _t(v)
                                         for k, v in arrays.items()}))
    want = jden.denoise_film(jfilm.Film(**{k: jnp.asarray(v)
                                           for k, v in arrays.items()}))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# ---- PNG, viewer, profiling, command line ---------------------------------


def test_save_png_matches_the_jax_writer(tmp_path):
    from PIL import Image

    g = np.random.default_rng(9)
    img = g.uniform(-0.1, 1.1, (13, 17, 3)).astype(np.float32)
    tfilm.save_png(_t(img), str(tmp_path / "t.png"))
    jfilm.save_png(jnp.asarray(img), str(tmp_path / "j.png"))
    got = np.asarray(Image.open(tmp_path / "t.png"))
    want = np.asarray(Image.open(tmp_path / "j.png"))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (13, 17, 3) and got.dtype == np.uint8
    np.testing.assert_allclose(tfilm.load_png(str(tmp_path / "t.png")),
                               jfilm.load_png(str(tmp_path / "j.png")))
    # no PIL behind the writer, the film module or the viewer
    code = ("import sys, numpy as np\n"
            "from ptsharp_tpu_torch import film, viewer\n"
            f"film.save_png(np.zeros((2, 3, 3), np.float32), "
            f"{str(tmp_path / 'z.png')!r})\n"
            "viewer.ViewerServer(port=0).update(np.ones((2, 2, 3)))\n"
            "sys.exit(any(m.split('.')[0] == 'PIL' for m in sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_viewer_serves_frames():
    port = _free_port()
    assert port != 18765  # the JAX package's test binds that one
    v = ViewerServer(port=port).start()
    try:
        frame = torch.full((4, 4, 3), 0.5)
        v.update(frame)
        url = f"http://127.0.0.1:{port}"
        page = urllib.request.urlopen(url + "/", timeout=5).read()
        assert b"frame.png" in page
        png = urllib.request.urlopen(url + "/frame.png", timeout=5).read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        assert png == tfilm.encode_png(frame)
    finally:
        v.stop()


def test_profiling(tmp_path, capsys):
    with profiling.trace_to(str(tmp_path)):
        with profiling.span("pt.probe"):
            torch.ones(8).sum()
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(files) == 1
    with open(tmp_path / files[0]) as f:
        assert '"pt.probe"' in f.read()
    profiling.print_device_memory()
    assert capsys.readouterr().out.strip()


def test_main_unknown_scene_returns_1(capsys):
    assert tex.main(["no_such_scene"]) == 1
    out = capsys.readouterr().out
    assert "usage: python -m ptsharp_tpu_torch.examples" in out
    assert "maze" in out and "simple_sphere" in out
    assert tex.main([]) == 1


def test_iterative_render_writes_pngs_denoised_and_viewer(tmp_path):
    scene, cam = _small_scene()
    # the denoiser's widest step (16 pixels) needs 17 rows and columns
    r = Renderer(scene, cam, RenderConfig(20, 18, spp=1),
                 tint.IntegratorConfig(max_bounces=2))
    port = _free_port()
    v = ViewerServer(port=port).start()
    try:
        film = r.iterative_render(2, key=rng.PRNGKey(1),
                                  path_template=str(tmp_path / "f_%d.png"),
                                  denoise=True, viewer=v)
        served = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/frame.png", timeout=5).read()
    finally:
        v.stop()
    from PIL import Image

    assert served == tfilm.encode_png(film.color_srgb())
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "f_2.png")),
        tfilm.quantize(film.color_srgb()))
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "f_2_denoised.png")),
        tfilm.quantize(tcolor.to_srgb(tden.denoise_film(film))))
    assert (tmp_path / "f_1.png").exists()


def test_render_animation(tmp_path):
    tex.render_animation(2, str(tmp_path / "b_%03d.png"), width=12,
                         height=8, device="cpu")
    from PIL import Image

    frames = [np.asarray(Image.open(tmp_path / f"b_{f:03d}.png"))
              for f in range(2)]
    assert all(f.shape == (8, 12, 3) for f in frames)
    s0 = tex.beads_frame(0, 2, 12, 8, device="cpu")[0]
    s1 = tex.beads_frame(1, 2, 12, 8, device="cpu")[0]
    assert s0.sphere_center.shape[0] == 41
    assert not torch.equal(s0.sphere_center, s1.sphere_center)
    sj = jex.beads_frame(1, 2, 12, 8)[0]
    np.testing.assert_array_equal(s1.sphere_center.numpy(),
                                  np.asarray(sj.sphere_center))
