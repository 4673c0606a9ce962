"""The plain reference imports nothing of the program, and agrees with
the program lane by lane at toy size on the CPU (the program is imported
here only to be compared with)."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench import checks
from perfbench.reference import rng as rrng
from perfbench.reference import scene as rscene
from perfbench.reference import tracer

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REF = os.path.join(ROOT, "perfbench", "reference")


def _conf(name):
    with open(os.path.join(ROOT, "perfbench", "configs", name + ".json")) as f:
        return json.load(f)


def test_reference_sources_import_nothing_of_the_program():
    for dirpath, _d, files in os.walk(REF):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                for n in names:
                    top = n.split(".")[0]
                    assert top not in ("ptsharp_tpu_torch", "ptsharp_tpu",
                                       "jax", "jaxlib", "flax"), (f, n)


def test_reference_loads_no_program_module():
    code = ("import sys; sys.path.insert(0, %r); "
            "import perfbench.checks, perfbench.reference.tracer; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('ptsharp_tpu_torch', 'ptsharp_tpu', 'jax')]; "
            "print(bad); sys.exit(1 if bad else 0)" % ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr


def test_threefry_matches_the_program():
    from ptsharp_tpu_torch.core import rng

    k, rk = rng.PRNGKey(12345), rrng.key(12345)
    assert [tuple(x.tolist()) for x in rng.split(k, 3)] == rrng.split(rk, 3)
    assert tuple(rng.fold_in(k, 77).tolist()) == rrng.fold_in(rk, 77)
    u = rng.uniform(k, (2, 333)).reshape(-1)
    assert torch.equal(u, rrng.uniform_at(rk, torch.arange(666)))


@pytest.mark.parametrize("config, example", [("bunny_pallas8", "bunny"),
                                             ("dragon_hd_pallas8",
                                              "dragon_hd")])
def test_scene_matches_the_program(config, example):
    from ptsharp_tpu_torch import examples

    conf = _conf(config)
    scene, *_ = examples.build(example, width=32, height=24, subdivisions=2,
                               intersector="pallas", wide_k=8, device="cpu")
    rs = rscene.build(conf["scene"], "cpu", subdivisions=2)
    t = rs.v0.shape[0]
    assert t == 20 * 4**2

    def rows(*cols):  # the triangles as a sorted set of rows
        a = torch.cat(cols, dim=1).numpy()
        return a[np.lexsort(a.T[::-1])]

    slots = scene.p_slot_tri[scene.p_slot_tri >= 0].long()
    assert slots.shape[0] == t
    assert np.array_equal(rows(rs.n[:, 0], rs.e1, rs.e2),
                          rows(scene.tri_n0[slots], scene.tri_e1[slots],
                               scene.tri_e2[slots]))
    assert torch.equal(rs.materials["color"], scene.materials.color)
    assert torch.equal(rs.env, scene.env_color)


def test_paths_match_the_program_lane_by_lane():
    """render_shard's lanes, traced by the program and the reference from
    the same key, at 48x32 on the bunny."""
    from ptsharp_tpu_torch import examples
    from ptsharp_tpu_torch.parallel import shard

    w, h = 48, 32
    scene, cam, _rc, icfg = examples.bunny(w, h, subdivisions=3,
                                           intersector="pallas", wide_k=8,
                                           device="cpu")
    key = checks.run_key(99)
    img = shard.render_shard(scene, cam, icfg, checks.port_key(key), w, h,
                             1, 1, 1, 0, 0)
    walker = tracer.Walker(rscene.build(_conf("bunny_pallas8")["scene"],
                                        "cpu", subdivisions=3))
    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    ref = checks.sharded_pixels(walker, key, yy.reshape(-1), xx.reshape(-1),
                                w, h, 1, 1, 1).reshape(h, w, 3)
    off = (torch.abs(ref - img) > 1e-4 + 1e-3 * torch.abs(img)).any(dim=-1)
    assert float(off.float().mean()) < 0.01
    assert float(img.mean()) == pytest.approx(float(ref.mean()), rel=1e-3)


def test_block_pixels_are_distinct_tiles():
    ys, xs, nb = checks.block_pixels(5, 64, 48, 8, 10, "cpu")
    assert nb == 10 and ys.shape[0] == 640
    tiles = {(int(y) // 8, int(x) // 8) for y, x in zip(ys, xs)}
    assert len(tiles) == 10
    assert len({(int(y), int(x)) for y, x in zip(ys, xs)}) == 640


def test_render_numbers_see_a_bias():
    g = torch.Generator().manual_seed(0)
    ref = torch.rand((64, 160, 3), generator=g)
    fair = torch.rand((200, 160, 3), generator=g).mean(dim=0)
    var = torch.full_like(fair, 1 / 12)
    ok = checks.render_numbers(fair, var, 200, ref, 10)
    bad = checks.render_numbers(fair * 1.3, var, 200, ref, 10)
    assert ok["z_max"] < 5 and ok["z_mean"] < 4
    assert bad["z_max"] > 10 and bad["z_mean"] > 10
