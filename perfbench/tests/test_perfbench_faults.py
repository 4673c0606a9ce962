"""`correct` comes out false when the timed path is broken underneath
(the run's look for a card skipped: --cpu-toy drives the rest of a run),
once for each fault a cell can have, and for the precision control: the
reference in bfloat16 put in the program's place."""

import dataclasses
import sys
import io
import json
from contextlib import redirect_stdout

import pytest
import torch

from perfbench import checks, run


def _line(workload, hooks, seed=11, seconds="1"):
    buf = io.StringIO()
    with redirect_stdout(buf):
        code = run.main(["--workload", workload, "--seed", str(seed),
                         "--seconds", seconds, "--trace", "0", "--cpu-toy"],
                        hooks=hooks)
    assert code == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


class _Renderer:
    """The program's renderer with one fault planted in `render`."""

    def __init__(self, inner, fault):
        self.inner, self.fault = inner, fault

    def render(self, film, key):
        r = self.inner
        if self.fault == "unchanged":
            return film
        if self.fault == "half":
            # half of each pass's samples left out, the mean over the rest
            cfg = r.config
            r.config = dataclasses.replace(cfg, spp=max(1, cfg.spp // 2))
            try:
                return r.render(film, key)
            finally:
                r.config = cfg
        if self.fault == "altered":
            # the radiance of the upper half of each chunk's rows altered
            # where the chunk is made
            make = r._render_chunk

            def chunk(*a, **k):
                c, rays = make(*a, **k)
                c.mean[: c.mean.shape[0] // 2] *= 1.3
                return c, rays

            r._render_chunk = chunk
            try:
                return r.render(film, key)
            finally:
                del r._render_chunk
        return r.render(film, key)


def test_sound_render_is_correct():
    assert _line("bunny.progressive", {})["correct"] is True


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_render_faults_are_caught(fault):
    hooks = {"renderer": lambda r: _Renderer(r, fault)}
    line = _line("bunny.progressive", hooks)
    assert line["correct"] is False, line["checks"]


def _step_fault(fault):
    def wrap(step):
        def broken(scene, key, target):
            if fault == "unchanged":
                _new, loss = step(scene, key, target)
                return scene, loss
            if fault == "half":
                # half of the image's rows left out, the loss the mean
                # over the rest
                h = target.shape[0] // 2
                sub = target.clone()
                sub[h:] = 0.0
                new, loss = step(scene, key, sub)
                return new, loss * 2.0
            new, loss = step(scene, key, target)
            if fault == "altered":
                c = new.materials.color.clone()
                c[1, 0] = c[1, 0] + 0.01
                new = dataclasses.replace(
                    new, materials=new.materials._replace(color=c))
            return new, loss
        return broken
    return wrap


def test_sound_train_is_correct():
    assert _line("bunny.train", {})["correct"] is True


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_train_faults_are_caught(fault):
    line = _line("bunny.train", {"step": _step_fault(fault)})
    assert line["correct"] is False, line["checks"]


def test_render_control_fails():
    """The reference in bfloat16 in the program's place, at toy size."""
    spec = run.cell_spec("bunny.progressive")
    check = dict(spec["traffic"]["check"], **spec["traffic"]["toy_check"])
    got = checks.render_control(spec["config"], check, 5, 32, 32, 24, "cpu",
                                subdivisions=2)
    limits = check["limits"]
    assert any(got[k] > limits[k] for k in limits), got


def test_train_control_fails():
    """The reference in bfloat16 in the program's place: its losses and
    colours against the float32 reference's, at toy size."""
    spec = run.cell_spec("bunny.train")
    conf, traffic = spec["config"], spec["traffic"]
    c0 = torch.tensor([[0.5, 0.5, 0.4], [0.6, 0.5, 0.5], [0.7, 0.8, 0.9]])
    got = checks.train_control(conf, traffic, 5, c0, 32, 24, "cpu",
                               subdivisions=2)
    limits = traffic["check"]["limits"]
    assert any(got[k] > limits[k] for k in limits), got


CELL_4CARD = {"name": "bunny.train_4card", "config": "bunny_pallas8",
              "traffic": "train_4card", "chips": 4, "why": "four ranks"}


@pytest.mark.parametrize("sound", [True, False])
def test_train_4card_exchange_left_out_is_caught(tmp_path, sound):
    """Four gloo ranks of the four-rank train mix at toy size (a checkout
    whose BENCHMARK.json names the cell), with and without the gradient's
    all_reduce: rank 0's result reads correct only with it."""
    import os

    from ptsharp_tpu_torch.parallel import distributed

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append(CELL_4CARD)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    # the program (its native BVH builder's source and build too) and the
    # benchmark
    for d in ("perfbench", "ptsharp_tpu_torch", "native", "build"):
        if os.path.exists(os.path.join(root, d)):
            os.symlink(os.path.join(root, d), tmp_path / d)
    port = distributed.free_port()
    cmds = [[sys.executable, "-c",
             "import sys; sys.path.insert(0, %r); from perfbench.tests "
             "import rank_fault; rank_fault.main(%d, %d, %r)"
             % (str(tmp_path), r, port, sound)] for r in range(4)]
    outs = distributed.run_ranks(cmds, timeout=280, cwd=str(tmp_path))
    lines = [ln for ln in outs[0].splitlines() if ln.startswith("{")]
    assert json.loads(lines[-1])["correct"] is sound
