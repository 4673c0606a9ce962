"""The command end to end at toy size on the CPU (--cpu-toy, a flag the
real runs never pass), a cell's files found by name, and the command's
refusals: no card, a checkout without the program."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _run(args, cwd=ROOT, env=None):
    return subprocess.run([sys.executable, "perfbench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


@pytest.mark.parametrize("workload, trace", [("bunny.progressive", "1"),
                                             ("bunny.train", "0")])
def test_command_at_toy_size(workload, trace):
    p = _run(["--workload", workload, "--seed", str(2**31 + 17),
              "--seconds", "1", "--trace", trace, "--cpu-toy"])
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    for k in ("correct", "attempted", "failed", "metrics", "device"):
        assert k in line
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "cpu"
    assert "not a measurement" in line["device"]["kind"]
    assert p.stderr.strip().splitlines()[-1].startswith("check ")
    if trace == "0":
        assert set(line["metrics"]) == {"train_step_ms", "setup_s"}
    else:
        assert "scene_build_s" in line["metrics"]


def test_without_a_card_it_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = _run(["--workload", "bunny.progressive", "--seed", "1",
              "--seconds", "1", "--trace", "0"], env=env)
    assert p.returncode != 0
    assert not p.stdout.strip()


def test_benchmark_files_alone_do_not_run(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(["--workload", "bunny.progressive", "--seed", "1", "--seconds",
              "1", "--trace", "0", "--cpu-toy"], cwd=tmp_path)
    assert p.returncode != 0
    assert not p.stdout.strip()


def test_a_cell_is_found_by_its_names(tmp_path, monkeypatch):
    """A configuration, a traffic mix and a metric added as files and
    entries, with no edit of the harness."""
    (tmp_path / "perfbench" / "configs").mkdir(parents=True)
    (tmp_path / "perfbench" / "traffic").mkdir()
    (tmp_path / "perfbench" / "metrics").mkdir()
    (tmp_path / "perfbench" / "configs" / "dummy.json").write_text(
        json.dumps({"name": "dummy", "x": 1}))
    (tmp_path / "perfbench" / "traffic" / "mix.json").write_text(
        json.dumps({"loop": "progressive", "spp": 3}))
    (tmp_path / "perfbench" / "metrics" / "dummy_metric.x.py").write_text(
        "def read(rec):\n    return rec.get('dummy')\n")
    bench = {"configs": [{"name": "dummy",
                          "file": "perfbench/configs/dummy.json"}],
             "workloads": [{"name": "d.mix", "config": "dummy",
                            "traffic": "mix", "chips": 1}],
             "end_to_end": [], "per_layer": [
                 {"name": "dummy_metric.x", "unit": "%",
                  "workloads": ["d.mix"]},
                 {"name": "other", "unit": "s", "workloads": ["e.mix"]}]}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(run, "ROOT", str(tmp_path))
    spec = run.cell_spec("d.mix")
    assert spec["config"]["x"] == 1 and spec["traffic"]["spp"] == 3
    got = run.metrics_of(spec, {"dummy": 7.5}, trace=True)
    assert got == {"dummy_metric.x": {"value": 7.5, "unit": "%"}}
    assert run.metrics_of(spec, {}, trace=True) == {}
