"""The command on the card (marked `cuda`; skips without a card): a short
window of each one-card cell, correct, with the card's name."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["bunny.progressive", "bunny.train",
                                      "dragon_hd.final"])
def test_cell_on_the_card(card, workload):
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        workload, "--seed", "12345", "--seconds", "3",
                        "--trace", "1"], cwd=ROOT, capture_output=True,
                       text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0
