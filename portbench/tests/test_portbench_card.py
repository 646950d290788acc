"""One short run of a cell on the card (skips without one): the command
the driver runs, ending in a correct result line."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.card
def test_cell_runs_correct_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "disc.paper-regimes-100k", "--seed", "2147483999", "--seconds",
         "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
