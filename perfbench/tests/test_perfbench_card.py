"""On the card: each cell runs and comes out correct in a short window."""

import json
import subprocess
import sys

import pytest

from perfbench.harness import spec

pytestmark = pytest.mark.card


CELLS = [w["name"] for w in json.loads((spec.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(card, name):
    command = [sys.executable, "perfbench/run.py", "--workload", name, "--seed", str(2**32 + 17), "--seconds", "5"]
    out = subprocess.run(command, cwd=spec.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
