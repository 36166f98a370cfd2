"""Each cell on the card, short: built, run, compared, traced. Marked
`cuda`; skipped where no card is found (decided in the fixture)."""

import json
import subprocess
import sys

import pytest

from portbench import harness

CELLS = [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(card, workload, trace):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 101), "--seconds", "3", "--trace",
         str(trace)], cwd=harness.ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["metrics"]
