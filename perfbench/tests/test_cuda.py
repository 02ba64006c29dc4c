"""On the card: one short run of a cell through ``perfbench/run.py``, and
the exit without a card.  The card tests skip without one (decided in a
fixture)."""
import json
import subprocess
import sys

import pytest

from perfbench.harness import bench


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _run(workload, seconds, trace=0):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 3), "--seconds", str(seconds), "--trace",
         str(trace)], capture_output=True, text=True, timeout=900,
        cwd=str(bench.ROOT))


@pytest.mark.cuda
def test_sweep_cell_runs_correct(card):
    p = _run("sweep.table4", 3)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert line["metrics"]["sweep_accesses_per_s"]["value"] > 0


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _run("sweep.table4", 1)
    assert p.returncode != 0 and p.stdout.strip() == ""
