"""On the card: a short run of each one-card cell reads correct, and the
control (fp8 in the program's place) fails the cell's limits at the cell's
own size.

    python3 -m pytest --noconftest -p no:cacheprovider benchmark/tests/test_harness_card.py -q
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
ONE_CARD = [c["name"] for c in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]
            if c["chips"] == 1]


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the port's kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ONE_CARD)
def test_a_short_run_reads_correct(cell):
    _card()
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed", "5",
                           "--seconds", "2"], cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"] is True, proc.stderr[-4000:]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ONE_CARD)
def test_the_control_fails_at_the_cells_size(cell):
    _card()
    proc = subprocess.run([sys.executable, "benchmark/control.py", "--workload", cell, "--seeds",
                           "6"], cwd=REPO, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    limits = json.loads((REPO / "benchmark/limits" / f"{cell}.json").read_text())
    arms = json.loads(proc.stdout.strip().splitlines()[-1])["arms"]
    for arm, read in arms.items():
        assert any(v > limits[k] for k, v in read.items()), (arm, read, limits)
