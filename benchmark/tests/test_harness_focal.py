"""The focal-loss backward counter's reader (``metrics/focal_backward.train.py``)
on a toy training cell, on the CPU: the program's ``focal.backward`` counter
counts one backward a pyramid level, five a step; a program without the
counter reads None.

    python -m pytest benchmark/tests/test_harness_focal.py -q
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[1]
for p in (str(HERE), str(REPO / "benchmark"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

import toy  # noqa: E402
from rnbench import spans  # noqa: E402
from rnbench.spec import Spec  # noqa: E402

METRIC = "focal_backward.train"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return toy.write_root(tmp_path_factory.mktemp("bench"))


def _run(root: Path, cell: str):
    """An untraced run of `cell`, as ``run.py`` hands it to the readers."""
    import run as bench_run
    from rnbench import train

    spec = Spec(root)
    c = spec.cell(cell)
    cfg, traffic = spec.config(c), spec.traffic(c)
    ctx = bench_run.Context(cfg, traffic, argparse.Namespace(seed=3, seconds=0.5, trace=0),
                            torch.device("cpu"), time.time(), spec)
    ctx.rank_hook = None
    out = train.run(ctx)
    run = {"e2e": out["e2e"], "trace": {}, "spans": out.get("spans") or {},
           "counters": out.get("counters") or {}, "cfg": cfg, "traffic": traffic, "batch": out["batch"],
           "bucket": out["bucket"], "world": int(c["chips"]), "device_name": "cpu", "root": str(root),
           "family": ctx.family}
    return spec, c, run


@pytest.fixture(scope="module")
def toy_train(root):
    return _run(root, "toy_train_cell")


def _read(spec, cell, run):
    return {m["name"]: spec.reader(m).read(run) for m in spec.per_layer(cell) if m["name"] == METRIC}


def test_the_reader_reads_five_backwards_a_step_on_a_toy_training_cell(toy_train):
    spec, c, run = toy_train
    result = spans.program_pass(run)
    assert result["records"]["counters"]["focal.backward"] == 5 * result["steps"]
    assert _read(spec, c, run) == {METRIC: 5.0}


def test_without_the_counter_the_reader_gives_nothing(toy_train, monkeypatch):
    spec, c, run = toy_train
    result = spans.program_pass(run)
    counters = {k: v for k, v in result["records"]["counters"].items() if k != "focal.backward"}
    monkeypatch.setattr(spans, "program_pass",
                        lambda r: {**result, "records": {**result["records"], "counters": counters}})
    assert _read(spec, c, run) == {METRIC: None}
    monkeypatch.setattr(spans, "program_pass", lambda r: None)  # no tracer
    assert _read(spec, c, run) == {METRIC: None}
