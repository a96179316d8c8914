"""The program's spans in a traced run (``rnbench/spans.py``): the pass
that the new readers share, on the CPU at toy size, and the reduction of a
profiler window's events, on made-up events (the CPU has no device
timeline).

    python -m pytest benchmark/tests/test_harness_spans.py -q
"""

from __future__ import annotations

import argparse
import json
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

PROGRAM_SPAN = {"predict": ["front_span_ms.predict", "upload_ms.predict", "host_syncs.predict",
                            "dispatch_ms.predict", "forward_span_ms.predict", "postprocess_span_ms.predict"],
                "train": ["loader_wait_ms.train", "forward_span_ms.train", "loss_span_ms.train",
                          "backward_span_ms.train", "optimizer_ms.train"]}
DEVICE_TRACE = ["front_idle_share.predict", "launches.predict"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return toy.write_root(tmp_path_factory.mktemp("bench"))


def _run(root: Path, cell: str):
    """An untraced run of `cell`, as ``run.py`` hands it to the readers."""
    import run as bench_run
    from rnbench import predict, train

    spec = Spec(root)
    c = spec.cell(cell)
    cfg, traffic = spec.config(c), spec.traffic(c)
    ctx = bench_run.Context(cfg, traffic, argparse.Namespace(seed=3, seconds=0.5, trace=0),
                            torch.device("cpu"), time.time(), spec)
    ctx.rank_hook = None
    out = {"predict": predict, "train": train}[traffic["driver"]].run(ctx)
    run = {"e2e": out["e2e"], "trace": out.get("trace") or {}, "spans": out.get("spans") or {},
           "counters": out.get("counters") or {}, "cfg": cfg, "traffic": traffic, "batch": out["batch"],
           "bucket": out["bucket"], "world": int(c["chips"]), "device_name": "cpu", "root": str(root),
           "family": ctx.family}
    return spec, c, run


def _read(spec, cell, run, names=None):
    return {m["name"]: spec.reader(m).read(run) for m in spec.per_layer(cell)
            if names is None or m["name"] in names}


@pytest.mark.parametrize("cell,kind", [("toy_predict_cell", "predict"), ("toy_train_cell", "train"),
                                         ("toy_ddp2_cell", "train")])
def test_the_new_readers_read_the_pass_and_the_old_ones_do_not_move(root, cell, kind):
    spec, c, run = _run(root, cell)
    new = set(PROGRAM_SPAN[kind] + (DEVICE_TRACE if kind == "predict" else []))
    old = [m["name"] for m in spec.per_layer(c) if m["name"] not in new]
    before = json.dumps(_read(spec, c, run, old))
    got = _read(spec, c, run, PROGRAM_SPAN[kind])
    assert all(isinstance(v, float) and v >= 0 for v in got.values()), got
    assert json.dumps(_read(spec, c, run, old)) == before
    result = spans.program_pass(run)
    by = {}
    for s in result["records"]["spans"]:
        by.setdefault(s["name"], []).append(s)
    if kind == "predict":
        assert len(by["predict"]) == spans.PASS_CALLS
        assert got["host_syncs.predict"] == 0.0  # the CPU waits for no device
        # No device timeline on the CPU: the trace's metrics are left out.
        assert _read(spec, c, run, DEVICE_TRACE) == {k: None for k in DEVICE_TRACE}
    else:
        assert len(by["train.step"]) == spans.PASS_STEPS
        # The first traced step's fetch began before the tracer was on.
        assert len(by["train.fetch"]) == spans.PASS_STEPS - 1
    assert spans.program_pass(run) is result  # once a run


def test_without_the_tracer_the_new_readers_give_nothing(root, monkeypatch):
    spec, c, run = _run(root, "toy_predict_cell")
    monkeypatch.setattr(spans, "_tracer", lambda: None)
    monkeypatch.setattr(spans, "_last", (None, None))
    assert set(_read(spec, c, run, PROGRAM_SPAN["predict"] + DEVICE_TRACE).values()) == {None}


def test_idle_and_runtime_calls_are_put_down_to_the_spans_open_on_the_host():
    events = [("predict", "annotation", 0.0, 10.0), ("predict.front", "annotation", 0.0, 4.0),
              ("predict.forward", "annotation", 4.0, 8.0), ("predict.readback", "annotation", 8.0, 10.0),
              ("stem_kernel", "device", 1.0, 2.0), ("conv", "device", 5.0, 7.0),
              ("Memcpy DtoH", "device", 6.5, 9.0), ("early", "device", -3.0, -2.0),
              ("cudaLaunchKernel", "host", 5.0, 5.1), ("cuLaunchKernelEx", "host", 6.0, 6.1),
              ("cudaMemcpyAsync", "host", 8.2, 8.3), ("cudaStreamSynchronize", "host", 8.3, 9.0),
              ("cudaLaunchKernel", "host", 11.0, 11.1)]
    w = spans.attribute(events, "predict")
    assert w["window_s"] == 10.0
    assert w["idle_s"] == pytest.approx(1.0 + 3.0 + 1.0)  # [0, 1], [2, 5], [9, 10]
    assert w["idle_in"] == pytest.approx({"predict": 5.0, "predict.front": 3.0, "predict.forward": 1.0,
                                          "predict.readback": 1.0})
    assert w["launches"] == [2] and w["syncs"] == [1]
    assert w["annotations"] == {"predict": 1, "predict.front": 1, "predict.forward": 1,
                                "predict.readback": 1}
    assert spans.attribute([e for e in events if e[1] != "device"], "predict") == {}
