"""The port's tracer (``utils/metrics.py``): spans and counters, off by
default, in ``Retinanet.predict``, a training step and the profiler hook's
Chrome trace. CPU only, at toy size."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from pytorch_retinanet_tpu_torch import ConfigDict, Retinanet, RetinaNetModel, Trainer
from pytorch_retinanet_tpu_torch.utils import (
    MetricLogger,
    ProfilerHook,
    count,
    count_syncs,
    drain,
    metrics,
    set_tracing,
    span,
    tracing,
)

MODEL = dict(num_classes=4, backbone_kind="resnet18", pretrained=False, min_size=64, max_size=96,
             compute_dtype="float32", prior=0.1)
OPTIMIZER = {"class_name": "torch.optim.SGD", "params": {"lr": 0.01, "momentum": 0.9}}
TRAIN_SPANS = ["train.fetch", "train.upload", "train.forward", "train.loss", "train.backward",
               "train.optimizer"]


@pytest.fixture(autouse=True)
def _off_and_empty():
    """Each test starts and ends with tracing off and nothing recorded."""
    set_tracing(False)
    drain()
    yield
    set_tracing(False)
    drain()


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


def test_off_records_nothing_and_span_is_the_shared_no_op():
    assert span("a") is span("b", torch.device("cpu"))
    with span("a"):
        count("c")
        count_syncs(torch.device("cuda"))
    assert drain() == {"spans": [], "counters": {}, "dropped": 0}


def test_spans_nest_with_parents_and_one_call_id_per_root():
    with tracing():
        with span("root"):
            with span("child"):
                with span("grandchild"):
                    pass
            with span("child"):
                pass
        with span("root"):
            count("n")
            count("n", 2)
    out = drain()
    by = _by_name(out["spans"])
    roots, children = by["root"], by["child"]
    assert len(roots) == 2 and len(children) == 2
    assert [r["parent"] for r in roots] == [None, None]
    assert roots[0]["call"] != roots[1]["call"]
    assert all(c["parent"] == roots[0]["id"] and c["call"] == roots[0]["call"] for c in children)
    assert by["grandchild"][0]["parent"] == children[0]["id"]
    assert all(s["device_ms"] is None and s["end_ns"] >= s["start_ns"] for s in out["spans"])
    assert roots[0]["start_ns"] <= children[0]["start_ns"] <= children[1]["end_ns"] <= roots[0]["end_ns"]
    assert out["counters"] == {"n": 3}


def test_tracing_restores_the_state_it_found():
    assert set_tracing(True) is False
    with tracing():
        pass
    assert set_tracing(False) is True
    with tracing():
        assert metrics._on
    assert not metrics._on


def test_syncs_are_counted_only_where_the_host_waits(monkeypatch):
    with tracing():
        count_syncs(torch.device("cpu"), 3)
        count_syncs("cuda:0", 2)
        count_syncs(torch.device("cuda", 1))
    assert drain()["counters"] == {"host_syncs": 3}
    monkeypatch.setattr(metrics, "SYNC_DEVICES", ("cuda", "cpu"))
    with tracing():
        count_syncs(torch.device("cpu"), 3)
    assert drain()["counters"] == {"host_syncs": 3}


def test_drain_clears_and_the_cap_drops_and_counts(monkeypatch):
    monkeypatch.setattr(metrics, "TRACE_CAP", 3)
    with tracing():
        for _ in range(5):
            with span("s"):
                pass
        count("k")
    out = drain()
    assert len(out["spans"]) == 3 and out["dropped"] == 2 and out["counters"] == {"k": 1}
    assert drain() == {"spans": [], "counters": {}, "dropped": 0}


def test_a_span_open_when_tracing_stops_is_not_kept():
    set_tracing(True)
    with span("outlived"):
        set_tracing(False)
    with tracing():
        with span("kept"):
            pass
    assert [s["name"] for s in drain()["spans"]] == ["kept"]


def test_device_spans_fall_back_to_the_host_clock_on_the_cpu():
    with tracing():
        with span("on_cpu", torch.device("cpu")):
            torch.ones(64, 64) @ torch.ones(64, 64)
        with span("host"):
            pass
    dev, host = drain()["spans"]
    assert dev["device_ms"] == dev["host_ms"] > 0
    assert host["device_ms"] is None


def test_log_every_times_the_wait_once_for_its_meter_and_its_span():
    def slow():
        for i in range(3):
            yield i

    got = []
    with tracing():
        for obj in MetricLogger(print_freq=100).log_every(slow(), fetch_span="x.fetch"):
            got.append(obj)
    spans = drain()["spans"]
    assert got == [0, 1, 2]
    # The fetch that found the iterable done is a wait too.
    assert [s["name"] for s in spans] == ["x.fetch"] * 4
    assert list(MetricLogger().log_every([5, 6])) == [5, 6]
    assert drain()["spans"] == []


def _net():
    return Retinanet(device="cpu", seed=0, **MODEL)


@pytest.mark.parametrize("size,syncs_per_image", [((64, 96), 1), ((48, 72), 9)])
def test_predict_emits_its_spans_and_counts_its_syncs(size, syncs_per_image, monkeypatch):
    """One bucket: an upload per image, and for an image that is resized,
    the eight uploads of its resize taps; then the sizes' upload, the
    regression weights' upload in each of the five levels' decode, and the
    four readbacks. The CPU waits for none of them; counted as a card's,
    they are the points that wait."""
    net = _net()
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (*size, 3), dtype=np.uint8) for _ in range(3)]
    want = net.predict(images)  # the anchors' uploads happen once, here
    with tracing():
        net.predict(images)
    assert drain()["counters"] == {}
    monkeypatch.setattr(metrics, "SYNC_DEVICES", ("cuda", "cpu"))
    with tracing():
        got = net.predict(images)
    out = drain()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["boxes"], w["boxes"])
    by = _by_name(out["spans"])
    (root,) = by["predict"]
    assert root["parent"] is None
    assert {s["call"] for s in out["spans"]} == {root["call"]}
    for name in ("predict.forward", "predict.postprocess", "predict.readback"):
        (s,) = by[name]
        assert s["parent"] == root["id"], name
    # The grouping's front, then the one bucket's.
    assert [s["parent"] for s in by["predict.front"]] == [root["id"]] * 2
    front = by["predict.front"][1]
    for name in ("predict.upload", "predict.resize"):
        assert len(by[name]) == len(images)
        assert all(s["parent"] == front["id"] for s in by[name])
    for name in ("predict.forward", "predict.postprocess"):
        assert by[name][0]["device_ms"] == by[name][0]["host_ms"]
    assert out["counters"] == {"host_syncs": syncs_per_image * len(images) + 1 + 5 + 4}


class _Served(RetinaNetModel):
    def __init__(self, batches):
        super().__init__(ConfigDict({"model": MODEL, "optimizer": OPTIMIZER}), device="cpu")
        self.batches = batches

    def prepare_data(self):
        pass

    def train_dataloader(self, shard=0, num_shards=1):
        return list(self.batches)

    def val_dataloader(self, shard=0, num_shards=1):
        return None


def _batches(n, b=2):
    rng = np.random.default_rng(1)
    out = []
    for _ in range(n):
        boxes = np.zeros((b, 100, 4), np.float32)
        boxes[:, 0] = [10, 10, 50, 40]
        valid = np.zeros((b, 100), bool)
        valid[:, 0] = True
        out.append({"images": torch.from_numpy(rng.random((b, 64, 96, 3), dtype=np.float32)),
                    "boxes": torch.from_numpy(boxes), "labels": torch.from_numpy(valid.astype(np.int32)),
                    "valid": torch.from_numpy(valid)})
    return out


def test_a_fit_emits_each_layer_once_a_step(monkeypatch):
    monkeypatch.setattr(metrics, "SYNC_DEVICES", ("cuda", "cpu"))  # count as a card's
    trainer = Trainer(max_steps=3, warmup_steps=0, num_sanity_val_steps=0, logger=False,
                      log_every_n_steps=100)
    with tracing():
        trainer.fit(_Served(_batches(5)))
    out = drain()
    by = _by_name(out["spans"])
    steps = by["train.step"]
    assert len(steps) == 3 and len({s["call"] for s in steps}) == 3
    for name in TRAIN_SPANS:
        assert len(by[name]) == 3, name
    for name in TRAIN_SPANS[1:]:
        assert [s["call"] for s in by[name]] == [s["call"] for s in steps], name
        assert [s["parent"] for s in by[name]] == [s["id"] for s in steps], name
    assert all(s["parent"] is None for s in by["train.fetch"])
    assert all(s["device_ms"] == s["host_ms"] for s in by["train.forward"] + by["train.optimizer"])
    # Unpinned host batches: each of the four tensors a step waits for its
    # upload; the first step uploads the five levels' anchors; on the CPU
    # the match's plain version uploads its regression weights in each
    # level; the last step reads its three losses to the host.
    assert out["counters"]["host_syncs"] == 3 * 4 + 5 + 3 * 5 + 3


def test_the_profiler_hook_puts_the_spans_in_its_chrome_trace(tmp_path):
    trainer = Trainer(max_steps=3, warmup_steps=0, num_sanity_val_steps=0, logger=False,
                      profile_dir=str(tmp_path))
    trainer.profiler = ProfilerHook(str(tmp_path), start_step=1, num_steps=1)
    trainer.fit(_Served(_batches(4)))
    assert not metrics._on  # off again after the window
    assert os.path.getsize(trainer.profiler.trace_path) > 0
    with open(trainer.profiler.trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events if e.get("cat") == "user_annotation"}
    assert {"train.step", *TRAIN_SPANS} <= names
    # The window's records stay for drain: the second step's spans, and the
    # fetch of the third batch.
    by = _by_name(drain()["spans"])
    assert len(by["train.step"]) == 1 and len(by["train.fetch"]) == 1
