"""The harness end to end on the CPU, at toy size, from files written into a
temporary root: the result line, the reference against the port, the
control and the planted faults, the checks on what a run may load.

    python -m pytest benchmark/tests -q       # ~1 min on 8 cores
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[1]
for p in (str(HERE), str(REPO / "benchmark"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

import toy  # noqa: E402
from rnbench import reference as R  # noqa: E402
from rnbench import weights  # noqa: E402
from rnbench.spec import Spec  # noqa: E402

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return toy.write_root(tmp_path_factory.mktemp("bench"))


PREDICT = {"predict_img_s", "predict_p95_ms", "setup_s"}


@pytest.mark.parametrize("cell,metrics", [("toy_predict_cell", PREDICT), ("toy_serve_cell", PREDICT),
                                          ("toy_train_cell", {"train_img_s", "setup_s"})])
def test_toy_cell_prints_the_result_line(root, cell, metrics):
    rc, res, err = toy.run_cell(root, cell)
    assert rc == 0, err
    assert list(res) == KEYS  # the checks come last
    assert res["correct"] is True, err
    assert set(res["metrics"]) == metrics
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())
    assert err.strip().splitlines()[-len(res["checks"]):] == [
        f"check {k} {c['value']!r} limit {c['limit']!r}" for k, c in res["checks"].items()]
    from run import loaded_forbidden

    assert loaded_forbidden(sys.modules) == [], "a run may not load JAX or the JAX package"


def test_forbidden_names_compare_whole_top_level_names():
    from run import loaded_forbidden

    assert loaded_forbidden(["pytorch_retinanet_tpu_torch.models", "jaxtyping", "numpy"]) == []
    assert loaded_forbidden(["jax.numpy", "pytorch_retinanet_tpu.ops", "flax"]) == [
        "flax", "jax", "pytorch_retinanet_tpu"]


def test_a_new_metric_is_a_file_of_its_own(root):
    from rnbench.spec import Spec

    spec = Spec(root)
    entry = next(m for m in spec.data["per_layer"] if m["name"] == "toy_batch")
    assert spec.reader(entry).read({"batch": 2}) == 2


def test_reference_equals_the_port_at_toy_size():
    """f32 on both sides: the detector's outputs and the training loss."""
    from pytorch_retinanet_tpu_torch import Retinanet
    from pytorch_retinanet_tpu_torch.ops import generate_anchors_per_level, retinanet_loss_levels

    m = toy.MODEL
    fam = Spec(REPO).family(toy.CONFIG)
    sd = weights.make_state_dict(fam, m, 0.3, 5, "cpu")
    net = Retinanet(backbone_kind=m["backbone_kind"], num_classes=m["num_classes"], prior=0.3,
                    pretrained=False, min_size=128, max_size=192, compute_dtype="float32",
                    device="cpu")
    net.load_torch_state_dict(sd)
    gen = torch.Generator().manual_seed(0)
    images = torch.randint(0, 256, (2, 128, 192, 3), generator=gen, dtype=torch.uint8)
    with torch.no_grad():
        got_cls, got_box = net.module(images, return_levels=True)
        want_cls, want_box = R.detector(sd, images, fam, m)
    for g, w in zip(got_cls + got_box, want_cls + want_box):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
    boxes = torch.tensor([[[10.0, 20.0, 90.0, 100.0], [0, 0, 0, 0]],
                          [[50.0, 10.0, 150.0, 70.0], [5.0, 5.0, 40.0, 60.0]]])
    labels = torch.tensor([[1, 0], [2, 4]], dtype=torch.int32)
    valid = torch.tensor([[True, False], [True, True]])
    anchors_l = [torch.from_numpy(a) for a in generate_anchors_per_level((128, 192))]
    got = retinanet_loss_levels(got_cls, got_box, anchors_l, boxes, labels, valid,
                                num_classes=m["num_classes"])
    anchors = torch.from_numpy(np.concatenate(R.anchors_per_level((128, 192))))
    cls, box = torch.cat(want_cls, 1), torch.cat(want_box, 1)
    want = sum(R.image_loss(cls[i], box[i], anchors, boxes[i][valid[i]], labels[i][valid[i]],
                            m["num_classes"]) for i in range(2)) / 2
    torch.testing.assert_close(got["classification_loss"] + got["regression_loss"], want,
                               rtol=1e-5, atol=1e-6)


def _alter_first_detection(monkeypatch, what):
    from pytorch_retinanet_tpu_torch.models import retinanet

    real = retinanet.process_detections_multilevel_batch

    def altered(*args, **kwargs):
        det = real(*args, **kwargs)
        if what == "box":
            det.boxes[0, 0] += 8.0
        elif what == "label":
            det.labels[0, 0] = det.labels[0, 0] % args[0][0].shape[-1] + 1
        else:  # no detections at all
            det.valid.zero_()
        return det

    monkeypatch.setattr(retinanet, "process_detections_multilevel_batch", altered)


def _keep_all(monkeypatch):
    """An NMS that suppresses nothing."""
    from pytorch_retinanet_tpu_torch.kernels import nms

    for name in ("nms_keep_mask", "nms_keep_mask_plain"):
        monkeypatch.setattr(nms, name, lambda boxes, valid, thr: valid.clone())


def _half_batch(monkeypatch):
    from pytorch_retinanet_tpu_torch.engine import trainer

    real = trainer.retinanet_loss_levels

    def half(cls, box, anchors, boxes, labels, valid, **kw):
        b = boxes.shape[0] // 2
        return real([c[:b] for c in cls], [x[:b] for x in box], anchors, boxes[:b], labels[:b],
                    valid[:b], **kw)

    monkeypatch.setattr(trainer, "retinanet_loss_levels", half)


@pytest.mark.parametrize("fault", ["answer_box_altered", "answer_label_altered", "answer_empty_altered",
                                   "nms_keeps_all", "state_unchanged", "half_batch", "half_batch_adamw"])
def test_a_broken_timed_path_reads_incorrect(root, monkeypatch, fault):
    if fault.startswith("answer"):
        _alter_first_detection(monkeypatch, fault.split("_")[1])
        cell = "toy_predict_cell"
    elif fault == "nms_keeps_all":
        _keep_all(monkeypatch)
        cell = "toy_predict_cell"
    elif fault == "state_unchanged":
        monkeypatch.setattr(torch.optim.SGD, "step", lambda self, closure=None: None)
        cell = "toy_train_cell"
    else:
        _half_batch(monkeypatch)
        cell = "toy_adamw_train_cell" if fault.endswith("adamw") else "toy_train_cell"
    rc, res, err = toy.run_cell(root, cell)
    assert rc == 0, err
    assert res["correct"] is False, err


@pytest.mark.parametrize("hook,correct", [(None, True), ("toy:break_exchange", False)])
def test_data_parallel_toy_on_two_gloo_ranks(root, hook, correct):
    """The spawned ranks' path (DDP over gloo on the CPU); with the
    all-reduce of the gradients left out, correct reads false."""
    rc, res, err = toy.run_cell(root, "toy_ddp2_cell", rank_hook=hook)
    assert rc == 0, err
    assert res["correct"] is correct, err
    assert res["device"]["count"] == 2


@pytest.mark.parametrize("cell,arms", [("toy_predict_cell", ["fp8", "keep_all", "one_per_class", "empty",
                                                             "lowest_k"]),
                                       ("toy_train_cell", ["fp8", "half", "unchanged"]),
                                       ("toy_adamw_train_cell", ["fp8", "half", "unchanged"])])
def test_the_control_and_faults_fail_the_limits(root, cell, arms, capsys):
    """The control (fp8 in the program's place) and each planted fault fail
    at least one of the cell's numbers under the real cells' limits."""
    import control

    control.main(["--workload", cell, "--seeds", "1", "2", "3", "--device", "cpu",
                  "--root", str(root)])
    limits = toy.LIMITS[cell]
    for line in capsys.readouterr().out.strip().splitlines():
        read = json.loads(line)["arms"]
        for arm in arms:
            assert any(v > limits[k] for k, v in read[arm].items()), (arm, read[arm], limits)


def test_without_a_card_the_run_exits_2(root):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    import run

    assert run.main(["--workload", "toy_predict_cell", "--seed", "1", "--seconds", "1"],
                    root=root) == 2


def test_alone_in_a_directory_the_run_fails(tmp_path):
    """Only BENCHMARK.json and the benchmark's files: no program to run."""
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "r50_predict_b32",
                           "--seed", "1", "--seconds", "1"], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300, env={**os.environ, "PYTHONPATH": ""})
    assert proc.returncode != 0
    assert not proc.stdout.strip()
