"""The port's parity and measurement tools (``tools/torch_*.py``), at toy size on the CPU.

* ``torch_parity_report.make_val_set`` equals the JAX tool's
  (``tools/parity_report.py``, imported by path) bit for bit: the GT, and
  each image's ``cls`` and ``reg``;
* the parity report reads ΔAP +0.0000 on every row against the torch oracle;
* the port's copy of the loss oracle equals ``tools/loss_parity.py``'s
  ``oracle_loss_one`` exactly (the same torch code on the same input), and
  the port's loss is within JAX's bar of it;
* the A13 tools' ``main`` at resnet18, 64x96, batch 2, one iteration, f32
  (bf16 on this CPU build goes non-finite from a process's second model):
  the fields they write, and the backward stages summing to the hooked
  backward they were read from.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TOOLS = os.path.join(REPO, "tools")
sys.path.insert(0, TOOLS)

import torch_bench_loader  # noqa: E402
import torch_bench_train  # noqa: E402
import torch_loss_parity  # noqa: E402
import torch_parity_report  # noqa: E402
import torch_profile_backward  # noqa: E402


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(TOOLS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_val_set_equals_jax_bit_for_bit():
    jax_tool = _jax_tool("parity_report")
    args = (3, 8, (256, 256))
    j_anchors, j_gt, j_gen = jax_tool.make_val_set(*args)
    p_anchors, p_gt, p_gen = torch_parity_report.make_val_set(*args)
    np.testing.assert_array_equal(np.asarray(j_anchors), p_anchors)
    assert j_gt.dataset == p_gt.dataset
    for img_id in (1, 2, 3):
        (jc, jr), (pc, pr) = j_gen(img_id), p_gen(img_id)
        assert jc.dtype == pc.dtype == np.float32 and jr.dtype == pr.dtype == np.float32
        np.testing.assert_array_equal(jc, pc)
        np.testing.assert_array_equal(jr, pr)
        assert (pc > -3.5).sum() > 150  # the planted detections are there


def test_parity_report_reads_zero_delta_on_every_row(tmp_path):
    out = tmp_path / "PARITY_TORCH.md"
    res = torch_parity_report.main(["--device", "cpu", "--images", "3", "--out", str(out)])
    names = [r["pipeline"] for r in res["rows"]]
    assert names == [torch_parity_report.ORACLE] + [r[0] for r in torch_parity_report.ROWS]
    assert res["device"] == "CPU" and res["size"] == [256, 256] and res["classes"] == 8
    for r in res["rows"]:
        assert f"{r['delta_ap']:+.4f}" == "+0.0000", r
        assert r["nms_launches"] == 0  # the CPU runs the plain version
    assert res["rows"][0]["ap"] > 0.3
    text = out.read_text()
    assert text.startswith("# Detection parity of the PyTorch port")
    assert text.count("| +0.0000 |") == len(names)


def test_loss_oracle_equals_jax_tools_oracle():
    jax_tool = _jax_tool("loss_parity")
    rng = np.random.default_rng(3)
    anchors = np.concatenate([a for a in torch_parity_report.generate_anchors_per_level((64, 96))])
    cls = torch.from_numpy(rng.normal(-3, 1, (len(anchors), 5)).astype(np.float32))
    reg = torch.from_numpy(rng.normal(0, 0.3, (len(anchors), 4)).astype(np.float32))
    gt = torch.tensor([[4.0, 6.0, 40.0, 50.0], [30.0, 10.0, 90.0, 60.0], [0.0, 0.0, 20.0, 16.0]])
    labels = torch.tensor([1, 5, 3])
    anchors = torch.from_numpy(anchors)
    got = {}
    for n in (3, 0):  # an image without GT has every anchor ignored
        want = jax_tool.oracle_loss_one(cls, reg, anchors, gt[:n], labels[:n])
        got[n] = torch_loss_parity.oracle_loss_one(cls, reg, anchors, gt[:n], labels[:n])
        for a, b in zip(got[n], want):
            assert float(a) == float(b)
    assert float(got[3][0]) > 0 and float(got[3][1]) > 0


def test_loss_parity_within_bar(tmp_path):
    out = tmp_path / "p.md"
    res = torch_loss_parity.main(["--device", "cpu", "--size", "128x192", "--out", str(out)])
    assert res["within_bar"] and res["kernel_bitwise_equal_plain"]
    assert res["max_abs_delta"] <= min(torch_loss_parity.BAR.values())
    assert res["port_plain"]["match_launches"] == res["port_kernel"]["match_launches"] == 0
    assert "## Loss path: 128x192, 90 classes, batch 4" in out.read_text()


TOY = ["--device", "cpu", "--backbone", "resnet18", "--size", "64x96", "--iters", "1",
       "--compute-dtype", "float32"]


def test_profile_backward_stages_sum_to_the_backward(tmp_path):
    out = tmp_path / "b.jsonl"
    rec = torch_profile_backward.main(TOY + ["--batch", "2", "--out", str(out)])
    assert json.loads(out.read_text().splitlines()[-1]) == json.loads(json.dumps(rec))
    assert rec["device"] == "CPU" and rec["batch"] == 2 and rec["hw"] == [64, 96]
    for bn in ("frozen", "live"):
        r = rec["bn"][bn]
        assert [row["stage"] for row in r["rows"]] == list(torch_profile_backward.STAGES)
        for row in r["rows"]:
            assert row["fwd_ms"] > 0 and row["bwd_ms"] > 0, row
        assert all(row["fwd_gflop"] is None for row in r["rows"])  # basic trunks: untabulated
        # One iteration: the stage sum is the hooked backward it was cut from.
        assert r["stage_sum_bwd_ms"] == pytest.approx(r["hooked_backward_ms"], rel=1e-9)
        assert r["step_ms"] > 0 and r["backward_ms"] > 0 and r["forward_loss_ms"] > 0
        assert r["backward_kernels"] is None  # the profiler's kernel table is the card's


def test_stage_gflop_equals_jax_profile_backbone():
    jax_tool = _jax_tool("profile_backbone")
    want = jax_tool.stage_flops_bytes(800, 1344, 2)
    g = torch_profile_backward.stage_gflop("resnet50", 800, 1344, 2, 90)
    for stage in ("stem", "layer1", "layer2", "layer3", "layer4"):
        assert g[stage] == want[stage][0] / 1e9
    assert g["loss"] == 0 and g["head"] > g["fpn"] > 0


def test_bench_train_sweep_fields(tmp_path):
    out = tmp_path / "t.json"
    torch_bench_train.main(TOY + ["--batches", "2", "--out", str(out)])
    res = json.loads(out.read_text())
    assert res["device"] == "CPU" and res["model"]["backbone_kind"] == "resnet18"
    assert [(p["batch"], p["remat"]) for p in res["sweep"]] == [(2, False), (2, True)]
    for p in res["sweep"]:
        assert p["step_ms"] > 0 and p["img_per_sec"] == pytest.approx(2e3 / p["step_ms"])
    assert res["knee"] == {"remat=False": 2, "remat=True": 2}
    assert res["best"]["batch"] == 2


def test_bench_loader_fields(tmp_path):
    out = tmp_path / "l.json"
    res = torch_bench_loader.main(["--device", "cpu", "--images", "4", "--out", str(out),
                                   "--data-dir", str(tmp_path / "data")])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert set(res["stage_ms"]) == {"decode", "tofloat", "flip_u8", "flip_f32", "resize_u8",
                                    "resize_f32", "pad_u8", "pad_f32", "targets"}
    assert set(res["per_image_ms"]) == {"sample_prep_f32", "full_pipeline",
                                        "full_pipeline_uint8", "full_pipeline_train"}
    assert all(v > 0 for v in res["stage_ms"].values())
    assert res["host"]["cpu_count"] >= 1 and not res["host"]["pinned"]
    assert res["images"] == 4
