"""The port's serving loop (``examples/torch_serve.py``), its export CLI
(``tools/torch_export_model.py``) and its training and inference examples,
on the CPU.

The serve core runs a uint8 artifact of a small detector (resnet18, 4
classes, min 64 / max 96, f32, prior 0.5, batch 2) over seeded JPEGs on
disk and is held against ``Retinanet.predict`` on the same decoded images:
labels exactly, scores within 1e-5, boxes within 1e-3 px (the serve loop
resizes with cv2 on the host, ``predict`` with its integer emulation of
cv2 on the device, bit for bit the same pixels; the batches differ in size,
and the CPU convolutions may sum a different batch in another order).
The examples run as subprocesses for one epoch of 2 steps on 4 CSV (or VOC) images.
"""

from __future__ import annotations

import importlib.util
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pandas as pd
import pytest
import torch

from pytorch_retinanet_tpu_torch.export import export_inference, load_exported
from pytorch_retinanet_tpu_torch.models import Retinanet

ROOT = Path(__file__).resolve().parents[1]
KW = dict(num_classes=4, backbone_kind="resnet18", pretrained=False, min_size=64,
          max_size=96, compute_dtype="float32", prior=0.5)


def _load_serve():
    spec = importlib.util.spec_from_file_location("torch_serve", ROOT / "examples" / "torch_serve.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


torch_serve = _load_serve()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The detector, its uint8 artifact at batch 2, and 3 seeded landscape
    JPEGs of mixed sizes (two batches, the last one partial)."""
    net = Retinanet(device="cpu", seed=0, **KW)
    infer = load_exported(export_inference(net, 2, wire_dtype="uint8"))
    root = tmp_path_factory.mktemp("serve")
    rng = np.random.default_rng(0)
    paths = []
    for i, (h, w) in enumerate([(60, 90), (48, 80), (70, 100)]):
        path = str(root / f"{i}.jpg")
        cv2.imwrite(path, rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        paths.append(path)
    return net, infer, paths


@pytest.mark.parametrize("depth", [1, 2])
def test_serve_equals_predict(served, depth):
    net, infer, paths = served
    got = torch_serve.serve(infer, paths, depth=depth)
    want = net.predict([torch_serve.read_rgb(p) for p in paths])
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == {"boxes", "scores", "labels"}
        assert len(g["labels"]) == len(w["labels"]) > 0
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=0, atol=1e-3)


def test_serve_takes_decoded_images(served):
    _, infer, paths = served
    images = [torch_serve.read_rgb(p) for p in paths]
    from_paths, from_arrays = torch_serve.serve(infer, paths), torch_serve.serve(infer, images)
    for a, b in zip(from_paths, from_arrays):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_serve_refuses_the_other_orientation(served):
    _, infer, _ = served
    tall = np.zeros((100, 60, 3), np.uint8)
    with pytest.raises(ValueError, match=r"bucket \(96, 64\), artifact is \(64, 96\)"):
        torch_serve.serve(infer, [tall])
    with pytest.raises(ValueError, match="depth"):
        torch_serve.serve(infer, [tall], depth=0)


def _run(args, timeout=300):
    out = subprocess.run([sys.executable, *args], capture_output=True, text=True,
                         timeout=timeout, cwd=ROOT)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    return out.stdout


def test_export_cli_and_serve_script(served, tmp_path):
    _, _, paths = served
    out = _run(["tools/torch_export_model.py", "--backbone", "resnet18", "--num-classes", "4",
                "--min-size", "64", "--max-size", "96", "--batch", "2", "--wire-dtype", "uint8",
                "--device", "cpu", "--out-dir", str(tmp_path)])
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["resnet18_64x96_b2_u8.pt2", "resnet18_64x96_b2_u8.pt2.json",
                     "resnet18_96x64_b2_u8.pt2", "resnet18_96x64_b2_u8.pt2.json"], out
    art = str(tmp_path / "resnet18_64x96_b2_u8.pt2")
    assert "ok: device=cpu batch=2 bucket=64x96" in _run(["tools/torch_export_model.py",
                                                          "--check", art])
    served_out = _run(["examples/torch_serve.py", art, *paths])
    assert [line.split(":")[0] for line in served_out.splitlines() if not line.startswith(" ")] \
        == paths


@pytest.fixture(scope="module")
def csv_dataset(tmp_path_factory):
    """4 images of a rectangle on white, in the reference CSV schema."""
    root = tmp_path_factory.mktemp("csv_examples")
    rng = np.random.default_rng(3)
    rows = []
    for i in range(4):
        img = np.full((100, 80, 3), 255, np.uint8)
        x1, y1 = int(rng.integers(5, 30)), int(rng.integers(5, 40))
        img[y1:y1 + 30, x1:x1 + 30] = (200, 30, 30)
        path = str(root / f"{i}.png")
        cv2.imwrite(path, img)
        rows.append({"filename": path, "width": 80, "height": 100, "class": "car",
                     "xmin": float(x1), "ymin": float(y1), "xmax": float(x1 + 30),
                     "ymax": float(y1 + 30), "labels": 1})
    pd.DataFrame(rows).to_csv(root / "train.csv", index=False)
    return root


def test_train_csv_then_infer_examples(csv_dataset, tmp_path):
    small = ["--backbone", "resnet18", "--num-classes", "1", "--min-size", "64",
             "--max-size", "96", "--device", "cpu", "--compute-dtype", "float32"]
    out = _run(["examples/torch_train_csv.py", "--csv", str(csv_dataset / "train.csv"),
                "--epochs", "1", "--batch-size", "2", "--checkpoint-dir", str(tmp_path / "ck"),
                *small])
    metrics = next(line for line in out.splitlines() if line.startswith("train metrics:"))
    assert "nan" not in metrics and "loss" in metrics
    assert "test results: [{'AP':" in out
    ckpt = torch.load(tmp_path / "ck" / "last" / "checkpoint.pt", weights_only=True)
    assert ckpt["global_step"] == 2
    images = [str(csv_dataset / f"{i}.png") for i in range(2)]
    out = _run(["examples/torch_infer.py", "--state", str(tmp_path / "ck" / "last"),
                "--images", *images, "--out-dir", str(tmp_path / "det"), "--score-thresh", "0",
                *small])
    assert len(out.splitlines()) == 2
    for i in range(2):
        drawn = cv2.imread(str(tmp_path / "det" / f"{i}.png"))
        assert drawn is not None and drawn.shape == (100, 80, 3)


def test_demo_voc_example(csv_dataset, tmp_path):
    """VOC XML -> CSV -> fit -> test -> save -> reload -> predict -> draw."""
    ann = tmp_path / "xml"
    ann.mkdir()
    for i in range(4):
        (ann / f"{i}.xml").write_text(
            f"<annotation><filename>{i}.png</filename><size><width>80</width><height>100"
            "</height><depth>3</depth></size><object><name>car</name><bndbox><xmin>10</xmin>"
            "<ymin>12</ymin><xmax>40</xmax><ymax>50</ymax></bndbox></object></annotation>")
    out = _run(["examples/torch_demo_voc.py", "--ann-dir", str(ann), "--img-dir", str(csv_dataset),
                "--backbone", "resnet18", "--epochs", "1", "--batch-size", "2", "--min-size", "64",
                "--max-size", "96", "--device", "cpu", "--compute-dtype", "float32",
                "--out-dir", str(tmp_path / "demo")])
    assert "4 boxes / 4 images, classes: ['car']" in out and "test: [{'AP':" in out
    for name in ("gt.png", "pred.png"):
        assert cv2.imread(str(tmp_path / "demo" / name)).shape == (100, 80, 3)
