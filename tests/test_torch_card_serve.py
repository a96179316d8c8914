"""Export and serving on the card, at full width.

R50-FPN (90 classes, prior 0.5, seed 0) exported with
``export.save_exported`` for both buckets (800x1344, 1344x800) at batch 8 on
the uint8 wire, and loaded:

- each artifact takes [8, H, W, 3] uint8 on the card; its weights and
  buffers equal the module's bit for bit, with the same strides; one call on
  8 seeded uint8 images launches the stem (on uint8) and NMS once and nothing
  else, and equals ``Retinanet._predict_impl``: labels and valid exactly,
  boxes and scores bit for bit or within 1e-3 px and 1e-5;
- ``examples/torch_serve.py``'s ``serve`` over 20 seeded landscape JPEGs of
  mixed sizes at depth 2 launches stem and NMS once a batch (3), and equals
  ``Retinanet.predict`` in the server's batches of 8 (the last filled up with
  black images: cuDNN picks its algorithms by batch size): labels exactly,
  scores within 1e-5, boxes within 1e-3 px.

Run on the card as ``tests/torch_card.py`` says.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import pytest
import torch
from torch_card import REPO, check_detections, counted, dev, main_path_net  # noqa: F401

from pytorch_retinanet_tpu_torch.kernels import stem_forward
from pytorch_retinanet_tpu_torch.models.retinanet import resolution_buckets

pytestmark = pytest.mark.cuda

SERVE_BATCH = 8
# 20 landscape JPEGs of mixed sizes: two full batches of 8 and a partial one.
SERVE_SIZES = ((800, 1333), (480, 640), (600, 1000), (720, 1280), (427, 640))
SERVE_IMAGES = 20
SERVE_SCORE_TOL, SERVE_BOX_TOL = 1e-5, 1e-3


@pytest.fixture(scope="module")
def exported(dev, tmp_path_factory):
    """The net and its loaded artifacts, bucket -> callable."""
    from pytorch_retinanet_tpu_torch.export import load_exported, save_exported

    work = str(tmp_path_factory.mktemp("export"))
    net = main_path_net()
    artifacts = {}
    for bucket in resolution_buckets(net.min_size, net.max_size):
        path = os.path.join(work, f"r50_{bucket[0]}x{bucket[1]}_b{SERVE_BATCH}_u8.pt2")
        save_exported(net, path, SERVE_BATCH, bucket, wire_dtype="uint8")
        artifacts[bucket] = load_exported(path)
    yield net, artifacts, work
    del net, artifacts
    torch.cuda.empty_cache()


def only_stem_and_nms(launches: dict, calls: int) -> bool:
    return launches == {k: calls if k in ("fused_stem", "nms_keep_mask") else 0 for k in launches} \
        and stem_forward.last_dtype == torch.uint8


@pytest.mark.parametrize("which", [0, 1], ids=["landscape", "portrait"])
def test_artifact_equals_eager_predict(exported, which):
    net, artifacts, _ = exported
    bucket = resolution_buckets(net.min_size, net.max_size)[which]
    infer = artifacts[bucket]
    assert infer.in_shapes[0] == ((SERVE_BATCH, *bucket, 3), torch.uint8)
    assert infer.device == net.device
    mine = dict(net.module.named_parameters())
    mine.update(net.module.named_buffers())
    anchors = net._anchors_for(bucket)
    for name, t in list(infer.program.named_parameters()) + list(infer.program.named_buffers()):
        ref = anchors[int(name[8:])] if name.startswith("anchors_") else mine[name[7:]]
        assert torch.equal(t, ref) and t.stride() == ref.stride(), name
    h, w = bucket
    x = torch.from_numpy(np.random.default_rng(13 + which).integers(
        0, 256, (SERVE_BATCH, h, w, 3), dtype=np.uint8)).to(net.device)
    resized = (net.min_size, net.max_size) if h < w else (net.max_size, net.min_size)
    sizes = torch.tensor([resized] * SERVE_BATCH, dtype=torch.float32, device=net.device)
    got, launches = counted(lambda: infer.dispatch(x, sizes))
    assert only_stem_and_nms(launches, 1), launches
    want = net._predict_impl(x, sizes)
    for g, r in zip(got, want):
        assert g.shape == r.shape and g.dtype == r.dtype
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        assert float((got[0] - want[0]).abs().max()) <= SERVE_BOX_TOL
        assert float((got[1] - want[1]).abs().max()) <= SERVE_SCORE_TOL


def test_serve_loop_equals_predict_in_its_batches(exported):
    import cv2

    net, artifacts, work = exported
    infer = artifacts[resolution_buckets(net.min_size, net.max_size)[0]]
    spec = importlib.util.spec_from_file_location(
        "torch_serve", os.path.join(REPO, "examples", "torch_serve.py"))
    serve = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(serve)
    rng = np.random.default_rng(14)
    paths = []
    for i in range(SERVE_IMAGES):
        h, w = SERVE_SIZES[i % len(SERVE_SIZES)]
        paths.append(os.path.join(work, f"{i:02d}.jpg"))
        cv2.imwrite(paths[-1], rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    serve.serve(infer, paths[:SERVE_BATCH])  # warm-up
    got, launches = counted(lambda: serve.serve(infer, paths, depth=2))
    assert only_stem_and_nms(launches, -(-SERVE_IMAGES // SERVE_BATCH)), launches
    decoded = [serve.read_rgb(p) for p in paths]
    want = []
    for i in range(0, SERVE_IMAGES, SERVE_BATCH):
        chunk = decoded[i:i + SERVE_BATCH]
        fill = [np.zeros_like(chunk[0])] * (SERVE_BATCH - len(chunk))
        want += net.predict(chunk + fill)[:len(chunk)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["labels"], w["labels"])
        if len(g["labels"]):
            assert float(np.abs(g["scores"] - w["scores"]).max()) <= SERVE_SCORE_TOL
            assert float(np.abs(g["boxes"] - w["boxes"]).max()) <= SERVE_BOX_TOL
    check_detections(got)
