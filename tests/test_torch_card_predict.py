"""Predict and the opt-in fused trunk on the card, at full width.

R50-FPN (90 classes, prior 0.5, seed 0) on 32 seeded 800x1333 uint8 images,
the 800x1344 bucket (``main_path_net`` and ``main_path_batch`` of
``tools/torch_main_path.py``):

- ``predict`` launches the stem kernel once, on the uint8 batch, and NMS;
  its detections are finite, in range and inside the images;
- the NMS kernel equals its plain version on that batch's candidates;
- ``predict`` on the card equals ``predict`` on the CPU at 128x192, in f32
  (labels exactly, boxes within 1e-2, scores within 1e-5) and on uint8
  images resized on the device (sorted scores within 1e-5; labels and boxes
  at every rank whose score is 2e-5 from its neighbours');
- the fused trunk (``apply_detector(use_fused_trunk=True)``) launches the
  bottleneck kernel 10 times a forward, and c3-c5 and every head output stay
  within 2**-4 of the largest |value| of the module forward (both round to
  bf16 after every conv or BN, at other points, and one-ulp differences grow
  through 16 blocks, the FPN and the head of a random R50);
- predict through the fused trunk launches the stem, bottleneck and NMS
  kernels, and the top-2 kernel equals its plain version on its logits.

Run on the card as ``tests/torch_card.py`` says; ``-k fused`` picks the
fused trunk's tests.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch_card import (  # noqa: F401
    check_detections, counted, dev, main_path_batch, main_path_net, valid_detections,
)

from pytorch_retinanet_tpu_torch.kernels import (
    nms_keep_mask, nms_keep_mask_plain, stem_forward, top2_classes,
    top2_classes_plain,
)
from pytorch_retinanet_tpu_torch.models import (
    Retinanet, apply_detector, apply_trunk_fused, stem_constants,
)
from pytorch_retinanet_tpu_torch.ops import (
    merge_candidates, multilevel_candidates, process_detections_multilevel_batch,
)

pytestmark = pytest.mark.cuda

TRUNK_DRIFT = 2.0**-4


@pytest.fixture(scope="module")
def r50(dev):
    images, batch, sizes = main_path_batch(dev)
    net = main_path_net()
    net.predict(images[:2])  # cuDNN plans and the allocator, outside the counts
    yield net, images, batch, sizes
    del net, batch
    torch.cuda.empty_cache()


def test_predict_at_batch_32_launches_the_stem_once_on_uint8(r50):
    net, images, _, _ = r50
    preds, launches = counted(lambda: net.predict(images))
    assert launches["fused_stem"] == 1 and stem_forward.last_dtype == torch.uint8
    assert launches["nms_keep_mask"] >= 1
    check_detections(preds)


def test_nms_kernel_equals_plain_on_the_predict_candidates(r50):
    net, _, batch, sizes = r50
    with torch.inference_mode():
        cls_l, box_l = apply_detector(net.module, batch, return_levels=True)
        cand = multilevel_candidates(cls_l, box_l, net._anchors_for(tuple(batch.shape[1:3])))
        cboxes, _, cidx, valid = merge_candidates(*cand, sizes)
        boxes = cboxes + (cidx.float() * 4097.0)[..., None]
        keep = nms_keep_mask(boxes, valid, net.nms_thres)
        assert torch.equal(keep, nms_keep_mask_plain(boxes, valid, net.nms_thres))


@pytest.fixture(scope="module")
def card_and_cpu(dev):
    kw = dict(backbone_kind="resnet50", num_classes=90, pretrained=False, prior=0.5, seed=1,
              min_size=128, max_size=192, compute_dtype="float32")
    card, cpu = Retinanet(**kw), Retinanet(device="cpu", **kw)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    return card, cpu


def test_f32_predict_on_the_card_equals_the_cpu(card_and_cpu):
    card, cpu = card_and_cpu
    small = [np.random.default_rng(41 + i).random((128, 192, 3), dtype=np.float32)
             for i in range(2)]
    for g, c in zip(card.predict(small), cpu.predict(small)):
        np.testing.assert_array_equal(g["labels"], c["labels"])
        assert float(np.abs(g["boxes"] - c["boxes"]).max()) <= 1e-2
        assert float(np.abs(g["scores"] - c["scores"]).max()) <= 1e-5


def test_uint8_predict_resized_on_the_card_equals_the_cpu(card_and_cpu):
    """Two portrait 150x100 uint8 images resized to 192x128 (one uint8
    batch). Random weights put many scores within 1e-5 of each other, and
    such neighbours may trade places: the sorted scores agree within 1e-5,
    and labels and boxes at every rank whose score is 2e-5 from its
    neighbours' (the last of a full list only if nothing was cut below it)."""
    card, cpu = card_and_cpu
    rng = np.random.default_rng(42)
    small8 = [rng.integers(0, 256, (150, 100, 3), dtype=np.uint8) for _ in range(2)]
    for g, c in zip(card.predict(small8), cpu.predict(small8)):
        go, co = (np.argsort(-d["scores"], kind="stable") for d in (g, c))
        gs, cs = g["scores"][go], c["scores"][co]
        assert len(gs) == len(cs) and float(np.abs(gs - cs).max()) <= 1e-5
        gap = np.minimum(np.abs(np.diff(cs, prepend=np.inf)), np.abs(np.diff(cs, append=-np.inf)))
        apart = gap > 2e-5
        apart[-1] &= len(cs) < card.max_detections  # the cut at 100 may fall between neighbours
        np.testing.assert_array_equal(g["labels"][go][apart], c["labels"][co][apart])
        assert float(np.abs(g["boxes"][go][apart] - c["boxes"][co][apart]).max()) <= 1e-2


def test_fused_trunk_forward_follows_the_module(r50):
    net, _, batch, _ = r50
    module = net.module
    resnet = module.backbone.backbone
    with torch.inference_mode():
        scale, shift = resnet.bn1.folded()
        stem = stem_forward(batch, *stem_constants(module, batch.dtype), resnet.conv1.weight,
                            scale, shift)
        module_feats = resnet(None, stem.permute(0, 3, 1, 2))
        module_out = apply_detector(module, batch, return_levels=True)
        fused_out, launches = counted(
            lambda: apply_detector(module, batch, return_levels=True, use_fused_trunk=True))
        fused_feats = apply_trunk_fused(resnet, stem, module.backbone_kind)
    assert launches["fused_bottleneck"] == 10
    pairs = [(k, fused_feats[k], module_feats[k]) for k in ("c3", "c4", "c5")]
    pairs += [(f"{kind} P{lvl + 3}", a, b) for kind, i in (("logits", 0), ("deltas", 1))
              for lvl, (a, b) in enumerate(zip(fused_out[i], module_out[i]))]
    drift = {}
    for name, a, b in pairs:
        a, b = a.float(), b.float()
        assert torch.isfinite(a).all(), name
        drift[name] = ((a - b).abs().max() / b.abs().max()).item()
    assert max(drift.values()) <= TRUNK_DRIFT, drift


@pytest.fixture(scope="module")
def fused_predict(r50):
    """``Retinanet._predict_impl`` through the fused trunk: its detections,
    level logits and launches."""
    net, _, batch, sizes = r50

    def run():
        with torch.inference_mode():
            cls_l, box_l = apply_detector(net.module, batch, return_levels=True,
                                          use_fused_trunk=True)
            det = process_detections_multilevel_batch(
                cls_l, box_l, net._anchors_for(tuple(batch.shape[1:3])), sizes,
                score_thres=net.score_thres, nms_thres=net.nms_thres,
                max_detections=net.max_detections)
        return det, cls_l

    (det, cls_l), launches = counted(run)
    return det, cls_l, launches


def test_fused_trunk_predict_launches_its_kernels(fused_predict):
    det, _, launches = fused_predict
    assert all(launches[k] >= 1 for k in ("fused_stem", "fused_bottleneck", "nms_keep_mask"))
    check_detections(valid_detections(det))


def test_top2_kernel_equals_plain_on_the_fused_predict_logits(fused_predict):
    _, cls_l, _ = fused_predict
    for level in cls_l:
        logits = level.reshape(-1, 90)
        got, want = top2_classes(logits), top2_classes_plain(logits)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (got[1] != got[3]).all() and (got[0] >= got[2]).all()
