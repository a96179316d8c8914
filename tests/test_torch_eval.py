"""The port's COCO evaluator vs the JAX package's (CPU).

Seeded synthetic COCO ground truth over images of 160x200: three
categories, boxes in every area range (small, medium and large), crowd
regions (compressed-RLE segmentations, as real COCO's are) and an
``ignore`` flag; detections are jittered copies of the GT, duplicates and
false positives with random scores, and an image without GT. The same
records go through both packages:

* ``COCOeval`` for bbox, segm (detections as compressed RLE from
  ``masks.encode``) and keypoints (17 per person, OKS): the 12 (10 for
  keypoints) stats within 1e-12 of JAX's, and precision / recall arrays
  within 1e-12;
* ``CocoEvaluator`` fed per-image prediction dicts (boxes, masks,
  keypoints) in one shard, and in two shards merged by
  ``synchronize_between_processes`` with a gather function: every stat
  within 1e-12 of JAX's single-shard evaluator;
* the RLE string codec, area and bbox of ``data.masks``: equal to JAX's.
"""

from __future__ import annotations

import numpy as np
import pytest

from pytorch_retinanet_tpu.data import masks as jax_masks
from pytorch_retinanet_tpu.data.coco import COCOIndex as JaxCOCOIndex
from pytorch_retinanet_tpu.eval.coco_eval import COCOeval as JaxCOCOeval
from pytorch_retinanet_tpu.eval.coco_eval import CocoEvaluator as JaxCocoEvaluator
from pytorch_retinanet_tpu_torch.data import COCOIndex, masks
from pytorch_retinanet_tpu_torch.eval import COCOeval, CocoEvaluator

H, W = 160, 200
TOL = 1e-12
CATS = (1, 3, 7)


def _box(rng, kind):
    """An xywh box whose area falls in `kind`'s range."""
    side = {"small": (6, 28), "medium": (34, 90), "large": (100, 150)}[kind]
    w, h = rng.uniform(*side, 2)
    x, y = rng.uniform(0, W - w), rng.uniform(0, H - h)
    return [float(x), float(y), float(w), float(h)]


def _poly(box):
    x, y, w, h = box
    return [[x, y, x + w, y, x + w, y + h, x + 0.3 * w, y + h]]


def _keypoints(rng, box, visible=True):
    x, y, w, h = box
    kp = np.zeros((17, 3))
    kp[:, 0] = x + rng.uniform(0, w, 17)
    kp[:, 1] = y + rng.uniform(0, h, 17)
    kp[:, 2] = np.where(rng.random(17) < 0.8, 2, 0) if visible else 0
    return kp


def _ground_truth(seed, n_images=8):
    rng = np.random.default_rng(seed)
    images, anns = [], []
    for img_id in range(1, n_images + 1):
        images.append({"id": img_id, "height": H, "width": W, "file_name": f"{img_id}.jpg"})
        if img_id == n_images:
            continue  # an image without annotations
        for _ in range(int(rng.integers(2, 7))):
            box = _box(rng, rng.choice(["small", "medium", "large"]))
            kp = _keypoints(rng, box, visible=rng.random() < 0.85)
            anns.append({"image_id": img_id, "category_id": int(rng.choice(CATS)), "bbox": box,
                         "area": box[2] * box[3], "iscrowd": 0, "segmentation": _poly(box),
                         "keypoints": kp.reshape(-1).tolist(),
                         "num_keypoints": int((kp[:, 2] > 0).sum()),
                         "ignore": int(rng.random() < 0.1)})
        if rng.random() < 0.6:  # a crowd region
            box = _box(rng, "large")
            m = np.zeros((H, W), np.uint8)
            x, y, w, h = (int(v) for v in box)
            m[y:y + h, x:x + w] = 1
            anns.append({"image_id": img_id, "category_id": int(rng.choice(CATS)), "bbox": box,
                         "area": float(m.sum()), "iscrowd": 1,
                         "segmentation": jax_masks.encode(m),
                         "keypoints": [0.0] * 51, "num_keypoints": 0})
    for i, a in enumerate(anns, start=1):
        a["id"] = i
    return {"images": images, "annotations": anns,
            "categories": [{"id": c, "name": str(c)} for c in CATS]}


def _mask_of(box):
    m = np.zeros((H, W), np.uint8)
    x, y, w, h = (int(round(v)) for v in box)
    m[max(y, 0):y + max(h, 1), max(x, 0):x + max(w, 1)] = 1
    return m


def _predictions(gt, seed):
    """Per-image prediction dicts: jittered GT, duplicates, false positives."""
    rng = np.random.default_rng(seed + 100)
    preds = {}
    for img in gt["images"]:
        boxes, scores, labels, kps = [], [], [], []
        for a in gt["annotations"]:
            if a["image_id"] != img["id"] or a["iscrowd"]:
                continue
            for _ in range(int(rng.integers(1, 3))):  # a match and sometimes a duplicate
                x, y, w, h = a["bbox"]
                j = rng.normal(0, 0.08, 4) * [w, h, w, h]
                boxes.append([x + j[0], y + j[1], x + w + j[2], y + h + j[3]])
                scores.append(rng.random())
                labels.append(a["category_id"] if rng.random() < 0.9 else int(rng.choice(CATS)))
                kp = np.asarray(a["keypoints"], np.float64).reshape(17, 3).copy()
                kp[:, :2] += rng.normal(0, 2.0, (17, 2))
                kp[:, 2] = 1
                kps.append(kp)
        for _ in range(int(rng.integers(0, 4))):  # false positives
            x, y, w, h = _box(rng, rng.choice(["small", "medium", "large"]))
            boxes.append([x, y, x + w, y + h])
            scores.append(rng.random())
            labels.append(int(rng.choice(CATS)))
            kps.append(_keypoints(rng, [x, y, w, h]))
        boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
        preds[img["id"]] = {
            "boxes": boxes, "scores": np.asarray(scores), "labels": np.asarray(labels, np.int64),
            "masks": np.stack([_mask_of([b[0], b[1], b[2] - b[0], b[3] - b[1]]) for b in boxes])
            if len(boxes) else np.zeros((0, H, W), np.uint8),
            "keypoints": np.asarray(kps).reshape(-1, 17, 3),
        }
    return preds


def _results(preds, iou_type):
    return {"bbox": CocoEvaluator.prepare_for_coco_detection,
            "segm": CocoEvaluator.prepare_for_coco_segmentation,
            "keypoints": CocoEvaluator.prepare_for_coco_keypoint}[iou_type](preds)


def _evaluate(index_cls, eval_cls, gt, results, iou_type):
    coco_gt = index_cls(gt)
    e = eval_cls(coco_gt, coco_gt.loadRes(results), iou_type)
    e.evaluate()
    e.accumulate()
    e.summarize(verbose=False)
    return e


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("iou_type", ["bbox", "segm", "keypoints"])
def test_cocoeval_stats_match_jax(iou_type, seed):
    gt = _ground_truth(seed)
    results = _results(_predictions(gt, seed), iou_type)
    got = _evaluate(COCOIndex, COCOeval, gt, results, iou_type)
    want = _evaluate(JaxCOCOIndex, JaxCOCOeval, gt, results, iou_type)
    assert len(got.stats) == (10 if iou_type == "keypoints" else 12)
    np.testing.assert_allclose(got.stats, want.stats, rtol=0, atol=TOL)
    for k in ("precision", "recall", "scores"):
        np.testing.assert_allclose(got.eval[k], want.eval[k], rtol=0, atol=TOL, err_msg=k)
    # The synthetic set reaches every range: each stat is a real value.
    assert (got.stats > 0).all(), got.stats


@pytest.mark.parametrize("iou_type", ["bbox", "segm", "keypoints"])
def test_coco_evaluator_one_and_two_shards_match_jax(iou_type):
    gt = _ground_truth(3)
    preds = _predictions(gt, 3)
    ids = sorted(preds)
    want = JaxCocoEvaluator(JaxCOCOIndex(gt), [iou_type])
    want.update(preds)
    want.synchronize_between_processes(lambda obj: [obj])
    want.accumulate()
    want_stats = want.summarize(verbose=False)[iou_type]

    single = CocoEvaluator(COCOIndex(gt), [iou_type])
    for i in ids:  # per-batch updates, one image at a time
        single.update({i: preds[i]})
    single.synchronize_between_processes()  # the single-process identity
    single.accumulate()
    np.testing.assert_allclose(single.summarize(verbose=False)[iou_type], want_stats, rtol=0,
                               atol=TOL)

    # Two ranks, each with half of the images; the gather merges them.
    ranks = [CocoEvaluator(COCOIndex(gt), [iou_type]) for _ in range(2)]
    for r, e in enumerate(ranks):
        e.update({i: preds[i] for i in ids[r::2]})
    sent = [[e.img_ids, e.results[iou_type]] for e in ranks]
    for e in ranks:
        e.synchronize_between_processes(lambda obj: [s[0] if obj is e.img_ids else s[1]
                                                     for s in sent])
        e.accumulate()
        np.testing.assert_allclose(e.summarize(verbose=False)[iou_type], want_stats, rtol=0,
                                   atol=TOL)


def test_rle_string_codec_area_and_bbox_match_jax():
    rng = np.random.default_rng(9)
    for _ in range(5):
        m = np.zeros((37, 29), np.uint8)
        y, x = rng.integers(0, 30), rng.integers(0, 20)
        m[y:y + rng.integers(1, 8), x:x + rng.integers(1, 9)] = 1
        m ^= (rng.random(m.shape) < 0.03).astype(np.uint8)
        rle = masks.encode(m)
        assert rle == jax_masks.encode(m)
        np.testing.assert_array_equal(masks.decode(rle), m)
        np.testing.assert_array_equal(masks.string_to_runs(rle["counts"]),
                                      jax_masks.string_to_runs(rle["counts"]))
        assert masks.area(rle) == jax_masks.area(rle) == int(m.sum())
        np.testing.assert_array_equal(masks.to_bbox(rle), jax_masks.to_bbox(rle))
        poly = [[3.0, 4.0, 20.0, 5.0, 18.0, 30.0, 2.0, 25.0]]
        np.testing.assert_array_equal(masks.segmentation_to_mask(poly, 37, 29),
                                      jax_masks.segmentation_to_mask(poly, 37, 29))
