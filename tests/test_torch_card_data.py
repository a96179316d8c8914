"""Data and eval from files on disk, on the card, at full width.

A seeded COCO-format dataset (``write_coco_dataset`` of
``tests/torch_card.py``: 96 val and 48 train JPEGs of COCO's shapes, 1-30
rectangles each with COCO's 80 ids, a few crowd boxes, one val image without
GT) read through ``dataset.kind: coco`` by R50-FPN at full width:

- the data layer's cv2 and pandas import on the card's machine;
- the evaluator fed its own non-crowd GT reads AP (stats 0-5) and AR@100
  (8-11) of 1 where an area range has GT and -1 where it has none, within
  1e-12;
- ``Trainer.test`` (test_bs 32, score threshold 0.001) launches the stem (on
  the f32 batch) and NMS once a batch, its AP in [0, 1]; ``Trainer.predict``
  gives one entry an image, its boxes inside the original image;
- ``Trainer.fit`` for 4 steps of 16 on the pinned uint8 wire launches the
  match kernel 5 times a step, its losses finite;
- resnet18 at min 96 / max 160 overfits 8 seeded CSV images (300 epochs of 2
  steps, warmup 100, clip 10): ``Trainer.test`` reads AP above 0.5.

Run on the card as ``tests/torch_card.py`` says.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import pytest
import torch
from torch_card import coco_conf, counted, dev, write_coco_dataset  # noqa: F401

from pytorch_retinanet_tpu_torch import ConfigDict, RetinaNetModel, Trainer

pytestmark = pytest.mark.cuda

DATA_TRAIN_STEPS = 4
OVERFIT = {"images": 8, "epochs": 300, "train_bs": 4, "lr": 0.01, "min_ap": 0.5}


@pytest.fixture(scope="module")
def coco(dev, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    return root, write_coco_dataset(root)


def test_the_data_layer_finds_cv2_and_pandas(dev):
    missing = [m for m in ("cv2", "pandas") if importlib.util.find_spec(m) is None]
    assert not missing, f"the port's data layer needs {missing}"


def test_evaluator_on_its_own_gt(coco):
    from pytorch_retinanet_tpu_torch.data import COCOIndex
    from pytorch_retinanet_tpu_torch.eval import CocoEvaluator

    val = coco[1]["val"]
    evaluator = CocoEvaluator(COCOIndex(val), ["bbox"])
    preds = {img["id"]: {"boxes": [], "scores": [], "labels": []} for img in val["images"]}
    for a in val["annotations"]:
        if not a["iscrowd"]:
            x, y, w, h = a["bbox"]
            p = preds[a["image_id"]]
            p["boxes"].append([x, y, x + w, y + h])
            p["scores"].append(1.0)
            p["labels"].append(a["category_id"])
    evaluator.update(preds)
    evaluator.synchronize_between_processes()
    evaluator.accumulate()
    stats = evaluator.summarize(verbose=False)["bbox"]
    areas = [a["area"] for a in val["annotations"] if not a["iscrowd"]]
    ranges = {"small": (0.0, 32.0**2), "medium": (32.0**2, 96.0**2), "large": (96.0**2, 1e10)}
    has = [1.0 if any(lo <= v <= hi for v in areas) else -1.0 for lo, hi in ranges.values()]
    want = {**dict(enumerate([1.0, 1.0, 1.0] + has)), 8: 1.0,
            **{9 + j: w for j, w in enumerate(has)}}
    bad = {i: (float(stats[i]), w) for i, w in want.items() if abs(stats[i] - w) > 1e-12}
    assert not bad, bad


def test_trainer_test_and_predict_launch_once_a_batch(coco):
    import torch_multihost_smoke as mh

    from pytorch_retinanet_tpu_torch.kernels import stem_forward

    root, splits = coco
    model = RetinaNetModel(coco_conf(root))
    model.prepare_data()
    n_batches = len(model.test_dataloader())
    warm = next(iter(model.test_dataloader()))  # cuDNN plans and the allocator, outside the count
    model.net._predict_impl(warm["images"].to(model.net.device),
                            warm["image_sizes"].to(model.net.device))
    trainer = Trainer(logger=False, log_every_n_steps=1000)
    tested, launches = counted(lambda: mh.test_with_records(trainer, model))
    assert launches["fused_stem"] == launches["nms_keep_mask"] == n_batches
    assert stem_forward.last_dtype == torch.float32
    assert 0.0 <= tested["AP"] <= 1.0
    preds = trainer.predict(model)
    ids = {img["id"]: img for img in splits["val"]["images"]}
    assert set(preds) == set(ids)
    for image_id, p in preds.items():
        h, w = ids[image_id]["height"], ids[image_id]["width"]
        b = p["boxes"]
        if len(b):
            assert np.isfinite(b).all() and b.min() >= -1e-3
            assert b[:, [0, 2]].max() <= w + 1e-3 and b[:, [1, 3]].max() <= h + 1e-3


def test_fit_from_coco_on_the_pinned_uint8_wire(coco):
    model = RetinaNetModel(coco_conf(coco[0]))
    trainer = Trainer(max_epochs=2, max_steps=DATA_TRAIN_STEPS, warmup_steps=500,
                      log_every_n_steps=1, num_sanity_val_steps=0, check_val_every_n_epoch=100,
                      logger=False)
    _, launches = counted(lambda: trainer.fit(model))
    losses = trainer.logger_.meters["loss"].window
    assert trainer.global_step == DATA_TRAIN_STEPS and np.isfinite(losses).all()
    assert launches["match_targets"] == 5 * DATA_TRAIN_STEPS
    batch = next(iter(model.train_dataloader()))
    assert batch["images"].dtype == torch.uint8 and batch["images"].is_pinned()


def write_overfit_csv(root: str, rng: np.random.Generator) -> str:
    """8 images of 120x160 with 1-2 red or blue rectangles (2 classes) and
    their CSV in the reference schema."""
    import cv2
    import pandas as pd

    os.makedirs(root, exist_ok=True)
    colors = {"red": (0, 0, 230), "blue": (230, 0, 0)}
    rows = []
    for i in range(OVERFIT["images"]):
        img = np.full((120, 160, 3), 255, np.uint8)
        path = os.path.join(root, f"{i}.png")
        for _ in range(int(rng.integers(1, 3))):
            cls = ["red", "blue"][int(rng.integers(0, 2))]
            w, h = int(rng.integers(30, 70)), int(rng.integers(30, 70))
            x, y = int(rng.integers(0, 160 - w)), int(rng.integers(0, 120 - h))
            cv2.rectangle(img, (x, y), (x + w, y + h), colors[cls], -1)
            rows.append({"filename": path, "width": 160, "height": 120, "class": cls,
                         "xmin": float(x), "ymin": float(y), "xmax": float(x + w),
                         "ymax": float(y + h), "labels": 1 if cls == "red" else 2})
        cv2.imwrite(path, img)
    csv_path = os.path.join(root, "train.csv")
    pd.DataFrame(rows).to_csv(csv_path, index=False)
    return csv_path


def test_resnet18_overfits_eight_csv_images(dev, tmp_path):
    csv_path = write_overfit_csv(str(tmp_path), np.random.default_rng(12))
    hp = ConfigDict({
        "model": {"backbone_kind": "resnet18", "num_classes": 2, "min_size": 96,
                  "max_size": 160, "pretrained": False},
        "dataset": {"kind": "csv", "trn_paths": csv_path, "valid_paths": False,
                    "test_paths": csv_path},
        "dataloader": {"train_bs": OVERFIT["train_bs"], "valid_bs": 8, "test_bs": 8,
                       "args": {"num_workers": 4}},
        "transforms": [],
        "optimizer": {"class_name": "torch.optim.SGD",
                      "params": {"lr": OVERFIT["lr"], "momentum": 0.9, "weight_decay": 1e-4}},
    })
    model = RetinaNetModel(hp)
    trainer = Trainer(max_epochs=OVERFIT["epochs"], warmup_steps=100, gradient_clip_val=10.0,
                      log_every_n_steps=100, num_sanity_val_steps=0, logger=False)
    trainer.fit(model)
    assert trainer.test(model)[0]["AP"] > OVERFIT["min_ap"]
