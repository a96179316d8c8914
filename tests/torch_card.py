"""What the card test files (``tests/test_torch_card_*.py``) share.

Their tests are marked ``cuda`` and skip without a card through the ``dev``
fixture; nothing here touches CUDA while it is imported, and nothing
imports JAX, so the files collect on the CPU and run on a machine that has
only PyTorch. On the card, with the repository's conftest skipped (it sets
JAX up):

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py \\
        tests/test_torch_card_*.py

The flows run at the widths of ``configs/hparams.yaml``: R50-FPN, 90
classes, the 800x1344 bucket, seeded uint8 batches of 16 (the main path's
values, shapes and seeded inputs are ``tools/torch_main_path.py``'s), with
TF32 off as the f32 comparisons need.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.join(REPO, "tools") not in sys.path:
    sys.path.insert(0, os.path.join(REPO, "tools"))

from torch_main_path import (  # noqa: E402,F401
    BATCH, H, HPARAMS, LEVEL_ANCHORS, MAX_GT, TRAIN_BATCH, W, bottleneck_inputs, focal_inputs,
    frozen_bn_inputs, main_path_batch, main_path_net, match_inputs, r50_frozen_bn_shapes,
    recording, seeded_gt, served_model_class,
)

TRAIN_STEPS = 7
# One step on the card against one on the CPU (f32), and remat on against
# off: the step's loss, relative. cuDNN's f32 backward algorithms sum (or
# transform) in another order than the CPU's.
STEP_LOSS_RTOL = 1e-4


@pytest.fixture(scope="module")
def dev():
    """The card, with TF32 off for the module (the f32 comparisons)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    torch.cuda.empty_cache()


def counted(fn):
    """(``fn()``, the launches of each registry kernel during that call)."""
    from pytorch_retinanet_tpu_torch.kernels import KERNELS, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k.name: k.wrapper.launches for k in KERNELS}


def seeded_batches(steps: int, batch: int, seed: int) -> list:
    """A train loader: `steps` batches at 800x1344 of the same seeded uint8
    images and seeded GT, 1-100 boxes an image and none in the first image
    of each batch."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (batch, H, W, 3), dtype=np.uint8)
    out = []
    for _ in range(steps):
        n_valid = rng.integers(1, MAX_GT + 1, batch)
        n_valid[0] = 0
        out.append({"images": images, **seeded_gt(rng, n_valid, H, W, 90)})
    return out


def small_batch(rng: np.random.Generator, n_valid) -> dict:
    """f32 128x192 images in [0, 1) and padded GT, `n_valid[i]` boxes in
    image i: the draw the small card-against-CPU and rank-against-one-process
    runs are held on (GT first, then images)."""
    gt = seeded_gt(rng, n_valid, 128, 192, 90)
    return {**gt, "images": rng.random((len(n_valid), 128, 192, 3), dtype=np.float32)}


def fit_seven(hparams: dict = HPARAMS, **trainer_kw):
    """``Trainer(max_steps=7).fit`` of R50-FPN on seeded batches of 16 at
    800x1344: (model, trainer, launches during the fit, the module's state
    before it)."""
    from pytorch_retinanet_tpu_torch import ConfigDict, Trainer

    model = served_model_class()(ConfigDict(hparams))
    model.loader = seeded_batches(TRAIN_STEPS, TRAIN_BATCH, seed=7)
    before = {k: v.detach().clone() for k, v in model.net.module.state_dict().items()}
    trainer = Trainer(max_steps=TRAIN_STEPS, warmup_steps=500, gradient_clip_val=None,
                      log_every_n_steps=1, **trainer_kw)
    _, launches = counted(lambda: trainer.fit(model))
    return model, trainer, launches, before


def check_detections(preds, score_thres: float = 0.05, h: float = 800, w: float = 1333) -> None:
    """Per image: boxes [n, 4], scores and labels [n], n > 0, finite, labels in
    1..90, scores in (score_thres, 1], boxes inside the h x w image."""
    for p in preds:
        b, s, lab = p["boxes"], p["scores"], p["labels"]
        assert b.ndim == 2 and b.shape[1] == 4 and len(b) == len(s) == len(lab) > 0
        assert np.isfinite(b).all() and np.isfinite(s).all()
        assert ((lab >= 1) & (lab <= 90)).all() and ((s > score_thres) & (s <= 1)).all()
        assert not (b < -1e-3).any()
        assert not (b[:, [0, 2]] > w + 1e-2).any() and not (b[:, [1, 3]] > h + 1e-2).any()


def valid_detections(det) -> list:
    """A batch's ``Detections`` as per-image numpy dicts of the valid rows."""
    boxes, scores, labels, valid = (t.cpu().numpy() for t in det)
    return [{"boxes": boxes[i][valid[i]], "scores": scores[i][valid[i]],
             "labels": labels[i][valid[i]]} for i in range(len(valid))]


# COCO's 80 category ids, non-contiguous in 1..90.
COCO_IDS = [i for i in range(1, 91) if i not in (12, 26, 29, 30, 45, 66, 68, 69, 71, 83)]
# (images, landscape images) a split: every test bucket ends in a partial
# batch of 32 (58 = 32 + 26, 38 = 32 + 6); train gives 3 full batches of 16.
DATA_SPLITS = {"val": (96, 58), "train": (48, 32)}
TEST_BATCH = 32


def write_coco_split(root: str, split: str, rng: np.random.Generator) -> dict:
    """`split`2017/ of seeded JPEGs (COCO-like 640x480 and 480x640, about a
    fifth 1333x800 and 800x1333) and annotations/instances_`split`2017.json:
    1-30 solid rectangles an image labelled with COCO ids, a few crowd boxes,
    and in val one image without annotations."""
    import cv2

    n, n_land = DATA_SPLITS[split]
    img_dir = os.path.join(root, f"{split}2017")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    images, anns = [], []
    for i in range(n):
        h, w = (800, 1333) if rng.random() < 0.2 else (480, 640)
        if i >= n_land:
            h, w = w, h
        noise = rng.integers(0, 256, (h // 16 + 1, w // 16 + 1, 3), dtype=np.uint8)
        img = cv2.resize(noise, (w, h), interpolation=cv2.INTER_NEAREST)
        image_id = 1000 * (split == "train") + i + 1
        for _ in range(0 if (split == "val" and i == n - 1) else int(rng.integers(1, 31))):
            bw, bh = (float(v) for v in rng.uniform(8, 0.45 * min(h, w), 2))
            x, y = float(rng.uniform(0, w - bw)), float(rng.uniform(0, h - bh))
            cv2.rectangle(img, (int(x), int(y)), (int(x + bw), int(y + bh)),
                          tuple(int(c) for c in rng.integers(0, 256, 3)), -1)
            anns.append({"id": len(anns) + 1, "image_id": image_id,
                         "category_id": int(rng.choice(COCO_IDS)), "bbox": [x, y, bw, bh],
                         "area": bw * bh, "iscrowd": int(rng.random() < 0.03)})
        cv2.imwrite(os.path.join(img_dir, f"{image_id:012d}.jpg"), img,
                    [cv2.IMWRITE_JPEG_QUALITY, 90])
        images.append({"id": image_id, "file_name": f"{image_id:012d}.jpg", "height": h,
                       "width": w})
    coco = {"images": images, "annotations": anns,
            "categories": [{"id": c, "name": str(c)} for c in COCO_IDS]}
    with open(os.path.join(root, "annotations", f"instances_{split}2017.json"), "w") as f:
        json.dump(coco, f)
    return coco


def coco_conf(root: str) -> dict:
    """R50-FPN at full width on the seeded COCO dataset under `root`."""
    from pytorch_retinanet_tpu_torch import ConfigDict

    return ConfigDict(HPARAMS).merge({
        "model": {"score_thres": 0.001},
        "dataset": {"kind": "coco", "root_dir": root},
        "dataloader": {"test_bs": TEST_BATCH, "args": {"num_workers": 8}},
        "transforms": [{"class_name": "albumentations.HorizontalFlip", "params": {"p": 0.5}}],
    })


def write_coco_dataset(root: str) -> dict:
    """Both splits (seed 20) under `root`: split -> its COCO dict."""
    rng = np.random.default_rng(20)
    return {split: write_coco_split(root, split, rng) for split in ("val", "train")}
