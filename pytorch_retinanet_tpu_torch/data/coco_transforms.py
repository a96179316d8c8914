"""(image, target)-style COCO transforms — reference-surface adapters.

The port's copy of ``pytorch_retinanet_tpu/data/coco_transforms.py``.

The reference ships a small `(image, target)` transform module for the COCO
path (``utils/coco/coco_transforms.py:16-49``: ``Compose``,
``RandomHorizontalFlip``, ``ToTensor``). The framework's native augmentation
API operates on ``(image, boxes, labels)`` (:mod:`.transforms`); this module
keeps the reference's callable surface for user code that composes COCO
transforms directly. Target-style pipelines are the ones that keep masks and
keypoints geometrically consistent with the image (RandomHorizontalFlip flips
all three together) — :class:`~.coco.CocoDetectionDataset` routes the full
target through them when ``return_masks``/``return_keypoints`` is on.

``ToTensor`` here converts to float32 HWC in [0, 1] — the NHWC analog of the
reference's CHW tensor conversion (the detector takes NHWC batches).

Like :mod:`.transforms`, every transform accepts an optional
``rng: np.random.Generator`` for deterministic per-sample augmentation.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .transforms import _rng, accepts_rng

Sample = Tuple[np.ndarray, Dict[str, np.ndarray]]


class Compose:
    """Chain (image, target) transforms (reference coco_transforms.py:16-22)."""

    # Marks this pipeline as operating on the full target dict (masks,
    # keypoints included) — checked by CocoDetectionDataset.
    target_style = True

    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, image, target, rng=None) -> Sample:
        for t in self.transforms:
            if rng is not None and accepts_rng(t):
                image, target = t(image, target, rng=rng)
            else:
                image, target = t(image, target)
        return image, target


class RandomHorizontalFlip:
    """Mirror image + boxes (+ masks/keypoints when present) — reference
    coco_transforms.py:25-40, including the COCO keypoint left/right remap
    (coco_transforms.py:6-13)."""

    # COCO 17-keypoint left<->right index swap (reference coco_transforms.py:6-13).
    FLIP_INDS: List[int] = [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15]

    def __init__(self, prob: float = 0.5):
        self.prob = prob

    def __call__(self, image, target, rng=None) -> Sample:
        if _rng(rng).random() < self.prob:
            width = image.shape[1]
            image = np.ascontiguousarray(image[:, ::-1])
            target = dict(target)
            boxes = np.asarray(target["boxes"], np.float32).reshape(-1, 4)
            if len(boxes):
                boxes = boxes.copy()
                boxes[:, [0, 2]] = width - boxes[:, [2, 0]]
            target["boxes"] = boxes
            if "masks" in target and target["masks"] is not None:
                target["masks"] = np.ascontiguousarray(
                    np.asarray(target["masks"])[..., ::-1]
                )
            if "keypoints" in target and target["keypoints"] is not None:
                kps = np.asarray(target["keypoints"]).copy()  # [N, 17, 3]
                kps = kps[:, self.FLIP_INDS]
                kps[..., 0] = width - kps[..., 0]
                target["keypoints"] = kps
        return image, target


class ToTensor:
    """uint8 HWC -> float32 HWC in [0,1] (reference coco_transforms.py:43-49;
    NHWC instead of CHW, the layout of the detector's batches)."""

    def __call__(self, image, target, rng=None) -> Sample:
        image = np.asarray(image)
        if image.dtype == np.uint8:
            image = image.astype(np.float32) / 255.0
        return image.astype(np.float32), target


class TargetTransformAdapter:
    """Wrap an (image, target) pipeline into the framework's
    (image, boxes, labels) transform interface."""

    def __init__(self, transform):
        self.transform = transform

    def __call__(self, image, boxes, labels, rng=None):
        target = {"boxes": boxes, "labels": labels}
        if rng is not None and accepts_rng(self.transform):
            image, target = self.transform(image, target, rng=rng)
        else:
            image, target = self.transform(image, target)
        return image, target["boxes"], np.asarray(target["labels"])
