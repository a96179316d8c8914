"""COCO-format dataset support: JSON index, detection dataset, GT export.

The port's copy of ``pytorch_retinanet_tpu/data/coco.py``.

Rebuild of the reference's COCO pipeline (``utils/coco/coco_utils.py``) without
the pycocotools/torchvision dependencies (the port needs neither):

* :class:`COCOIndex` — a minimal, pycocotools-``COCO``-compatible index over a
  COCO annotation dict/JSON (``imgs``, ``anns``, ``cats``, ``imgToAnns``,
  ``getAnnIds``/``loadAnns``/... surface the evaluator consumes).
* :class:`CocoDetectionDataset` — returns ``(image, target, image_id)`` like
  the reference's ``CocoDetection`` subclass (coco_utils.py:206-217), applying
  the reference's target conversion (xywh→xyxy, clamp, drop crowd/degenerate —
  ``ConvertCocoPolysToMask``, coco_utils.py:48-101) and train-split filtering
  of images without annotations (coco_utils.py:104-141).
* :func:`convert_to_coco_api` — builds an in-memory COCO GT index from ANY
  dataset yielding ``(image, target, image_id)`` (coco_utils.py:144-192), so
  pascal/csv datasets can be COCO-evaluated.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Any, Dict, Iterable, List, Optional, Union

import numpy as np

from .transforms import Compose, ToFloat, Transform, apply_transform


class COCOIndex:
    """Minimal COCO annotation index (pycocotools.coco.COCO surface subset)."""

    def __init__(self, annotations: Union[str, Dict[str, Any], None] = None):
        if isinstance(annotations, str):
            with open(annotations) as f:
                annotations = json.load(f)
        self.dataset: Dict[str, Any] = annotations or {
            "images": [],
            "annotations": [],
            "categories": [],
        }
        self.create_index()

    def create_index(self) -> None:
        self.imgs = {img["id"]: img for img in self.dataset.get("images", [])}
        self.cats = {c["id"]: c for c in self.dataset.get("categories", [])}
        self.anns = {a["id"]: a for a in self.dataset.get("annotations", [])}
        self.imgToAnns: Dict[Any, List[dict]] = defaultdict(list)
        for ann in self.dataset.get("annotations", []):
            self.imgToAnns[ann["image_id"]].append(ann)

    # -- pycocotools-compatible accessors ---------------------------------- #
    def getImgIds(self) -> List[Any]:
        return sorted(self.imgs.keys())

    def getCatIds(self) -> List[Any]:
        return sorted(self.cats.keys())

    def getAnnIds(self, imgIds: Optional[Iterable] = None) -> List[Any]:
        if imgIds is None:
            return sorted(self.anns.keys())
        out: List[Any] = []
        for i in imgIds if isinstance(imgIds, (list, tuple, set)) else [imgIds]:
            out.extend(a["id"] for a in self.imgToAnns.get(i, []))
        return out

    def loadAnns(self, ids: Iterable) -> List[dict]:
        return [self.anns[i] for i in (ids if isinstance(ids, (list, tuple)) else [ids])]

    def loadImgs(self, ids: Iterable) -> List[dict]:
        return [self.imgs[i] for i in (ids if isinstance(ids, (list, tuple)) else [ids])]

    def loadRes(self, results: Union[str, List[dict]]) -> "COCOIndex":
        """Build a result index from detection records
        (pycocotools COCO.loadRes; reference patches it at coco_eval.py:240-302)."""
        if isinstance(results, str):
            with open(results) as f:
                results = json.load(f)
        res = {
            "images": list(self.dataset.get("images", [])),
            "categories": list(self.dataset.get("categories", [])),
            "annotations": [],
        }
        for i, det in enumerate(results):
            ann = dict(det)
            if "bbox" in ann:
                x, y, w, h = ann["bbox"]
                ann.setdefault("area", w * h)
            elif "segmentation" in ann:
                # segm results: area from the RLE runs, bbox from its extent
                # (pycocotools loadRes segm branch).
                from .masks import area as rle_area, to_bbox

                ann.setdefault("area", rle_area(ann["segmentation"]))
                ann.setdefault("bbox", [float(v) for v in to_bbox(ann["segmentation"])])
            elif "keypoints" in ann:
                # keypoint results: bbox/area from the keypoint extent
                # (pycocotools loadRes keypoints branch).
                kp = np.asarray(ann["keypoints"], np.float64)
                xs, ys = kp[0::3], kp[1::3]
                x0, x1, y0, y1 = xs.min(), xs.max(), ys.min(), ys.max()
                ann.setdefault("area", float((x1 - x0) * (y1 - y0)))
                ann.setdefault(
                    "bbox", [float(x0), float(y0), float(x1 - x0), float(y1 - y0)]
                )
                ann.setdefault(
                    "num_keypoints", int(np.count_nonzero(kp[2::3]))
                )
            ann.setdefault("iscrowd", 0)
            ann["id"] = i + 1
            res["annotations"].append(ann)
        return COCOIndex(res)


def _polygons_to_mask(segmentation, height: int, width: int) -> np.ndarray:
    """Rasterize any COCO segmentation payload (polygons, uncompressed RLE,
    compressed-string RLE) into a binary mask — replacement for pycocotools'
    ``frPyObjects``+``decode`` (reference coco_utils.py:25-45). Full codec in
    :mod:`.masks`."""
    from .masks import segmentation_to_mask

    return segmentation_to_mask(segmentation, height, width)


def _coco_target_to_arrays(
    anns: List[dict],
    height: int,
    width: int,
    return_masks: bool = False,
    return_keypoints: bool = False,
) -> Dict[str, np.ndarray]:
    """xywh→xyxy, clamp to image, drop crowd + degenerate boxes; optional
    polygon→mask and keypoint extraction
    (reference ConvertCocoPolysToMask, coco_utils.py:48-101)."""
    anns = [a for a in anns if a.get("iscrowd", 0) == 0]
    boxes = np.asarray([a["bbox"] for a in anns], np.float32).reshape(-1, 4)
    boxes[:, 2:] += boxes[:, :2]
    boxes[:, 0::2] = boxes[:, 0::2].clip(0, width)
    boxes[:, 1::2] = boxes[:, 1::2].clip(0, height)
    labels = np.asarray([a["category_id"] for a in anns], np.int64)
    keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
    boxes, labels = boxes[keep], labels[keep]
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    out = {
        "boxes": boxes,
        "labels": labels,
        "area": area,
        "iscrowd": np.zeros(len(boxes), np.int64),
    }
    kept_anns = [a for a, k in zip(anns, keep) if k]
    if return_masks:
        masks = [
            _polygons_to_mask(a.get("segmentation") or [], height, width)
            for a in kept_anns
        ]
        out["masks"] = (
            np.stack(masks) if masks else np.zeros((0, height, width), np.uint8)
        )
    if return_keypoints:
        kps = [a.get("keypoints") or [] for a in kept_anns]
        if any(kps):
            out["keypoints"] = np.asarray(kps, np.float32).reshape(
                len(kept_anns), -1, 3
            )
        else:
            out["keypoints"] = np.zeros((len(kept_anns), 0, 3), np.float32)
    return out


class CocoDetectionDataset:
    """COCO images + annotations → (image, target, image_id) samples."""

    def __init__(
        self,
        image_dir: str,
        annotation_file: Union[str, dict, COCOIndex],
        transforms: Optional[Transform] = None,
        filter_empty: bool = True,
        return_masks: bool = False,
        return_keypoints: bool = False,
    ):
        self.image_dir = image_dir
        self.coco = (
            annotation_file
            if isinstance(annotation_file, COCOIndex)
            else COCOIndex(annotation_file)
        )
        self.transforms = transforms or Compose([ToFloat()])
        self.return_masks = return_masks
        self.return_keypoints = return_keypoints
        ids = self.coco.getImgIds()
        if filter_empty:
            # Train-split filtering of empty/degenerate-only images
            # (reference coco_utils.py:104-141).
            ids = [
                i
                for i in ids
                if len(
                    _coco_target_to_arrays(
                        self.coco.imgToAnns.get(i, []),
                        self.coco.imgs[i]["height"],
                        self.coco.imgs[i]["width"],
                    )["boxes"]
                )
                > 0
            ]
        self.image_ids = ids

    def __len__(self) -> int:
        return len(self.image_ids)

    def get_height_and_width(self, idx: int):
        """(h, w) from the annotation index, without decoding the image —
        feeds the loader's orientation-grouped batching and
        convert_to_coco_api's image-IO-free path."""
        info = self.coco.imgs[self.image_ids[idx]]
        return info["height"], info["width"]

    def load_image(self, image_id) -> np.ndarray:
        import cv2

        info = self.coco.imgs[image_id]
        path = os.path.join(self.image_dir, info["file_name"])
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    def __getitem__(self, idx: int):
        return self.get_sample(idx)

    def get_sample(self, idx: int, rng: Optional[np.random.Generator] = None):
        """Load + transform one sample, with an optional per-sample RNG for
        deterministic augmentation (the DetectionLoader derives one from
        (seed, epoch, index)).

        Target-style pipelines (coco_transforms.Compose, ``target_style``
        attribute) receive the FULL target, so masks/keypoints stay
        geometrically consistent with the image — the reference's COCO path
        works this way (coco_utils.py:211-215). Box-style pipelines
        (:mod:`.transforms`) only see boxes; masks/keypoints are passed
        through untransformed, which is only valid with geometry-free
        transforms — combine return_masks/return_keypoints with a
        target-style pipeline when using flips/crops.
        """
        image_id = self.image_ids[idx]
        info = self.coco.imgs[image_id]
        image = self.load_image(image_id)
        t = _coco_target_to_arrays(
            self.coco.imgToAnns.get(image_id, []),
            info["height"],
            info["width"],
            return_masks=self.return_masks,
            return_keypoints=self.return_keypoints,
        )
        if getattr(self.transforms, "target_style", False):
            image, t = self.transforms(image, t, rng=rng)
            boxes = np.asarray(t["boxes"], np.float32).reshape(-1, 4)
            labels = np.asarray(t["labels"], np.int64)
        else:
            image, boxes, labels = apply_transform(
                self.transforms, image, t["boxes"], t["labels"], rng
            )
        area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        target = {
            "boxes": boxes,
            "labels": labels,
            "image_id": np.asarray([image_id]),
            "area": area,
            "iscrowd": np.zeros(len(boxes), np.int64),
        }
        for extra in ("masks", "keypoints"):
            if extra in t:
                target[extra] = t[extra]
        return image, target, image_id


def get_coco(
    root: str,
    image_set: str = "train",
    transforms: Optional[Transform] = None,
) -> CocoDetectionDataset:
    """Wire the standard train2017/val2017 COCO layout
    (reference get_coco, coco_utils.py:220-251)."""
    anno = os.path.join(root, "annotations", f"instances_{image_set}2017.json")
    images = os.path.join(root, f"{image_set}2017")
    return CocoDetectionDataset(
        images, anno, transforms, filter_empty=image_set == "train"
    )


def convert_to_coco_api(dataset) -> COCOIndex:
    """In-memory COCO GT from any (image, target, image_id) dataset
    (reference convert_to_coco_api, coco_utils.py:144-192).

    Iterates targets WITHOUT decoding images when the dataset exposes
    ``get_target`` + ``get_height_and_width`` (PascalDataset does — its CSV
    carries width/height); falls back to full iteration otherwise.
    """
    images, annotations, cat_ids = [], [], set()
    ann_id = 1
    fast = hasattr(dataset, "get_target") and hasattr(dataset, "get_height_and_width")
    for idx in range(len(dataset)):
        hw = dataset.get_height_and_width(idx) if fast else None
        if hw is not None:
            target = dataset.get_target(idx)
            image_id = idx
            h, w = hw
        else:
            image, target, image_id = dataset[idx]
            h, w = image.shape[:2]
        images.append({"id": image_id, "height": h, "width": w})
        boxes = np.asarray(target["boxes"], np.float32)
        labels = np.asarray(target["labels"], np.int64)
        areas = np.asarray(target.get("area", np.zeros(len(boxes))), np.float32)
        crowds = np.asarray(target.get("iscrowd", np.zeros(len(boxes))), np.int64)
        for b, l, a, c in zip(boxes, labels, areas, crowds):
            cat_ids.add(int(l))
            annotations.append(
                {
                    "id": ann_id,
                    "image_id": image_id,
                    "category_id": int(l),
                    "bbox": [
                        float(b[0]),
                        float(b[1]),
                        float(b[2] - b[0]),
                        float(b[3] - b[1]),
                    ],
                    "area": float(a) if a > 0 else float((b[2] - b[0]) * (b[3] - b[1])),
                    "iscrowd": int(c),
                }
            )
            ann_id += 1
    return COCOIndex(
        {
            "images": images,
            "annotations": annotations,
            "categories": [{"id": c, "name": str(c)} for c in sorted(cat_ids)],
        }
    )


def get_coco_api_from_dataset(dataset) -> COCOIndex:
    """Reference get_coco_api_from_dataset (coco_utils.py:195-203): reuse the
    dataset's own index when it has one, else convert."""
    if isinstance(dataset, CocoDetectionDataset):
        return dataset.coco
    return convert_to_coco_api(dataset)
