"""Pascal-VOC XML and CSV dataset ingestion.

The port's copy of ``pytorch_retinanet_tpu/data/pascal.py``.

Rebuild of the reference's pascal pipeline (``utils/pascal/pascal_utils.py``):
scrape VOC-style XML annotations into a DataFrame, label-encode class names
with +1 so 0 stays background (pascal_utils.py:14, 62-64), persist per-split
CSVs (``get_pascal``, pascal_utils.py:145-151), and serve samples with cv2
BGR→RGB image loading and per-filename box grouping
(``PascalDataset.__getitem__``, pascal_utils.py:109-142).

The CSV schema matches the reference: columns
``filename, width, height, class, xmin, ymin, xmax, ymax, labels``.
"""

from __future__ import annotations

import logging
import os
import xml.etree.ElementTree as ET
from glob import glob
from typing import List, Optional, Tuple, Union

import numpy as np
import pandas as pd

from .transforms import Compose, ToFloat, Transform, apply_transform

logger = logging.getLogger(__name__)

_LABEL_CLASSES: Optional[np.ndarray] = None  # fit on train, reused for val/test
                                             # (reference module-global encoder,
                                             # pascal_utils.py:14)


def _encode_labels(names: pd.Series, fit: bool) -> np.ndarray:
    """Deterministic label encoding: sorted class names → 1..K (0 = background)."""
    global _LABEL_CLASSES
    if fit or _LABEL_CLASSES is None:
        _LABEL_CLASSES = np.asarray(sorted(names.unique()))
    lut = {c: i + 1 for i, c in enumerate(_LABEL_CLASSES)}
    return names.map(lut).to_numpy(dtype=np.int64)


def convert_annotations_to_df(
    annotation_dir: str, image_dir: str, fit_labels: bool = True
) -> pd.DataFrame:
    """Scrape a directory of VOC XML files into the reference CSV schema
    (reference pascal_utils.py:17-65)."""
    rows = []
    for xml_path in sorted(glob(os.path.join(annotation_dir, "*.xml"))):
        root = ET.parse(xml_path).getroot()
        fname = root.findtext("filename")
        size = root.find("size")
        width = int(size.findtext("width"))
        height = int(size.findtext("height"))
        for obj in root.iter("object"):
            bb = obj.find("bndbox")
            rows.append(
                {
                    "filename": os.path.join(image_dir, fname),
                    "width": width,
                    "height": height,
                    "class": obj.findtext("name"),
                    "xmin": float(bb.findtext("xmin")),
                    "ymin": float(bb.findtext("ymin")),
                    "xmax": float(bb.findtext("xmax")),
                    "ymax": float(bb.findtext("ymax")),
                }
            )
    df = pd.DataFrame(rows)
    if len(df):
        df["labels"] = _encode_labels(df["class"], fit=fit_labels)
    return df


def generate_pascal_category_names(df: pd.DataFrame) -> List[str]:
    """Label-id → name list with ``__background__`` at index 0
    (reference pascal_transforms.py:21-41)."""
    pairs = sorted(set(zip(df["labels"], df["class"])))
    names = ["__background__"] * (max(p[0] for p in pairs) + 1)
    for label, name in pairs:
        names[label] = name
    return names


class PascalDataset:
    """Detection dataset over a CSV/DataFrame in the reference schema
    (reference pascal_utils.py:68-142).

    ``__getitem__`` returns ``(image HWC float32 [0,1] RGB, target dict,
    image_id)`` where target = {"boxes" [N,4] xyxy, "labels" [N]} plus the
    bookkeeping fields the reference emits ("image_id", "area", "iscrowd").
    """

    def __init__(
        self,
        data: Union[str, pd.DataFrame],
        transforms: Optional[Transform] = None,
    ):
        df = pd.read_csv(data) if isinstance(data, str) else data
        # Bare datasets still emit float [0,1] (the reference's compose always
        # appends ToFloat, pascal_transforms.py:12-13).
        self.transforms = transforms or Compose([ToFloat()])
        self.filenames: List[str] = sorted(df["filename"].unique())
        self._by_file = {
            f: g[["xmin", "ymin", "xmax", "ymax", "labels"]].to_numpy()
            for f, g in df.groupby("filename")
        }
        self._sizes = (
            {f: (int(g["height"].iloc[0]), int(g["width"].iloc[0]))
             for f, g in df.groupby("filename")}
            if {"height", "width"} <= set(df.columns)
            else {}
        )

    def __len__(self) -> int:
        return len(self.filenames)

    def load_image(self, idx: int) -> np.ndarray:
        import cv2

        path = self.filenames[idx]
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    def get_height_and_width(self, idx: int):
        """(h, w) from CSV metadata, without decoding the image — lets
        convert_to_coco_api build the GT index image-IO-free."""
        return self._sizes.get(self.filenames[idx])

    def get_target(self, idx: int):
        """Untransformed target dict, without decoding the image."""
        ann = self._by_file[self.filenames[idx]]
        boxes = ann[:, :4].astype(np.float32)
        area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        return {
            "boxes": boxes,
            "labels": ann[:, 4].astype(np.int64),
            "image_id": np.asarray([idx]),
            "area": area,
            "iscrowd": np.zeros(len(boxes), np.int64),
        }

    def __getitem__(self, idx: int):
        return self.get_sample(idx)

    def get_sample(self, idx: int, rng: Optional[np.random.Generator] = None):
        """Load + transform one sample; ``rng`` makes augmentation
        deterministic per (seed, epoch, index) — see DetectionLoader."""
        image = self.load_image(idx)
        ann = self._by_file[self.filenames[idx]]
        boxes = ann[:, :4].astype(np.float32)
        labels = ann[:, 4].astype(np.int64)
        image, boxes, labels = apply_transform(
            self.transforms, image, boxes, labels, rng
        )
        area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        target = {
            "boxes": boxes,
            "labels": labels,
            "image_id": np.asarray([idx]),
            "area": area,
            "iscrowd": np.zeros(len(boxes), np.int64),
        }
        return image, target, idx


def get_pascal(
    annotation_dir: str,
    image_dir: str,
    split: str,
    transforms: Optional[Transform] = None,
    csv_dir: Optional[str] = None,
) -> Tuple[PascalDataset, pd.DataFrame]:
    """Convert + persist ``pascal_{split}.csv`` then build the dataset
    (reference pascal_utils.py:145-151)."""
    df = convert_annotations_to_df(annotation_dir, image_dir, fit_labels=split == "train")
    out_dir = csv_dir or os.path.dirname(os.path.abspath(annotation_dir))
    csv_path = os.path.join(out_dir, f"pascal_{split}.csv")
    df.to_csv(csv_path, index=False)
    logger.info("persisted %s (%d boxes, %d images)", csv_path, len(df),
                df["filename"].nunique() if len(df) else 0)
    return PascalDataset(df, transforms), df
