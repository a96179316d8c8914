"""COCO RLE mask codec: the port's copy of ``pytorch_retinanet_tpu/data/masks.py``.

The reference leans on pycocotools' C extension for RLE encode/decode and
mask IoU (reference coco_utils.py:25-45 ``convert_coco_poly_to_mask`` via
``frPyObjects``/``decode``; coco_eval.py:95-123 segm result encoding). This
module provides the same surface, dependency-free:

* run expansion/encoding and mask IoU run in C++ (:mod:`..native`, which
  raises where its library cannot be built);
* the COCO *compressed string* format (the ``counts: str`` produced by
  pycocotools) is implemented here: column-major runs, delta-coded against
  the run two positions back, serialized in 5-bit groups with a continuation
  bit, offset into printable ASCII by 48.

An RLE here is a dict ``{"size": [h, w], "counts": str | list[int]}`` —
exactly the JSON shapes COCO annotations carry.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Union

import numpy as np

from ..native import mask_iou, rle_decode_runs, rle_encode_mask

RLE = Dict[str, Any]


# --------------------------------------------------------------------------- #
# Compressed-string codec
# --------------------------------------------------------------------------- #
def string_to_runs(s: Union[str, bytes]) -> np.ndarray:
    """COCO compressed counts string → run lengths (uint32)."""
    if isinstance(s, bytes):
        s = s.decode("ascii")
    runs: List[int] = []
    i = 0
    n = len(s)
    while i < n:
        value = 0
        shift = 0
        while True:
            chunk = ord(s[i]) - 48
            i += 1
            value |= (chunk & 0x1F) << shift
            shift += 5
            if not (chunk & 0x20):
                # sign-extend the highest data bit of the last chunk
                if chunk & 0x10:
                    value |= -1 << shift
                break
        if len(runs) > 2:
            value += runs[-2]  # delta against the run two back
        runs.append(value)
    return np.asarray(runs, np.uint32)


def runs_to_string(runs: Sequence[int]) -> str:
    """Run lengths → COCO compressed counts string."""
    out: List[str] = []
    runs = list(int(r) for r in runs)
    for i, r in enumerate(runs):
        x = r - runs[i - 2] if i > 2 else r
        while True:
            chunk = x & 0x1F
            x >>= 5
            more = (x != -1) if (chunk & 0x10) else (x != 0)
            if more:
                chunk |= 0x20
            out.append(chr(chunk + 48))
            if not more:
                break
    return "".join(out)


# --------------------------------------------------------------------------- #
# Encode / decode
# --------------------------------------------------------------------------- #
def decode(rle: RLE) -> np.ndarray:
    """RLE dict (compressed string or uncompressed list counts) → [h, w] u8."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        runs = string_to_runs(counts)
    else:
        runs = np.asarray(counts, np.uint32)
    return rle_decode_runs(runs, int(h), int(w))


def encode(mask: np.ndarray) -> RLE:
    """[h, w] binary mask → compressed RLE dict (pycocotools encode parity)."""
    mask = np.asarray(mask)
    h, w = mask.shape
    runs = rle_encode_mask(mask)
    return {"size": [int(h), int(w)], "counts": runs_to_string(runs)}


def area(rle: RLE) -> int:
    """Foreground pixel count straight from the runs (no decode)."""
    counts = rle["counts"]
    runs = (
        string_to_runs(counts)
        if isinstance(counts, (str, bytes))
        else np.asarray(counts, np.uint64)
    )
    return int(runs[1::2].sum())


def to_bbox(rle: RLE) -> np.ndarray:
    """Tight xywh bbox of an RLE's foreground (pycocotools toBbox parity)."""
    m = decode(rle)
    ys, xs = np.nonzero(m)
    if len(ys) == 0:
        return np.zeros(4, np.float64)
    return np.asarray(
        [xs.min(), ys.min(), xs.max() - xs.min() + 1, ys.max() - ys.min() + 1],
        np.float64,
    )


def polygons_to_mask(polygons: Sequence[Sequence[float]], h: int, w: int) -> np.ndarray:
    """Rasterize COCO polygon lists into a binary mask (cv2.fillPoly — the
    same even-odd fill pycocotools' frPyObjects implements)."""
    import cv2

    mask = np.zeros((h, w), np.uint8)
    for poly in polygons:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        if len(pts) >= 3:
            cv2.fillPoly(mask, [np.round(pts).astype(np.int32)], 1)
    return mask


def segmentation_to_mask(segmentation, h: int, w: int) -> np.ndarray:
    """Any COCO ``segmentation`` payload → [h, w] u8 mask.

    Handles all three JSON shapes: polygon list-of-lists, uncompressed RLE
    (``counts: list``) and compressed RLE (``counts: str`` — the shape the
    reference's pycocotools path decodes at coco_utils.py:25-45; crowd
    regions in real COCO use it, so silently returning empty would corrupt
    ``return_masks=True`` training data)."""
    if segmentation is None:
        return np.zeros((h, w), np.uint8)
    if isinstance(segmentation, dict):
        rle = dict(segmentation)
        rle.setdefault("size", [h, w])
        return decode(rle)
    return polygons_to_mask(segmentation, h, w)


def iou(dt: np.ndarray, gt: np.ndarray, iscrowd: Sequence[int]) -> np.ndarray:
    """Pairwise mask IoU with COCO crowd semantics (native-accelerated)."""
    return mask_iou(
        np.asarray(dt, np.uint8),
        np.asarray(gt, np.uint8),
        np.asarray(iscrowd, np.int32),
    )
