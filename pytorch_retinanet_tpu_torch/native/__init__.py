"""Native (C++) host-side detection ops, loaded with ctypes.

Counterpart of ``pytorch_retinanet_tpu/native``, with its own copy of the
C++ source (``src/detection_native.cc``): box IoU, greedy NMS, the COCO
evaluator's IoU and greedy matcher, and the RLE mask codec and mask IoU.

The library is built with ``g++`` at first use into ``build/`` at the root
of the checkout (``build/libdetection_native-<hash>.so``; the hash covers
the source and the flags), never next to the source. Where it cannot be
built, every entry point raises with the compiler's message: there is no
silent fallback. The numpy version of each function stands beside it as
``<name>_plain``; the tests hold the two equal.

The flags keep the floating-point results equal to the plain versions':
no ``-march=native`` and no contraction into FMA.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..kernels.build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "src" / "detection_native.cc"
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the library lands for the current source and flags."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libdetection_native-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built already; raises with the
    compiler's output where that fails. A per-process temporary name is
    renamed into place, so a concurrent process never loads half a file."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native detection library builds with g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE.name} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(str(build()))
                _bind(lib)
                _lib = lib
    return _lib


def _bind(lib: ctypes.CDLL) -> None:
    """Declare every entry point's argument and result types."""
    c_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    c_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    c_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    c_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    c_u32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    c_int = ctypes.c_int
    signatures = {
        "box_iou_xyxy": ([c_f32, c_int, c_f32, c_int, c_f32], None),
        "nms_xyxy": ([c_f32, c_int, ctypes.c_float, c_u8], None),
        "coco_iou_xywh": ([c_f64, c_int, c_f64, c_int, c_i32, c_f64], None),
        "coco_match": ([c_f64, c_int, c_int, c_f64, c_i32, c_f64, c_int, c_i32, c_i32, c_u8],
                       None),
        "rle_decode_runs": ([c_u32, c_int, c_int, c_int, c_u8], None),
        "rle_encode_mask": ([c_u8, c_int, c_int, c_u32], c_int),
        "mask_iou": ([c_u8, c_int, c_u8, c_int, c_i32, ctypes.c_long, c_f64], None),
    }
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype


# --------------------------------------------------------------------------- #
# Box IoU and NMS
# --------------------------------------------------------------------------- #
def _iou_one_to_many(box: np.ndarray, others: np.ndarray) -> np.ndarray:
    """IoU of one XYXY box with each of `others`, in f32 as the C++ computes it."""
    if len(others) == 0:
        return np.zeros(0, np.float32)
    lo = np.maximum(box[:2], others[:, :2])
    hi = np.minimum(box[2:], others[:, 2:])
    wh = np.maximum(hi - lo, np.float32(0))
    inter = wh[:, 0] * wh[:, 1]
    area = max(box[2] - box[0], np.float32(0)) * max(box[3] - box[1], np.float32(0))
    areas = (np.maximum(others[:, 2] - others[:, 0], np.float32(0))
             * np.maximum(others[:, 3] - others[:, 1], np.float32(0)))
    union = area + areas - inter
    safe = np.where(union > 0, union, np.float32(1))
    return np.where(union > 0, inter / safe, np.float32(0)).astype(np.float32)


def box_iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU [len(a), len(b)] of XYXY boxes (0 where the union is 0)."""
    a = np.ascontiguousarray(a, np.float32).reshape(-1, 4)
    b = np.ascontiguousarray(b, np.float32).reshape(-1, 4)
    out = np.zeros((len(a), len(b)), np.float32)
    get_lib().box_iou_xyxy(a, len(a), b, len(b), out)
    return out


def box_iou_xyxy_plain(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a, np.float32).reshape(-1, 4)
    b = np.ascontiguousarray(b, np.float32).reshape(-1, 4)
    if not len(a):
        return np.zeros((0, len(b)), np.float32)
    return np.stack([_iou_one_to_many(x, b) for x in a])


def nms_xyxy(boxes: np.ndarray, iou_thr: float) -> np.ndarray:
    """Greedy NMS keep mask over score-descending XYXY boxes: a box is
    suppressed by a kept earlier one whose IoU with it is > `iou_thr`."""
    boxes = np.ascontiguousarray(boxes, np.float32).reshape(-1, 4)
    keep = np.zeros(len(boxes), np.uint8)
    get_lib().nms_xyxy(boxes, len(boxes), float(iou_thr), keep)
    return keep.astype(bool)


def nms_xyxy_plain(boxes: np.ndarray, iou_thr: float) -> np.ndarray:
    boxes = np.ascontiguousarray(boxes, np.float32).reshape(-1, 4)
    thr = np.float32(iou_thr)
    keep = np.ones(len(boxes), bool)
    for i in range(len(boxes)):
        if keep[i]:
            keep[i + 1:] &= ~(_iou_one_to_many(boxes[i], boxes[i + 1:]) > thr)
    return keep


# --------------------------------------------------------------------------- #
# The COCO evaluator's IoU and greedy matcher
# --------------------------------------------------------------------------- #
def coco_iou_xywh(dt: np.ndarray, gt: np.ndarray, crowd: np.ndarray) -> np.ndarray:
    """Pairwise IoU [D, G] of xywh boxes in f64; a crowd GT divides by the
    detection's area (pycocotools ``maskUtils.iou`` for bbox)."""
    dt = np.ascontiguousarray(dt, np.float64).reshape(-1, 4)
    gt = np.ascontiguousarray(gt, np.float64).reshape(-1, 4)
    crowd = np.ascontiguousarray(crowd, np.int32).reshape(-1)
    out = np.zeros((len(dt), len(gt)), np.float64)
    if len(dt) and len(gt):
        get_lib().coco_iou_xywh(dt, len(dt), gt, len(gt), crowd, out)
    return out


def coco_iou_xywh_plain(dt: np.ndarray, gt: np.ndarray, crowd: np.ndarray) -> np.ndarray:
    dt = np.asarray(dt, np.float64).reshape(-1, 4)
    gt = np.asarray(gt, np.float64).reshape(-1, 4)
    crowd = np.asarray(crowd, np.int32).reshape(-1)
    if not len(dt) or not len(gt):
        return np.zeros((len(dt), len(gt)), np.float64)
    dx1, dy1 = dt[:, 0:1], dt[:, 1:2]
    dx2, dy2 = dx1 + dt[:, 2:3], dy1 + dt[:, 3:4]
    gx1, gy1 = gt[None, :, 0], gt[None, :, 1]
    gx2, gy2 = gx1 + gt[None, :, 2], gy1 + gt[None, :, 3]
    iw = np.minimum(dx2, gx2) - np.maximum(dx1, gx1)
    ih = np.minimum(dy2, gy2) - np.maximum(dy1, gy1)
    inter = np.maximum(iw, 0.0) * np.maximum(ih, 0.0)
    darea = dt[:, 2:3] * dt[:, 3:4]
    garea = gt[None, :, 2] * gt[None, :, 3]
    union = np.where(crowd[None, :] != 0, darea, darea + garea - inter)
    safe = np.where(union > 0, union, 1.0)
    return np.where(union > 0, inter / safe, 0.0)


def coco_match(ious: np.ndarray, gt_ig: np.ndarray, crowd: np.ndarray,
               thrs: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The evaluator's greedy matcher over one (image, category, area range)
    cell, as pycocotools' ``evaluateImg`` runs it.

    `ious` is [D, G] with detections score-descending and GT sorted
    non-ignored first; `gt_ig` and `crowd` are per GT, `thrs` the IoU
    thresholds. Returns (dtm [T, D], gtm [T, G], dt_ig [T, D]): 1-based
    matched indices (0 = unmatched) and the detections matched to ignored GT.
    """
    ious = np.ascontiguousarray(ious, np.float64)
    D, G = ious.shape
    T = len(thrs)
    dtm = np.zeros((T, D), np.int32)
    gtm = np.zeros((T, G), np.int32)
    dt_ig = np.zeros((T, D), np.uint8)
    get_lib().coco_match(ious, D, G, np.ascontiguousarray(gt_ig, np.float64),
                         np.ascontiguousarray(crowd, np.int32),
                         np.ascontiguousarray(thrs, np.float64), T, dtm, gtm, dt_ig)
    return dtm, gtm, dt_ig


def coco_match_plain(ious: np.ndarray, gt_ig: np.ndarray, crowd: np.ndarray,
                     thrs: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    ious = np.asarray(ious, np.float64)
    D, G = ious.shape
    T = len(thrs)
    dtm = np.zeros((T, D), np.int32)
    gtm = np.zeros((T, G), np.int32)
    dt_ig = np.zeros((T, D), np.uint8)
    for t, thr in enumerate(thrs):
        for d in range(D):
            iou = min(float(thr), 1 - 1e-10)
            m = -1
            for g in range(G):
                if gtm[t, g] > 0 and not crowd[g]:
                    continue  # matched already, and not a crowd region
                if m > -1 and gt_ig[m] == 0 and gt_ig[g] == 1:
                    break  # a real match, and the ignored GT begin
                if ious[d, g] < iou:
                    continue
                iou = ious[d, g]
                m = g
            if m == -1:
                continue
            dt_ig[t, d] = gt_ig[m] != 0
            dtm[t, d] = m + 1
            gtm[t, m] = d + 1
    return dtm, gtm, dt_ig


# --------------------------------------------------------------------------- #
# RLE mask codec and mask IoU (COCO RLE is column-major, 0-runs first)
# --------------------------------------------------------------------------- #
def rle_decode_runs(counts: np.ndarray, h: int, w: int) -> np.ndarray:
    """Column-major COCO runs -> row-major [h, w] uint8 mask."""
    counts = np.ascontiguousarray(counts, np.uint32).reshape(-1)
    mask = np.zeros(h * w, np.uint8)
    get_lib().rle_decode_runs(counts, len(counts), h, w, mask)
    return mask.reshape(h, w)


def rle_decode_runs_plain(counts: np.ndarray, h: int, w: int) -> np.ndarray:
    counts = np.asarray(counts, np.uint32).reshape(-1)
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, counts.astype(np.int64))
    out = np.zeros(h * w, np.uint8)
    out[: len(flat)] = flat[: h * w]
    return out.reshape((w, h)).T.copy()


def rle_encode_mask(mask: np.ndarray) -> np.ndarray:
    """Row-major [h, w] binary mask -> column-major COCO runs (uint32)."""
    mask = np.ascontiguousarray(mask, np.uint8)
    h, w = mask.shape
    counts = np.zeros(h * w + 1, np.uint32)
    m = get_lib().rle_encode_mask(mask, h, w, counts)
    return counts[:m].copy()


def rle_encode_mask_plain(mask: np.ndarray) -> np.ndarray:
    flat = (np.asarray(mask) != 0).astype(np.uint8).T.reshape(-1)  # column-major
    changes = np.flatnonzero(np.diff(flat)) + 1
    bounds = np.concatenate([[0], changes, [flat.size]])
    runs = np.diff(bounds).astype(np.uint32)
    if flat.size and flat[0] == 1:  # runs start with a 0-run
        runs = np.concatenate([[np.uint32(0)], runs])
    return runs


def mask_iou(dt: np.ndarray, gt: np.ndarray, crowd: np.ndarray) -> np.ndarray:
    """Pairwise IoU [D, G] of binary masks; a crowd GT divides by the
    detection's area (pycocotools ``maskUtils.iou`` for segm)."""
    dt = np.ascontiguousarray(dt, np.uint8)
    gt = np.ascontiguousarray(gt, np.uint8)
    crowd = np.ascontiguousarray(crowd, np.int32).reshape(-1)
    D, G = dt.shape[0], gt.shape[0]
    out = np.zeros((D, G), np.float64)
    if D and G:
        hw = int(np.prod(dt.shape[1:]))
        get_lib().mask_iou(dt.reshape(D, hw), D, gt.reshape(G, hw), G, crowd, hw, out)
    return out


def mask_iou_plain(dt: np.ndarray, gt: np.ndarray, crowd: np.ndarray) -> np.ndarray:
    dt, gt = np.asarray(dt, np.uint8), np.asarray(gt, np.uint8)
    crowd = np.asarray(crowd, np.int32).reshape(-1)
    D, G = dt.shape[0], gt.shape[0]
    if not D or not G:
        return np.zeros((D, G), np.float64)
    d = dt.reshape(D, -1).astype(np.int64)
    g = gt.reshape(G, -1).astype(np.int64)
    inter = (d @ g.T).astype(np.float64)
    darea = d.sum(1, keepdims=True).astype(np.float64)
    garea = g.sum(1, keepdims=True).T.astype(np.float64)
    union = np.where(crowd[None, :] != 0, darea, darea + garea - inter)
    safe = np.where(union > 0, union, 1.0)
    return np.where(union > 0, inter / safe, 0.0)


__all__ = [
    "box_iou_xyxy", "box_iou_xyxy_plain", "build", "coco_iou_xywh", "coco_iou_xywh_plain",
    "coco_match", "coco_match_plain", "get_lib", "library_path", "mask_iou", "mask_iou_plain",
    "nms_xyxy", "nms_xyxy_plain", "rle_decode_runs", "rle_decode_runs_plain", "rle_encode_mask",
    "rle_encode_mask_plain",
]
