"""Fixed-shape detection postprocess, batched over images.

Counterpart of ``pytorch_retinanet_tpu/ops/nms.py`` in its exact selection
mode (``approx_top_k=False``): per level, the top anchors by class-max, then
the top (anchor, class) pairs among their gathered rows; a cross-level merge;
class-offset greedy NMS; top-``max_detections`` packing. Every step runs on
``[B, ...]`` tensors, with no loop over images.

Selection is a stable descending sort, so ties go to the lower index as in
``lax.top_k`` (``torch.topk`` orders ties differently). Types follow the JAX
path: the class-max is taken in the head's compute dtype and the gathered
rows are cast to f32.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..config import (
    BBOX_REG_WEIGHTS,
    MAX_DETECTIONS_PER_IMAGE,
    NMS_THRES,
    PRE_NMS_TOP_K,
    SCORE_THRES,
)
from ..kernels import nms as _kernel_nms
from .boxes import clip_boxes, decode_boxes, small_box_mask

Tensor = torch.Tensor


class Detections(NamedTuple):
    """Padded detections, ``[..., D]`` slots with a validity mask."""

    boxes: Tensor  # [..., D, 4] XYXY
    scores: Tensor  # [..., D]
    labels: Tensor  # [..., D] int32 in [1, num_classes]
    valid: Tensor  # [..., D] bool


def pack_detections(det: Detections) -> Tensor:
    """One ``[..., D, 6]`` f32 buffer (x1, y1, x2, y2, score, label); label 0 is an empty slot."""
    label = torch.where(det.valid, det.labels, 0).to(torch.float32)
    return torch.cat(
        [det.boxes.float(), det.scores.float()[..., None], label[..., None]], dim=-1
    )


def unpack_detections(packed) -> Detections:
    """Host-side inverse of :func:`pack_detections` (numpy out)."""
    if isinstance(packed, torch.Tensor):
        packed = packed.detach().cpu().numpy()
    packed = np.asarray(packed)
    labels = packed[..., 5].astype(np.int32)
    return Detections(
        boxes=packed[..., :4], scores=packed[..., 4], labels=labels, valid=labels > 0
    )


def top_k(x: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """Largest `k` along the last dim, ties to the lower index (``lax.top_k`` order)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def nms_keep_mask(
    boxes: Tensor,
    scores: Tensor,
    iou_threshold: float = NMS_THRES,
    valid: Tensor | None = None,
) -> Tensor:
    """Greedy keep mask over score-descending candidates, [K, 4] or [B, K, 4].

    ``scores`` only documents the ordering contract, as in the JAX function.
    Runs the NMS kernel for CUDA tensors and its plain version on the CPU.
    """
    del scores
    single = boxes.dim() == 2
    if valid is None:
        valid = torch.ones(boxes.shape[:-1], dtype=torch.bool, device=boxes.device)
    if single:
        boxes, valid = boxes[None], valid[None]
    keep = _kernel_nms.nms_keep_mask(boxes, valid, iou_threshold)
    return keep[0] if single else keep


def _gather_rows(x: Tensor, idx: Tensor) -> Tensor:
    """x [B, N, D], idx [B, M] -> [B, M, D]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def multilevel_candidates(
    cls_levels: Sequence[Tensor],
    box_levels: Sequence[Tensor],
    anchors_levels: Sequence[Tensor],
    *,
    pre_nms_top_k: int = PRE_NMS_TOP_K,
    reg_weights: Sequence[float] = tuple(BBOX_REG_WEIGHTS),
) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-level candidate selection and decode.

    Args are per level: logits [B, A_l, C], deltas [B, A_l, 4], anchors
    [A_l, 4]. Returns the concatenation over levels of ([B, K] f32 logits,
    [B, K, 4] boxes, [B, K] int32 class indices), each level's part
    descending.
    """
    num_classes = cls_levels[0].shape[-1]
    cand_scores, cand_boxes, cand_classes = [], [], []
    for cls_l, box_l, anc_l in zip(cls_levels, box_levels, anchors_levels):
        anc_l = torch.as_tensor(anc_l, device=cls_l.device)
        k_anchors = min(pre_nms_top_k, cls_l.shape[1])
        _, a_idx = top_k(torch.amax(cls_l, dim=-1), k_anchors)  # [B, k]
        rows = _gather_rows(cls_l, a_idx).float()  # [B, k, C]
        flat = rows.reshape(rows.shape[0], -1)
        s_l, idx_l = top_k(flat, min(pre_nms_top_k, flat.shape[1]))
        sel_anchor = torch.gather(a_idx, 1, idx_l // num_classes)
        c_idx = (idx_l % num_classes).to(torch.int32)
        b_l = decode_boxes(
            _gather_rows(box_l.float(), sel_anchor), anc_l[sel_anchor], reg_weights
        )
        cand_scores.append(s_l)
        cand_boxes.append(b_l)
        cand_classes.append(c_idx)
    return (
        torch.cat(cand_scores, dim=1),
        torch.cat(cand_boxes, dim=1),
        torch.cat(cand_classes, dim=1),
    )


def merge_candidates(
    scores_all: Tensor,
    boxes_all: Tensor,
    classes_all: Tensor,
    image_sizes: Tensor,
    *,
    pre_nms_top_k: int = PRE_NMS_TOP_K,
    score_thres: float = SCORE_THRES,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Cross-level merge: top-k, sigmoid, clip to each image's [B, 2] (h, w), validity."""
    k = min(pre_nms_top_k, scores_all.shape[1])
    top_logits, top_idx = top_k(scores_all, k)
    top_scores = torch.sigmoid(top_logits)
    boxes = clip_boxes(_gather_rows(boxes_all, top_idx), image_sizes)
    class_idx = torch.gather(classes_all, 1, top_idx)
    valid = (top_scores > score_thres) & small_box_mask(boxes)
    return boxes, top_scores, class_idx, valid


def _suppress_and_pack(
    boxes: Tensor,
    scores: Tensor,
    class_idx: Tensor,
    valid: Tensor,
    *,
    nms_thres: float,
    max_detections: int,
    max_coordinate: float,
) -> Detections:
    """Class-offset NMS over the [B, K] candidates, then top-k packing."""
    offsets = class_idx.to(torch.float32) * (max_coordinate + 1.0)
    keep = _kernel_nms.nms_keep_mask(boxes + offsets[..., None], valid, nms_thres)
    sel_scores = torch.where(keep, scores, -1.0)
    det_scores, det_idx = top_k(sel_scores, max_detections)
    det_valid = det_scores > 0.0
    det_boxes = torch.where(det_valid[..., None], _gather_rows(boxes, det_idx), 0.0)
    det_labels = torch.where(det_valid, torch.gather(class_idx, 1, det_idx) + 1, 0)
    det_scores = torch.clamp(det_scores, min=0.0)
    return Detections(det_boxes, det_scores, det_labels.to(torch.int32), det_valid)


def process_detections_multilevel_batch(
    cls_levels: Sequence[Tensor],
    box_levels: Sequence[Tensor],
    anchors_levels: Sequence[Tensor],
    image_sizes: Tensor,
    *,
    score_thres: float = SCORE_THRES,
    nms_thres: float = NMS_THRES,
    max_detections: int = MAX_DETECTIONS_PER_IMAGE,
    pre_nms_top_k: int = PRE_NMS_TOP_K,
    reg_weights: Sequence[float] = tuple(BBOX_REG_WEIGHTS),
    max_coordinate: float = 4096.0,
) -> Detections:
    """Batched multilevel postprocess: per-level [B, A_l, C] logits -> [B, D] detections.

    ``image_sizes`` is [B, 2] (height, width) of each resized, unpadded image.
    """
    scores_all, boxes_all, classes_all = multilevel_candidates(
        cls_levels, box_levels, anchors_levels,
        pre_nms_top_k=pre_nms_top_k, reg_weights=reg_weights,
    )
    boxes, scores, class_idx, valid = merge_candidates(
        scores_all, boxes_all, classes_all, image_sizes.to(boxes_all.device),
        pre_nms_top_k=pre_nms_top_k, score_thres=score_thres,
    )
    return _suppress_and_pack(
        boxes, scores, class_idx, valid,
        nms_thres=nms_thres, max_detections=max_detections,
        max_coordinate=max_coordinate,
    )


def process_detections_multilevel(
    cls_levels: Sequence[Tensor],
    box_levels: Sequence[Tensor],
    anchors_levels: Sequence[Tensor],
    image_size: Tensor,
    **kwargs,
) -> Detections:
    """One image: per-level [A_l, C] logits, (2,) size -> [D] detections."""
    det = process_detections_multilevel_batch(
        [c[None] for c in cls_levels], [b[None] for b in box_levels],
        anchors_levels, torch.as_tensor(image_size)[None], **kwargs,
    )
    return Detections(*(t[0] for t in det))
