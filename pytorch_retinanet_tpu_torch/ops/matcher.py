"""Anchor-to-ground-truth matching with an ignore band, batched.

Counterpart of ``pytorch_retinanet_tpu/ops/matcher.py``: for each anchor
the best IoU over the image's valid GT rows; below ``bg_iou_thr`` it is
background (-1), strictly above ``fg_iou_thr`` it is matched to that row
(the first row on ties), in between it is ignored (-2). Padded GT rows
never win (their IoU is forced to -1), and an image with no valid GT has
every anchor ignored and ``max_iou`` 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import IOU_THRESHOLDS_BACKGROUND, IOU_THRESHOLDS_FOREGROUND
from .boxes import box_iou

Tensor = torch.Tensor

BACKGROUND = -1
IGNORE = -2


class MatchResult(NamedTuple):
    """matches: [..., A] int32 GT index, BACKGROUND or IGNORE;
    max_iou: [..., A] f32 best IoU over the valid GT rows."""

    matches: Tensor
    max_iou: Tensor


def match_anchors_batch(
    anchors: Tensor,
    gt_boxes: Tensor,
    gt_valid: Tensor,
    fg_iou_thr: float = IOU_THRESHOLDS_FOREGROUND,
    bg_iou_thr: float = IOU_THRESHOLDS_BACKGROUND,
) -> MatchResult:
    """Match [A, 4] anchors, shared by the batch, against [B, N, 4] padded GT
    with its [B, N] validity mask. Forms the [B, N, A] IoU matrix."""
    gt_valid = gt_valid.bool()
    iou = box_iou(gt_boxes, anchors)  # [B, N, A]
    iou = torch.where(gt_valid[..., None], iou, torch.full_like(iou, -1.0))
    best_iou = iou.amax(dim=-2)
    best_idx = iou.argmax(dim=-2).to(torch.int32)  # first index among the maxima

    matches = torch.full_like(best_idx, IGNORE)
    matches = torch.where(best_iou < bg_iou_thr, torch.full_like(matches, BACKGROUND), matches)
    matches = torch.where(best_iou > fg_iou_thr, best_idx, matches)
    any_gt = gt_valid.any(dim=-1, keepdim=True)
    matches = torch.where(any_gt, matches, torch.full_like(matches, IGNORE))
    best_iou = torch.where(any_gt, best_iou.clamp(min=0.0), torch.zeros_like(best_iou))
    return MatchResult(matches=matches, max_iou=best_iou)


def match_anchors(
    anchors: Tensor,
    gt_boxes: Tensor,
    gt_valid: Tensor,
    fg_iou_thr: float = IOU_THRESHOLDS_FOREGROUND,
    bg_iou_thr: float = IOU_THRESHOLDS_BACKGROUND,
) -> MatchResult:
    """One image: [A, 4] anchors against [N, 4] padded GT and its [N] mask."""
    out = match_anchors_batch(anchors, gt_boxes[None], gt_valid[None], fg_iou_thr, bg_iou_thr)
    return MatchResult(out.matches[0], out.max_iou[0])
