"""Anchor matching and loss targets: the CUDA kernel (``csrc/match.cu``) and its plain version.

Replaces ``pytorch_retinanet_tpu/kernels/match_pallas.py::match_targets``:
for one pyramid level, the IoU of every anchor against the image's padded GT
rows, the match with its ignore band (``-1`` background below ``bg_iou_thr``,
``-2`` ignore, the GT index strictly above ``fg_iou_thr``, first index on
ties, all-ignore for an image without GT), the matched label and the
encoded regression targets. The kernel scans, per block of 256 anchors,
only the GT rows that overlap the block's bounding box; ``csrc/match.cu``
says how it is laid out and why that cull is exact. Nothing here has a
gradient: the outputs are targets.

:func:`match_targets` is the wrapper: for CPU tensors it computes the plain
version, for CUDA tensors it launches the kernel (and counts the launch in
``match_targets.launches``) or raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from ..config import BBOX_REG_WEIGHTS, IOU_THRESHOLDS_BACKGROUND, IOU_THRESHOLDS_FOREGROUND
from ..ops.boxes import encode_boxes
from ..ops.matcher import match_anchors_batch

Tensor = torch.Tensor


def match_targets_plain(
    anchors: Tensor,
    gt_boxes: Tensor,
    gt_labels: Tensor,
    gt_valid: Tensor,
    fg_iou_thr: float = IOU_THRESHOLDS_FOREGROUND,
    bg_iou_thr: float = IOU_THRESHOLDS_BACKGROUND,
    reg_weights: Sequence[float] = tuple(BBOX_REG_WEIGHTS),
) -> Tuple[Tensor, Tensor, Tensor]:
    """The matcher, the matched-GT lookup and the encode as plain tensor ops.

    The port of the ``use_match_kernel=False`` composition in
    ``pytorch_retinanet_tpu/ops/losses.py::_loss_sums``; the matched row is
    read with ``torch.gather`` (row 0 where the anchor is not foreground),
    an exact selection like the JAX one-hot product. It forms [B, N, A]
    intermediates. Returns (matches [B, A] int32, fg_labels [B, A] int32,
    reg_targets [B, A, 4] f32).
    """
    gt_boxes = gt_boxes.float()
    matches = match_anchors_batch(anchors, gt_boxes, gt_valid, fg_iou_thr, bg_iou_thr).matches
    fg = matches >= 0
    safe_idx = matches.clamp(min=0).long()
    matched = torch.gather(gt_boxes, 1, safe_idx[..., None].expand(-1, -1, 4))
    labels = torch.gather(gt_labels.long(), 1, safe_idx)
    reg_targets = encode_boxes(matched, anchors[None].float(), reg_weights)
    fg_labels = torch.where(fg, labels, torch.zeros_like(labels)).to(torch.int32)
    return matches, fg_labels, reg_targets


def _aligned(t: Tensor) -> Tensor:
    """Contiguous, and 16-byte aligned for the kernel's float4 reads."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def match_targets(
    anchors: Tensor,
    gt_boxes: Tensor,
    gt_labels: Tensor,
    gt_valid: Tensor,
    fg_iou_thr: float = IOU_THRESHOLDS_FOREGROUND,
    bg_iou_thr: float = IOU_THRESHOLDS_BACKGROUND,
    reg_weights: Sequence[float] = tuple(BBOX_REG_WEIGHTS),
) -> Tuple[Tensor, Tensor, Tensor]:
    """Match + loss targets for one anchor set (pyramid level).

    Args:
      anchors: [A, 4] f32 XYXY, shared by the batch.
      gt_boxes: [B, N, 4] f32 XYXY, padded; N >= 1.
      gt_labels: [B, N] int labels (1-based; 0 is background).
      gt_valid: [B, N] bool mask of real GT rows.

    Returns:
      (matches [B, A] int32 with -1 background / -2 ignore,
       fg_labels [B, A] int32: the matched label on foreground anchors, else 0,
       reg_targets [B, A, 4] f32: the encode of the matched row, of row 0 on
       anchors that are not foreground).
    """
    if anchors.dim() != 2 or anchors.shape[-1] != 4 or gt_boxes.dim() != 3 or gt_boxes.shape[-1] != 4:
        raise ValueError(f"expected anchors [A, 4] and gt_boxes [B, N, 4], got "
                         f"{tuple(anchors.shape)} and {tuple(gt_boxes.shape)}")
    if gt_labels.shape != gt_boxes.shape[:2] or gt_valid.shape != gt_boxes.shape[:2]:
        raise ValueError(f"gt_labels {tuple(gt_labels.shape)} and gt_valid "
                         f"{tuple(gt_valid.shape)} must be [B, N] = {tuple(gt_boxes.shape[:2])}")
    if gt_boxes.shape[1] == 0:
        raise ValueError("match_targets needs at least one (padded) GT row")
    tensors = (anchors, gt_boxes, gt_labels, gt_valid)
    if all(t.device.type == "cpu" for t in tensors):
        return match_targets_plain(*tensors, fg_iou_thr, bg_iou_thr, reg_weights)
    if anchors.device.type != "cuda" or any(t.device != anchors.device for t in tensors):
        raise ValueError("match_targets: every input must lie on the same device, got "
                         f"{[str(t.device) for t in tensors]}")
    if anchors.dtype != torch.float32 or gt_boxes.dtype != torch.float32:
        raise TypeError(f"match_targets takes f32 boxes, got {anchors.dtype} and {gt_boxes.dtype}")
    b, n = gt_labels.shape
    a = anchors.shape[0]
    dev = anchors.device
    matches = torch.empty((b, a), dtype=torch.int32, device=dev)
    fg_labels = torch.empty((b, a), dtype=torch.int32, device=dev)
    reg = torch.empty((b, a, 4), dtype=torch.float32, device=dev)
    if b == 0 or a == 0:
        return matches, fg_labels, reg
    from .build import bind

    fn = bind("match", "match_targets", [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
              + [ctypes.c_float] * 6 + [ctypes.c_void_p])
    anchors, gt_boxes = _aligned(anchors), _aligned(gt_boxes)
    labels = gt_labels.to(torch.int32).contiguous()
    valid = gt_valid.to(torch.bool).contiguous()
    w0, w1, w2, w3 = (float(w) for w in reg_weights)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(anchors.data_ptr(), gt_boxes.data_ptr(), labels.data_ptr(), valid.data_ptr(),
                 matches.data_ptr(), fg_labels.data_ptr(), reg.data_ptr(), b, a, n,
                 float(fg_iou_thr), float(bg_iou_thr), w0, w1, w2, w3, stream)
    if err != 0:
        raise RuntimeError(f"match kernel launch failed with CUDA error {err}")
    match_targets.launches += 1
    return matches, fg_labels, reg


match_targets.launches = 0
