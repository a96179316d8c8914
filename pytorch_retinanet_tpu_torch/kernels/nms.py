"""Greedy NMS keep mask: the CUDA kernel (``csrc/nms.cu``) and its plain version.

Replaces ``pytorch_retinanet_tpu/kernels/nms_pallas.py::pallas_nms_keep_mask``.
The kernel is bound by the latency of the serial greedy scan, not by bytes
or arithmetic; ``csrc/nms.cu`` says how its two passes are laid out.

:func:`nms_keep_mask` is the wrapper: for a CPU tensor it computes the plain
version, for a CUDA tensor it launches the kernel (and counts the launch in
``nms_keep_mask.launches``) or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.boxes import box_iou

Tensor = torch.Tensor


def nms_keep_mask_plain(boxes: Tensor, valid: Tensor, iou_thr: float) -> Tensor:
    """Greedy keep mask as a fixpoint over the [B, K, K] suppression matrix.

    ``keep[j] = valid[j] and no kept i < j has IoU(i, j) > iou_thr``, iterated
    from ``keep = valid``; it converges to sequential greedy NMS in at most K
    steps. The batched form of ``pytorch_retinanet_tpu/ops/nms.py::nms_keep_mask``.
    """
    k = boxes.shape[-2]
    idx = torch.arange(k, device=boxes.device)
    suppress = (box_iou(boxes, boxes) > iou_thr) & (idx[:, None] < idx[None, :])
    suppress = suppress & valid[..., :, None] & valid[..., None, :]
    keep = valid.clone()
    for _ in range(k):
        new_keep = valid & ~torch.any(suppress & keep[..., :, None], dim=-2)
        if torch.equal(new_keep, keep):
            break
        keep = new_keep
    return keep


def nms_keep_mask(boxes: Tensor, valid: Tensor, iou_thr: float) -> Tensor:
    """Greedy-NMS keep mask for score-descending candidates.

    Args:
      boxes: [B, K, 4] f32 XYXY, each row sorted by score descending.
      valid: [B, K] bool, the candidates to consider at all.
      iou_thr: strict ``>`` suppression threshold.

    Returns:
      [B, K] bool, equal to sequential greedy NMS on each image.
    """
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or valid.shape != boxes.shape[:2]:
        raise ValueError(f"expected boxes [B, K, 4] and valid [B, K], got "
                         f"{tuple(boxes.shape)} and {tuple(valid.shape)}")
    if boxes.device.type == "cpu":
        return nms_keep_mask_plain(boxes, valid, iou_thr)
    if boxes.device.type != "cuda" or valid.device != boxes.device:
        raise ValueError(f"nms_keep_mask: boxes on {boxes.device}, valid on {valid.device}")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"nms_keep_mask wants f32 boxes and bool valid, got {boxes.dtype}, {valid.dtype}")
    b, k = valid.shape
    if b == 0 or k == 0:
        return valid.clone()
    from .build import load

    lib = load("nms")
    fn = lib.nms_keep_mask
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    boxes = boxes.contiguous()
    valid = valid.contiguous()
    nwords = (k + 63) // 64
    mask = torch.empty((b, k, nwords), dtype=torch.int64, device=boxes.device)
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(boxes.data_ptr(), valid.data_ptr(), mask.data_ptr(), keep.data_ptr(),
                 b, k, float(iou_thr), stream)
    if err != 0:
        raise RuntimeError(f"nms kernel launch failed with CUDA error {err}")
    nms_keep_mask.launches += 1
    return keep


nms_keep_mask.launches = 0
