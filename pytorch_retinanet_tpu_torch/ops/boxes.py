"""Box math on tensors, the counterpart of ``pytorch_retinanet_tpu/ops/boxes.py``.

Boxes are ``[..., 4]`` float tensors in XYXY (x1, y1, x2, y2). Every function
is elementwise over leading batch dimensions and does its arithmetic in the
same order as the JAX module, so the two agree to the last bit wherever the
operations are correctly rounded (``exp`` is the one that is not).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

Tensor = torch.Tensor

# Epsilon inside the size log of the encoder (reference box_utils.py:32).
_ENCODE_EPS = 1e-8


def xyxy_to_cxcywh(boxes: Tensor) -> Tensor:
    lo, hi = boxes[..., :2], boxes[..., 2:]
    return torch.cat([(lo + hi) * 0.5, hi - lo], dim=-1)


def cxcywh_to_xyxy(boxes: Tensor) -> Tensor:
    c, s = boxes[..., :2], boxes[..., 2:]
    half = s * 0.5
    return torch.cat([c - half, c + half], dim=-1)


def encode_boxes(
    boxes: Tensor, anchors: Tensor, weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0)
) -> Tensor:
    """GT boxes -> regression targets on `anchors`."""
    b, a = xyxy_to_cxcywh(boxes), xyxy_to_cxcywh(anchors)
    t_centers = (b[..., :2] - a[..., :2]) / a[..., 2:]
    t_sizes = torch.log(b[..., 2:] / a[..., 2:] + _ENCODE_EPS)
    w = torch.as_tensor(weights, dtype=boxes.dtype, device=boxes.device)
    return torch.cat([t_centers, t_sizes], dim=-1) * w


def decode_boxes(
    deltas: Tensor,
    anchors: Tensor,
    weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
    clip_size_log: float = 6.0,
) -> Tensor:
    """Regression activations -> XYXY boxes; size logs clipped to ±`clip_size_log`."""
    a = xyxy_to_cxcywh(anchors)
    w = torch.as_tensor(weights, dtype=deltas.dtype, device=deltas.device)
    d = deltas / w
    centers = a[..., 2:] * d[..., :2] + a[..., :2]
    size_log = torch.clamp(d[..., 2:], -clip_size_log, clip_size_log)
    sizes = a[..., 2:] * torch.exp(size_log)
    return cxcywh_to_xyxy(torch.cat([centers, sizes], dim=-1))


def box_area(boxes: Tensor) -> Tensor:
    """Area of XYXY boxes, clamped at zero for degenerate corners."""
    wh = torch.clamp(boxes[..., 2:] - boxes[..., :2], min=0.0)
    return wh[..., 0] * wh[..., 1]


def box_iou(boxes_a: Tensor, boxes_b: Tensor) -> Tensor:
    """Pairwise IoU: [..., N, 4] x [..., M, 4] -> [..., N, M]."""
    lo = torch.maximum(boxes_a[..., :, None, :2], boxes_b[..., None, :, :2])
    hi = torch.minimum(boxes_a[..., :, None, 2:], boxes_b[..., None, :, 2:])
    wh = torch.clamp(hi - lo, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(boxes_a)[..., :, None] + box_area(boxes_b)[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-12)


def clip_boxes(boxes: Tensor, image_size: Union[Tuple[int, int], Tensor]) -> Tensor:
    """Clamp XYXY boxes into [0, W] x [0, H].

    `image_size` is (height, width): a tuple for one size, or a ``[..., 2]``
    tensor of per-image sizes that broadcasts against the box dimension.
    """
    if isinstance(image_size, (tuple, list)):
        h = torch.tensor(float(image_size[0]), dtype=boxes.dtype, device=boxes.device)
        w = torch.tensor(float(image_size[1]), dtype=boxes.dtype, device=boxes.device)
    else:
        image_size = image_size.to(boxes.dtype)
        h, w = image_size[..., 0:1], image_size[..., 1:2]
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x = torch.minimum(torch.maximum(boxes[..., 0::2], zero), w[..., None])
    y = torch.minimum(torch.maximum(boxes[..., 1::2], zero), h[..., None])
    return torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], dim=-1)


def small_box_mask(boxes: Tensor, min_size: float = 1e-2) -> Tensor:
    """True where both sides are >= `min_size`."""
    wh = boxes[..., 2:] - boxes[..., :2]
    return torch.all(wh >= min_size, dim=-1)


def rescale_boxes(boxes: Tensor, from_size: Tensor, to_size: Tensor) -> Tensor:
    """Rescale XYXY boxes from one (height, width) image size to another."""
    from_size = from_size.to(boxes.dtype)
    to_size = to_size.to(boxes.dtype)
    scale_y = to_size[..., 0] / from_size[..., 0]
    scale_x = to_size[..., 1] / from_size[..., 1]
    scale = torch.stack([scale_x, scale_y, scale_x, scale_y], dim=-1)
    return boxes * scale
