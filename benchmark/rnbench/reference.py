"""The plain reference: RetinaNet in f32 PyTorch, written from the
published description and the reference repository's semantics.

It imports nothing of the program. It takes the weights as a
``state_dict`` in the reference detector's schema (the trunk family's
``backbone.backbone.*``, ``fpn.conv_c{3..7}_*``,
``retinanet_head.{classification,regression}_head.*``), the inputs as raw
uint8 images or batches, and works out again everything the program
derives from them: the cv2 resize, the padded bucket, the anchors, the
matched targets, the losses, the detections. The trunk is its family's
(``benchmark/families/<family>.py``, found by the configuration's
``backbone_kind``); normalize, FPN, head, anchors, loss and postprocess are
shared here.

Every convolution and matmul goes through :func:`conv` or the family's own
use of the quantizer: the control (the same reference with its convolution
inputs and weights rounded to fp8 e4m3; in training also each convolution's
output, and that output's gradient to e5m2) passes one. Batch norm, where a
trunk has it, is frozen: the running statistics with the affine
parameters, which train.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor
Quant = Optional[Callable[[Tensor], Tensor]]

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
ANCHOR_SIZES = [[x, x * 2 ** (1 / 3), x * 2 ** (2 / 3)] for x in (32, 64, 128, 256, 512)]
ANCHOR_RATIOS = (0.5, 1.0, 2.0)
STRIDES = (8, 16, 32, 64, 128)
BN_EPS = 1e-5
FG_IOU, BG_IOU = 0.5, 0.4
FOCAL_ALPHA, FOCAL_GAMMA, SMOOTH_L1_BETA = 0.25, 2.0, 0.1
SIZE_LOG_CLIP = 6.0
MAX_COORDINATE = 4096.0  # class offset of the batched NMS: class * (this + 1)


@contextlib.contextmanager
def f32_exact():
    """TF32 off for matmuls and cuDNN: the reference computes in f32."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _fp8_round(x: Tensor, dtype: torch.dtype, top: float) -> Tensor:
    """`x` rounded to `dtype` with one per-tensor scale that maps its
    largest magnitude to `top`, back in `x`'s dtype."""
    scale = top / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _E5M2Grad(torch.autograd.Function):
    """The identity forward; backward, the incoming gradient rounded to
    float8 e5m2 (per-tensor scale), as fp8 training feeds a convolution's
    output gradient to its data- and weight-gradient products."""

    @staticmethod
    def forward(ctx, y: Tensor) -> Tensor:
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g: Tensor) -> Tensor:
        return _fp8_round(g, torch.float8_e5m2, 57344.0)


def fp8_quant(x: Tensor) -> Tensor:
    """Round to float8 e4m3 with one per-tensor scale, back in f32: the
    precision below bf16 that the control computes its convolutions in.
    The gradient passes straight through the rounding, in f32."""
    with torch.no_grad():
        rounded = _fp8_round(x, torch.float8_e4m3fn, 448.0)
    return x + (rounded - x).detach()


def fp8_train_quant(x: Tensor) -> Tensor:
    """:func:`fp8_quant` for the training control, which holds in fp8 what
    the program holds in bf16: :func:`conv` also rounds its output to e4m3
    (``.out``) and that output's gradient to e5m2 (``.grad``), as fp8
    training's hybrid recipe feeds the data- and weight-gradient products."""
    return fp8_quant(x)


fp8_train_quant.out = fp8_quant
fp8_train_quant.grad = _E5M2Grad.apply


# --------------------------------------------------------------------------- #
# Schema
# --------------------------------------------------------------------------- #
def schema(fam, m: Dict, num_anchors: int = 9) -> List[Tuple[str, tuple, str]]:
    """Every key of the detector's ``state_dict`` with its shape and role:
    the trunk family's keys and roles, then ``fpn`` / ``head`` /
    ``cls_out`` / ``box_out`` (conv weights) and ``bias``. The FPN takes
    its in-channels from the family."""
    out = list(fam.schema(m))
    c3, c4, c5 = fam.out_channels(m)
    for name, ci, k in (("c3_1x1", c3, 1), ("c3_3x3", 256, 3), ("c4_1x1", c4, 1),
                        ("c4_3x3", 256, 3), ("c5_1x1", c5, 1), ("c5_3x3", 256, 3),
                        ("c6_3x3", c5, 3), ("c7_3x3", 256, 3)):
        out.append((f"fpn.conv_{name}.weight", (256, ci, k, k), "fpn"))
        out.append((f"fpn.conv_{name}.bias", (256,), "bias"))
    num_classes = m["num_classes"]
    for head, sub, n_out, role in (("classification_head", "class_subnet", num_anchors * num_classes,
                                    "cls_out"),
                                   ("regression_head", "box_subnet", num_anchors * 4, "box_out")):
        p = f"retinanet_head.{head}"
        for i in (0, 2, 4, 6):
            out.append((f"{p}.{sub}.{i}.weight", (256, 256, 3, 3), "head"))
            out.append((f"{p}.{sub}.{i}.bias", (256,), "bias"))
        out.append((f"{p}.{sub}_output.weight", (n_out, 256, 3, 3), "head"))
        out.append((f"{p}.{sub}_output.bias", (n_out,), role))
    return out


# --------------------------------------------------------------------------- #
# Forward
# --------------------------------------------------------------------------- #
def conv(x: Tensor, w: Tensor, b: Optional[Tensor] = None, stride: int = 1, q: Quant = None) -> Tensor:
    if q is not None:
        x, w = q(x), q(w)
    y = F.conv2d(x, w, b, stride, (w.shape[-1] - 1) // 2)
    for step in (getattr(q, "out", None), getattr(q, "grad", None)):
        if step is not None:
            y = step(y)
    return y


def frozen_bn(x: Tensor, sd: Dict[str, Tensor], p: str, relu: bool) -> Tensor:
    scale = sd[p + ".weight"] / torch.sqrt(sd[p + ".running_var"] + BN_EPS)
    y = (x - sd[p + ".running_mean"][None, :, None, None]) * scale[None, :, None, None] \
        + sd[p + ".bias"][None, :, None, None]
    return torch.relu(y) if relu else y


def upsample_to(x: Tensor, hw) -> Tensor:
    """Nearest upsample: output row i reads input row i // ceil(H_out / H_in)."""
    rh, rw = -(-hw[0] // x.shape[2]), -(-hw[1] // x.shape[3])
    return x.repeat_interleave(rh, 2).repeat_interleave(rw, 3)[:, :, :hw[0], :hw[1]]


def fpn(sd: Dict[str, Tensor], c3: Tensor, c4: Tensor, c5: Tensor, q: Quant = None) -> List[Tensor]:
    def c(name, x, stride=1):
        return conv(x, sd[f"fpn.conv_{name}.weight"], sd[f"fpn.conv_{name}.bias"], stride, q)

    m5 = c("c5_1x1", c5)
    m4 = c("c4_1x1", c4) + upsample_to(m5, c4.shape[2:])
    m3 = c("c3_1x1", c3) + upsample_to(m4, c3.shape[2:])
    p6 = c("c6_3x3", c5, 2)
    return [c("c3_3x3", m3), c("c4_3x3", m4), c("c5_3x3", m5), p6, c("c7_3x3", torch.relu(p6), 2)]


def head(sd: Dict[str, Tensor], pyramid: List[Tensor], num_classes: int, q: Quant = None):
    """Per level [N, H*W*A, C] logits and [N, H*W*A, 4] deltas (rows: y, x, anchor)."""
    cls_out, box_out = [], []
    for level in pyramid:
        for head_name, sub, width, dest in (("classification_head", "class_subnet", num_classes, cls_out),
                                            ("regression_head", "box_subnet", 4, box_out)):
            p = f"retinanet_head.{head_name}.{sub}"
            x = level
            for i in (0, 2, 4, 6):
                x = torch.relu(conv(x, sd[f"{p}.{i}.weight"], sd[f"{p}.{i}.bias"], q=q))
            x = conv(x, sd[f"{p}_output.weight"], sd[f"{p}_output.bias"], q=q)
            n = x.shape[0]
            dest.append(x.permute(0, 2, 3, 1).reshape(n, -1, width))
    return cls_out, box_out


def normalize(images_u8: Tensor) -> Tensor:
    """uint8 NHWC -> normalized f32 NCHW."""
    mean = torch.tensor(MEAN, device=images_u8.device)
    std = torch.tensor(STD, device=images_u8.device)
    return ((images_u8.float() / 255.0 - mean) / std).permute(0, 3, 1, 2).contiguous()


def detector(sd: Dict[str, Tensor], images_u8: Tensor, fam, m: Dict, q: Quant = None):
    """uint8 NHWC padded batch -> per-level (logits, deltas), f32, through
    the trunk family `fam` (``benchmark/families/``)."""
    c3, c4, c5 = fam.trunk(sd, normalize(images_u8), m, q)
    return head(sd, fpn(sd, c3, c4, c5, q), m["num_classes"], q)


# --------------------------------------------------------------------------- #
# Anchors and boxes
# --------------------------------------------------------------------------- #
def anchors_per_level(bucket: Tuple[int, int]) -> List[np.ndarray]:
    h, w = bucket
    out = []
    for stride, sizes in zip(STRIDES, ANCHOR_SIZES):
        cells = []
        for size in sizes:
            for ar in ANCHOR_RATIOS:
                aw = math.sqrt(size * size / ar)
                ah = ar * aw
                cells.append([-aw / 2, -ah / 2, aw / 2, ah / 2])
        cells = np.asarray(cells, np.float32)
        gh, gw = math.ceil(h / stride), math.ceil(w / stride)
        sx, sy = np.meshgrid(np.arange(gw, dtype=np.float32) * stride,
                             np.arange(gh, dtype=np.float32) * stride)
        shifts = np.stack([sx, sy, sx, sy], -1).reshape(-1, 1, 4)
        out.append((shifts + cells[None]).reshape(-1, 4).astype(np.float32))
    return out


def decode(deltas: Tensor, anchors: Tensor) -> Tensor:
    aw, ah = anchors[..., 2] - anchors[..., 0], anchors[..., 3] - anchors[..., 1]
    ax, ay = anchors[..., 0] + 0.5 * aw, anchors[..., 1] + 0.5 * ah
    cx, cy = deltas[..., 0] * aw + ax, deltas[..., 1] * ah + ay
    w = aw * torch.exp(deltas[..., 2].clamp(-SIZE_LOG_CLIP, SIZE_LOG_CLIP))
    h = ah * torch.exp(deltas[..., 3].clamp(-SIZE_LOG_CLIP, SIZE_LOG_CLIP))
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], -1)


def encode(gt: Tensor, anchors: Tensor) -> Tensor:
    aw, ah = anchors[..., 2] - anchors[..., 0], anchors[..., 3] - anchors[..., 1]
    ax, ay = anchors[..., 0] + 0.5 * aw, anchors[..., 1] + 0.5 * ah
    gw, gh = gt[..., 2] - gt[..., 0], gt[..., 3] - gt[..., 1]
    gx, gy = gt[..., 0] + 0.5 * gw, gt[..., 1] + 0.5 * gh
    return torch.stack([(gx - ax) / aw, (gy - ay) / ah, torch.log(gw / aw + 1e-8),
                        torch.log(gh / ah + 1e-8)], -1)


def iou(a: Tensor, b: Tensor) -> Tensor:
    """[..., N, 4] x [..., M, 4] -> [..., N, M]."""
    lo = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    hi = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    inter = (hi - lo).clamp(min=0).prod(-1)
    area_a = (a[..., 2:] - a[..., :2]).clamp(min=0).prod(-1)
    area_b = (b[..., 2:] - b[..., :2]).clamp(min=0).prod(-1)
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter).clamp(min=1e-12)


# --------------------------------------------------------------------------- #
# Resize (cv2.resize INTER_LINEAR on uint8, fixed point) and buckets
# --------------------------------------------------------------------------- #
def ceil32(v: int) -> int:
    return int(math.ceil(v / 32.0) * 32)


def resize_plan(h: int, w: int, min_size: int, max_size: int):
    """((new_h, new_w), (pad_h, pad_w)) of the reference resize rule."""
    scale = min(min_size / min(h, w), max_size / max(h, w))
    nh, nw = int(round(h * scale)), int(round(w * scale))
    ph, pw = (ceil32(max_size), ceil32(min_size)) if h >= w else (ceil32(min_size), ceil32(max_size))
    return (nh, nw), (max(ph, nh), max(pw, nw))


def _taps(src: int, dst: int, zero_outside: bool):
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5).astype(np.float32)
    first = np.floor(f).astype(np.int64)
    f = f - first.astype(np.float32)
    if zero_outside:
        f = np.where((first < 0) | (first >= src - 1), np.float32(0), f)
    w0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int64)
    w1 = np.rint(f * np.float32(2048)).astype(np.int64)
    return np.clip(first, 0, src - 1), np.clip(first + 1, 0, src - 1), w0, w1


def resize_u8(image: Tensor, nh: int, nw: int) -> Tensor:
    """cv2.resize(INTER_LINEAR) of an HWC uint8 tensor: 11-bit weights, an
    exact horizontal pass, then cv2's vertical rounding."""
    h, w = image.shape[:2]
    if (h, w) == (nh, nw):
        return image
    dev = image.device
    x0, x1, a0, a1 = (torch.from_numpy(t).to(dev) for t in _taps(w, nw, True))
    y0, y1, b0, b1 = (torch.from_numpy(t).to(dev) for t in _taps(h, nh, False))
    src = image.long()
    rows = src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]
    v = ((rows[y0] >> 4) * b0[:, None, None] >> 16) + ((rows[y1] >> 4) * b1[:, None, None] >> 16)
    return ((v + 2) >> 2).clamp(0, 255).to(torch.uint8)


def padded_batch(images: Sequence[np.ndarray], min_size: int, max_size: int, device):
    """Raw uint8 HWC images of one bucket -> (uint8 [N, H, W, 3] batch,
    [(new_h, new_w)], [(orig_h, orig_w)])."""
    plans = [resize_plan(im.shape[0], im.shape[1], min_size, max_size) for im in images]
    pad = plans[0][1]
    if any(p[1] != pad for p in plans):
        raise ValueError("padded_batch takes images of one bucket")
    batch = torch.zeros((len(images), pad[0], pad[1], 3), dtype=torch.uint8, device=device)
    for i, (im, ((nh, nw), _)) in enumerate(zip(images, plans)):
        batch[i, :nh, :nw] = resize_u8(torch.from_numpy(np.ascontiguousarray(im)).to(device), nh, nw)
    return batch, [p[0] for p in plans], [im.shape[:2] for im in images]


# --------------------------------------------------------------------------- #
# Postprocess
# --------------------------------------------------------------------------- #
def _top(x: Tensor, k: int):
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def greedy_nms(boxes: Tensor, valid: Tensor, thr: float) -> np.ndarray:
    """Sequential greedy NMS over score-descending [K, 4] candidates: a
    valid candidate is kept unless a kept earlier one overlaps it by IoU > thr."""
    over = (iou(boxes, boxes) > thr).cpu().numpy()
    valid = valid.cpu().numpy()
    keep = np.zeros(len(valid), bool)
    removed = np.zeros(len(valid), bool)
    for i in range(len(valid)):
        if valid[i] and not removed[i]:
            keep[i] = True
            removed |= over[i]
    return keep


def postprocess(cls_levels, box_levels, anchors_levels, size_hw, *, pre_nms_top_k: int = 1000,
                score_thres: float = 0.05, nms_thres: float = 0.5, max_detections: int = 100,
                fault: Optional[str] = None) -> Dict:
    """One image's per-level [A_l, C] logits and [A_l, 4] deltas -> the
    detections in resized coordinates, sorted by score. Per level the top
    anchors by their best class, then the top (anchor, class) pairs among
    them; a cross-level top-k; sigmoid, clip, threshold; class-wise greedy
    NMS; the best `max_detections`.

    Returns ``boxes`` [D, 4], ``scores`` [D], ``labels`` [D] (1..C),
    ``logits`` [D], ``anchors`` [D] (index over the levels' anchors in
    order), and the selection's cuts, the logit of the last one each stage
    keeps (-inf where it keeps everything): ``anchor_cut`` and ``pair_cut``
    per level, ``cross_cut``. `fault` plants an error in the NMS for the
    control: ``keep_all``, ``one_per_class``, ``empty``, or ``lowest_k``
    (the cross-level stage keeps its lowest candidates)."""
    num_classes = cls_levels[0].shape[-1]
    scores, boxes, classes, anchor_ids = [], [], [], []
    anchor_cut, pair_cut = [], []
    offset = 0
    for cls_l, box_l, anc in zip(cls_levels, box_levels, anchors_levels):
        best = cls_l.amax(-1)
        best_v, a_idx = _top(best, min(pre_nms_top_k, cls_l.shape[0]))
        anchor_cut.append(float(best_v[-1]) if len(best_v) < len(best) else -math.inf)
        flat = cls_l[a_idx].reshape(-1)
        s, idx = _top(flat, min(pre_nms_top_k, flat.shape[0]))
        pair_cut.append(float(s[-1]) if len(s) < len(flat) else -math.inf)
        anchor = a_idx[idx // num_classes]
        scores.append(s)
        boxes.append(decode(box_l[anchor], anc[anchor]))
        classes.append(idx % num_classes)
        anchor_ids.append(anchor + offset)
        offset += cls_l.shape[0]
    every = torch.cat(scores)
    logits, top_idx = _top(every, min(pre_nms_top_k, len(every)))
    cross_cut = float(logits[-1]) if len(logits) < len(every) else -math.inf
    if fault == "lowest_k":  # the cross-level stage keeps the lowest candidates
        low = torch.sort(every, stable=True).indices[:len(logits)]
        logits, order = _top(every[low], len(low))
        top_idx = low[order]
    score = torch.sigmoid(logits)
    box = clip(torch.cat(boxes)[top_idx], size_hw)
    cls = torch.cat(classes)[top_idx]
    wh = box[:, 2:] - box[:, :2]
    valid = (score > score_thres) & (wh >= 1e-2).all(-1)
    if fault == "keep_all":
        keep = valid.cpu().numpy()
    elif fault == "one_per_class":
        keep = np.zeros(len(valid), bool)
        seen = set()
        for i, (v, c) in enumerate(zip(valid.tolist(), cls.tolist())):
            if v and c not in seen:
                keep[i] = True
                seen.add(c)
    else:
        keep = greedy_nms(box + (cls.float() * (MAX_COORDINATE + 1))[:, None], valid, nms_thres)
    kept = torch.nonzero(torch.from_numpy(keep).to(score.device)).flatten()[:max_detections]
    if fault == "empty":
        kept = kept[:0]
    # `kept` is already score-descending.
    return {"boxes": box[kept], "scores": score[kept], "labels": cls[kept] + 1,
            "logits": logits[kept], "anchors": torch.cat(anchor_ids)[top_idx][kept],
            "anchor_cut": anchor_cut, "pair_cut": pair_cut, "cross_cut": cross_cut}


def clip(boxes: Tensor, size_hw) -> Tensor:
    h, w = float(size_hw[0]), float(size_hw[1])
    return torch.stack([boxes[:, 0].clamp(0, w), boxes[:, 1].clamp(0, h),
                        boxes[:, 2].clamp(0, w), boxes[:, 3].clamp(0, h)], -1)


# --------------------------------------------------------------------------- #
# Loss
# --------------------------------------------------------------------------- #
def image_loss(cls: Tensor, box: Tensor, anchors: Tensor, gt_boxes: Tensor, gt_labels: Tensor,
               num_classes: int) -> Tensor:
    """One image's focal + smooth-L1 loss over all anchors ([A, C], [A, 4],
    [A, 4]) against its valid GT rows ([n, 4], [n] in 1..C), each summed and
    divided by max(foreground anchors, 1)."""
    if len(gt_boxes) == 0:
        return cls.sum() * 0.0 + box.sum() * 0.0  # every anchor ignored
    with torch.no_grad():
        overlaps = iou(gt_boxes, anchors)  # [n, A]
        best, best_idx = overlaps.max(0)  # first row among equal maxima
        fg = best > FG_IOU
        considered = fg | (best < BG_IOU)
        target = torch.zeros_like(cls)
        target[fg, gt_labels[best_idx[fg]].long() - 1] = 1.0
        reg_target = encode(gt_boxes[best_idx], anchors)
    p = torch.sigmoid(cls)
    bce = F.binary_cross_entropy_with_logits(cls, target, reduction="none")
    p_t = p * target + (1 - p) * (1 - target)
    alpha_t = FOCAL_ALPHA * target + (1 - FOCAL_ALPHA) * (1 - target)
    focal = (alpha_t * (1 - p_t) ** FOCAL_GAMMA * bce).sum(-1)
    diff = (box - reg_target).abs()
    sl1 = torch.where(diff < SMOOTH_L1_BETA, 0.5 * diff * diff / SMOOTH_L1_BETA,
                      diff - 0.5 * SMOOTH_L1_BETA).sum(-1)
    norm = fg.sum().clamp(min=1).float()
    return (focal * considered).sum() / norm + (sl1 * fg).sum() / norm
