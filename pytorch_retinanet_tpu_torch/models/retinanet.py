"""RetinaNet: backbone -> FPN -> head, and the user-facing ``Retinanet``.

Counterpart of ``pytorch_retinanet_tpu/models/retinanet.py``:

* :class:`RetinaNetModule` takes a padded NHWC batch (f32 in [0, 1], or the
  uint8 wire format with /255 folded into the normalize constants) and
  returns per-level logits and deltas.
* :func:`apply_detector` is the inference forward: it runs the fused stem
  kernel when the shape and dtype allow it, and the module's own stem
  otherwise; ``use_fused_trunk=True`` (off by default, as in the JAX
  package) runs the trunk through the fused bottleneck kernel
  (``models/fused_backbone.py``).
* :class:`Retinanet` owns the weights and a device, resizes images on the
  device into the orientation buckets (uint8 images bit for bit as
  ``cv2.resize`` does, and kept uint8), and returns detections as numpy
  (``predict``) or the training losses (``forward``, through the module's
  own stem, as the JAX trainer does). Its weights are the reference
  detector's ``state_dict`` schema, so the JAX package's torch interop
  (``load_torch_backbone``, ``load_torch_state_dict``,
  ``to_torch_state_dict``, ``save_torch_state_dict``) are thin calls here.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import config as C
from ..config import ifnone
from ..data.loader import pad_targets
from ..kernels.stem import stem_forward, stem_supported
from ..ops import (
    Detections,
    generate_anchors,
    generate_anchors_per_level,
    num_anchors_per_location,
    process_detections_multilevel_batch,
    retinanet_loss,
)
from .backbone import RESNET_SPECS, BackBone, backbone_out_channels
from .converter import from_jax_variables
from .fpn import FeaturePyramid
from .fused_backbone import apply_trunk_fused, fused_trunk_applicable
from .head import RetinaNetHead
from .zoo import fetch_backbone_weights

Tensor = torch.Tensor

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# Reference checkpoint keys without learned state for the detector: its
# anchor constants, and an ImageNet classifier saved with the trunk.
_IGNORABLE_PREFIXES = ("anchor_generator.", "backbone.backbone.fc.", "fc.")


class RetinaNetModule(nn.Module):
    """Padded [N, H, W, 3] images -> per-level (logits, deltas).

    ``freeze_bn=False`` makes the backbone's batch norms live in training
    mode (``module.train()``); in eval mode they use the running statistics,
    as the JAX module does with ``train=False``.

    ``stem_s2d`` is accepted so that the JAX package's configs load, and
    changes nothing: JAX stores and trains the space-to-depth 4x4 kernel,
    while the port stores the 7x7 one (the converter folds an s2d kernel
    into it), and both forms compute the same conv, so the 7x7 conv (or the
    fused stem kernel) serves either way.
    """

    def __init__(
        self,
        backbone_kind: str = "resnet50",
        num_classes: int = C.NUM_CLASSES,
        freeze_bn: bool = C.FREEZE_BN,
        prior: float = C.PRIOR,
        channels: int = 256,
        mean: Sequence[float] = tuple(C.MEAN),
        std: Sequence[float] = tuple(C.STD),
        dtype: torch.dtype = torch.bfloat16,
        remat: bool = False,
        stem_s2d: bool = False,
    ):
        super().__init__()
        self.backbone_kind = backbone_kind
        self.num_classes = num_classes
        self.prior = prior
        self.mean = tuple(mean)
        self.std = tuple(std)
        self.dtype = dtype
        self.backbone = BackBone(backbone_kind, freeze_bn=freeze_bn, remat=remat)
        self.fpn = FeaturePyramid(*backbone_out_channels(backbone_kind), channels=channels)
        self.retinanet_head = RetinaNetHead(num_classes, num_anchors_per_location(), channels)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.backbone.backbone.reset_parameters(generator)
        self.fpn.reset_parameters(generator)
        self.retinanet_head.reset_parameters(generator, self.prior)

    def normalize(self, images: Tensor) -> Tensor:
        """(x - mean) / std in f32 on NHWC; uint8 folds /255 into the constants."""
        mean = torch.tensor(self.mean, dtype=torch.float32, device=images.device)
        std = torch.tensor(self.std, dtype=torch.float32, device=images.device)
        if images.dtype == torch.uint8:
            mean, std = mean * 255.0, std * 255.0
        return (images.float() - mean) / std

    def forward(
        self,
        images: Tensor,
        return_levels: bool = False,
        stem_in: Optional[Tensor] = None,
        feats_in: Optional[Dict[str, Tensor]] = None,
    ):
        """`stem_in`, when given, is the fused stem's NHWC output on the
        already normalized images; `feats_in`, when given, is the trunk's
        {"c3", "c4", "c5"} (the fused trunk's) and the backbone is skipped.
        Either way `images` is not read."""
        if feats_in is not None:
            feats = {k: v.to(self.dtype) for k, v in feats_in.items()}
        elif stem_in is None:
            x = self.normalize(images).permute(0, 3, 1, 2).to(self.dtype)
            feats = self.backbone(x)
        else:
            feats = self.backbone(None, stem_in.permute(0, 3, 1, 2).to(self.dtype))
        return self.retinanet_head(self.fpn(feats), return_levels)


def fused_stem_applicable(module: RetinaNetModule, image_shape: Sequence[int]) -> bool:
    """The fused stem serves the bf16 module on the shapes the kernel takes."""
    return module.dtype == torch.bfloat16 and stem_supported(image_shape)


def stem_constants(module: RetinaNetModule, dtype: torch.dtype):
    """The fused stem's (mean, std) for images of `dtype`: the module's, and
    for the uint8 wire format with /255 folded in (in double, then f32 in the
    kernel, as the JAX gate folds them)."""
    if dtype == torch.uint8:
        return tuple(m * 255.0 for m in module.mean), tuple(s * 255.0 for s in module.std)
    return module.mean, module.std


def apply_detector(
    module: RetinaNetModule,
    images: Tensor,
    *,
    return_levels: bool = False,
    use_fused_stem: Optional[bool] = None,
    use_fused_trunk: bool = False,
):
    """Inference forward, through the fused stem kernel where it applies.

    The fused stem normalizes inside the kernel, from f32 images or from the
    uint8 wire format; the module path normalizes in its own pass.

    ``use_fused_trunk=True`` also runs the trunk through the fused
    bottleneck kernel, as the JAX gate does: only in the fused-stem branch
    and only for bottleneck ResNets (``fused_trunk_applicable``).
    """
    if use_fused_stem is None:
        use_fused_stem = fused_stem_applicable(module, images.shape)
    if not use_fused_stem:
        return module(images, return_levels)
    resnet = module.backbone.backbone
    scale, shift = resnet.bn1.folded()
    stem = stem_forward(images, *stem_constants(module, images.dtype), resnet.conv1.weight,
                        scale, shift)
    if use_fused_trunk and fused_trunk_applicable(module.backbone_kind):
        feats = apply_trunk_fused(resnet, stem, module.backbone_kind)
        return module(images, return_levels, feats_in=feats)
    return module(images, return_levels, stem_in=stem)


def _ceil32(v: int) -> int:
    return int(math.ceil(v / 32.0) * 32)


def resolution_buckets(min_size: int, max_size: int) -> Tuple[Tuple[int, int], ...]:
    """The padded shapes: landscape and portrait (one square when min == max)."""
    lo, hi = _ceil32(min_size), _ceil32(max_size)
    if lo == hi:
        return ((lo, hi),)
    return ((lo, hi), (hi, lo))


def _resize_plan(orig_h: int, orig_w: int, min_size: int, max_size: int):
    scale = min(min_size / min(orig_h, orig_w), max_size / max(orig_h, orig_w))
    new_h, new_w = int(round(orig_h * scale)), int(round(orig_w * scale))
    if orig_h >= orig_w:
        pad_h, pad_w = _ceil32(max_size), _ceil32(min_size)
    else:
        pad_h, pad_w = _ceil32(min_size), _ceil32(max_size)
    return (new_h, new_w), (max(pad_h, new_h), max(pad_w, new_w))


_COEF_SCALE = 2048  # cv2's INTER_RESIZE_COEF_SCALE: 11 fractional bits


def _cv2_linear_taps(src: int, dst: int, clamp_weight: bool):
    """cv2's fixed-point ``INTER_LINEAR`` taps along one axis: first and
    second source index and their int16 weights, per destination index.

    The source offset is computed in double and rounded to f32, its weights
    are f32 and rounded half to even, as cv2 computes them. cv2 zeroes the
    fraction where the first tap leaves the source only along x; along y it
    clamps the row indices and keeps the weights.
    """
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    first = np.floor(f).astype(np.int64)
    f = f - first.astype(np.float32)
    if clamp_weight:
        f = np.where((first < 0) | (first >= src - 1), np.float32(0), f)
    i0 = np.clip(first, 0, src - 1)
    i1 = np.clip(first + 1, 0, src - 1)
    w0 = np.rint((np.float32(1) - f) * np.float32(_COEF_SCALE)).astype(np.int32)
    w1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int32)
    return i0, i1, w0, w1


def _resize_uint8_like_cv2(image: Tensor, new_h: int, new_w: int) -> Tensor:
    """``cv2.resize(image, (new_w, new_h), interpolation=cv2.INTER_LINEAR)``
    for an HWC uint8 tensor, bit for bit, in int32 on the image's device.

    The horizontal pass sums exactly; the vertical one is cv2's vectorised
    rounding, ``((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1 >> 16) + 2 >> 2``.
    """
    h, w = int(image.shape[0]), int(image.shape[1])
    dev = image.device

    def taps(src, dst, clamp_weight):
        return [torch.from_numpy(t).to(dev) for t in _cv2_linear_taps(src, dst, clamp_weight)]

    x0, x1, a0, a1 = taps(w, new_w, True)
    y0, y1, b0, b1 = taps(h, new_h, False)
    rows = image.to(torch.int32)
    hrow = rows[:, x0] * a0[None, :, None] + rows[:, x1] * a1[None, :, None]  # [h, new_w, C]
    s0 = ((hrow[y0] >> 4) * b0[:, None, None]) >> 16
    s1 = ((hrow[y1] >> 4) * b1[:, None, None]) >> 16
    return ((s0 + s1 + 2) >> 2).clamp_(0, 255).to(torch.uint8)


def resize_for_bucket(
    image: Tensor, min_size: int, max_size: int, *, wire_dtype: torch.dtype = torch.float32
) -> Tuple[Tensor, Tuple[int, int], Tuple[int, int], Tuple[int, int]]:
    """The reference resize rule on the device, without the bucket pad.

    `image` is HWC, uint8 or float in [0, 1]. A uint8 image is resized as
    ``cv2.resize(INTER_LINEAR)`` resizes it, to the same uint8 values; a
    float one bilinearly with half-pixel centres and no antialias, as cv2
    does in float. `wire_dtype` is the dtype returned: ``torch.float32``
    (uint8 values scaled by 1/255) or ``torch.uint8`` (float values scaled
    by 255, clipped and truncated). Returns (resized HWC array in
    `wire_dtype`, resized (h, w), original (h, w), bucket (pad_h, pad_w)).
    """
    if wire_dtype not in (torch.float32, torch.uint8):
        raise ValueError(f"wire_dtype must be torch.float32 or torch.uint8, got {wire_dtype}")
    orig_h, orig_w = int(image.shape[0]), int(image.shape[1])
    (new_h, new_w), pad = _resize_plan(orig_h, orig_w, min_size, max_size)
    same = (new_h, new_w) == (orig_h, orig_w)
    if image.dtype == torch.uint8:
        x = image if same else _resize_uint8_like_cv2(image, new_h, new_w)
        if wire_dtype == torch.float32:
            x = x.float() / 255.0
        return x, (new_h, new_w), (orig_h, orig_w), pad
    x = image.float()
    if not same:
        x = F.interpolate(
            x.permute(2, 0, 1)[None], size=(new_h, new_w), mode="bilinear",
            align_corners=False, antialias=False,
        )[0].permute(1, 2, 0)
    if wire_dtype == torch.uint8:
        x = (x * 255.0).clamp_(0, 255).to(torch.uint8)
    return x, (new_h, new_w), (orig_h, orig_w), pad


def resize_to_bucket(
    image: Tensor, min_size: int, max_size: int, *, wire_dtype: torch.dtype = torch.float32
) -> Tuple[Tensor, Tuple[int, int], Tuple[int, int]]:
    """Resize and zero-pad into the orientation bucket: (padded HWC array in
    `wire_dtype`, resized (h, w), original (h, w))."""
    resized, new_hw, orig_hw, (pad_h, pad_w) = resize_for_bucket(
        image, min_size, max_size, wire_dtype=wire_dtype)
    out = resized.new_zeros((pad_h, pad_w, resized.shape[2]))
    out[: new_hw[0], : new_hw[1]] = resized
    return out, new_hw, orig_hw


def resolve_device(device: Optional[str | torch.device]) -> torch.device:
    """`device`, or CUDA when none is given; raises rather than fall back."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "Retinanet runs on CUDA unless device='cpu' is passed, and CUDA is not available"
        )
    return device


class Retinanet:
    """The detector object: weights on one device, ``predict`` on raw images.

    The constructor takes the JAX ``Retinanet``'s arguments, with defaults
    from :mod:`..config` through ``ifnone``, plus ``device``. Weights start
    from a seeded random init; ``pretrained=True`` loads a torchvision
    ResNet checkpoint found by :func:`.zoo.fetch_backbone_weights`
    (``pretrained_path``, then the weights directory), and otherwise warns
    and keeps the random init (nothing is downloaded).
    """

    def __init__(
        self,
        num_classes: Optional[int] = None,
        backbone_kind: Optional[str] = None,
        prior: Optional[float] = None,
        pretrained: Optional[bool] = None,
        nms_thres: Optional[float] = None,
        score_thres: Optional[float] = None,
        max_detections_per_images: Optional[int] = None,
        freeze_bn: Optional[bool] = None,
        min_size: Optional[int] = None,
        max_size: Optional[int] = None,
        pretrained_path: Optional[str] = None,
        compute_dtype: Optional[str] = None,
        remat: bool = False,
        stem_s2d: bool = False,
        seed: int = 0,
        device: Optional[str | torch.device] = None,
        **unused,
    ):
        self.num_classes = ifnone(num_classes, C.NUM_CLASSES)
        self.backbone_kind = ifnone(backbone_kind, C.BACKBONE)
        if self.backbone_kind not in RESNET_SPECS:
            raise ValueError(
                f"backbone_kind must be one of {sorted(RESNET_SPECS)}, got {self.backbone_kind!r}"
            )
        self.prior = ifnone(prior, C.PRIOR)
        self.pretrained = ifnone(pretrained, C.PRETRAINED_BACKBONE)
        self.nms_thres = ifnone(nms_thres, C.NMS_THRES)
        self.score_thres = ifnone(score_thres, C.SCORE_THRES)
        self.max_detections = ifnone(max_detections_per_images, C.MAX_DETECTIONS_PER_IMAGE)
        self.freeze_bn = ifnone(freeze_bn, C.FREEZE_BN)
        self.min_size = ifnone(min_size, C.MIN_IMAGE_SIZE)
        self.max_size = ifnone(max_size, C.MAX_IMAGE_SIZE)
        self.device = resolve_device(device)

        self.module = RetinaNetModule(
            backbone_kind=self.backbone_kind,
            num_classes=self.num_classes,
            freeze_bn=self.freeze_bn,
            prior=self.prior,
            dtype=_DTYPES[ifnone(compute_dtype, C.COMPUTE_DTYPE)],
            remat=remat,
            stem_s2d=stem_s2d,
        )
        self.module.reset_parameters(torch.Generator().manual_seed(seed))
        if self.pretrained:
            resolved = fetch_backbone_weights(self.backbone_kind, pretrained_path)
            if resolved:
                self.load_torch_backbone(resolved)
        self.module.to(self.device, memory_format=torch.channels_last).eval()
        self._anchors: Dict[Tuple[int, int], List[Tensor]] = {}
        self._flat_anchors: Dict[Tuple[int, int], Tensor] = {}

    # ------------------------------------------------------------------ #
    def _anchors_for(self, bucket: Tuple[int, int]) -> List[Tensor]:
        if bucket not in self._anchors:
            self._anchors[bucket] = [
                torch.from_numpy(a).to(self.device) for a in generate_anchors_per_level(bucket)
            ]
        return self._anchors[bucket]

    @contextlib.contextmanager
    def _mode(self, train: bool):
        """The module in training mode when `train`, else in eval mode, and
        back in the mode it was in afterwards."""
        was = self.module.training
        self.module.train(train)
        try:
            yield
        finally:
            self.module.train(was)

    @torch.inference_mode()
    def _predict_impl(self, images: Tensor, image_sizes: Tensor) -> Detections:
        """Padded [B, H, W, 3] batch and [B, 2] resized sizes -> batched
        detections, in eval mode (running statistics, as JAX's train=False)."""
        with self._mode(False):
            cls_levels, box_levels = apply_detector(self.module, images, return_levels=True)
        return process_detections_multilevel_batch(
            cls_levels,
            box_levels,
            self._anchors_for(tuple(images.shape[1:3])),
            image_sizes,
            score_thres=self.score_thres,
            nms_thres=self.nms_thres,
            max_detections=self.max_detections,
        )

    @torch.inference_mode()
    def predict(self, images: List[np.ndarray]) -> List[Dict[str, np.ndarray]]:
        """Detect objects on raw HWC images (uint8, or float in [0, 1]).

        Images are resized on the device, grouped by orientation bucket, run
        one batch per bucket, and their boxes rescaled to each original size.
        A bucket whose images are all uint8 runs as a uint8 batch (uint8
        images resize to cv2's exact uint8 values); any other as f32.
        Returns per image ``{"boxes" [n, 4], "scores" [n], "labels" [n]}``.
        """
        out: List[Optional[Dict[str, np.ndarray]]] = [None] * len(images)
        groups: Dict[Tuple[int, int], List[int]] = {}
        plans = []
        for i, im in enumerate(images):
            new_hw, pad = _resize_plan(int(im.shape[0]), int(im.shape[1]), self.min_size, self.max_size)
            plans.append((new_hw, (int(im.shape[0]), int(im.shape[1]))))
            groups.setdefault(pad, []).append(i)

        for (pad_h, pad_w), idxs in groups.items():
            arrays = [np.asarray(images[i]) for i in idxs]
            # An all-uint8 group stays uint8 on the device (the wire format
            # apply_detector normalizes from bytes); any other goes as f32.
            wire = torch.uint8 if all(a.dtype == np.uint8 for a in arrays) else torch.float32
            batch = torch.zeros((len(idxs), pad_h, pad_w, 3), dtype=wire, device=self.device)
            for row, a in enumerate(arrays):
                image = torch.as_tensor(a).to(self.device)
                resized, (nh, nw), _, _ = resize_for_bucket(
                    image, self.min_size, self.max_size, wire_dtype=wire)
                batch[row, :nh, :nw] = resized
            sizes = torch.tensor([plans[i][0] for i in idxs], dtype=torch.float32, device=self.device)
            det = self._predict_impl(batch, sizes)
            boxes, scores, labels, valid = (t.cpu().numpy() for t in det)
            for row, i in enumerate(idxs):
                n = int(valid[row].sum())
                (nh, nw), (oh, ow) = plans[i]
                scale = np.array([ow, oh, ow, oh], np.float32) / np.array([nw, nh, nw, nh], np.float32)
                out[i] = {
                    "boxes": boxes[row, :n] * scale,
                    "scores": scores[row, :n],
                    "labels": labels[row, :n],
                }
        return out  # type: ignore[return-value]

    # ------------------------------------------------------------------ #
    def _loss_impl(self, images: Tensor, gt_boxes: Tensor, gt_labels: Tensor,
                   gt_valid: Tensor) -> Dict[str, Tensor]:
        """Losses of a padded batch through the module's own stem, in eval
        mode (running statistics, as JAX's ``_loss_impl`` with train=False)."""
        with self._mode(False):
            cls_logits, box_deltas = self.module(images)
        anchors = self._anchors_flat(tuple(images.shape[1:3]))
        return retinanet_loss(cls_logits, box_deltas, anchors, gt_boxes, gt_labels, gt_valid,
                              num_classes=self.num_classes)

    def _anchors_flat(self, bucket: Tuple[int, int]) -> Tensor:
        if bucket not in self._flat_anchors:
            self._flat_anchors[bucket] = torch.from_numpy(generate_anchors(bucket)).to(self.device)
        return self._flat_anchors[bucket]

    def forward(self, images, targets) -> Dict[str, Tensor]:
        """Training losses: ``{"classification_loss", "regression_loss"}``,
        f32 scalars that carry gradients into every parameter.

        Two input forms:
          * a padded batch: ``images [B, H, W, 3]`` (uint8, or f32 in [0, 1])
            and ``targets = {"boxes" [B, N, 4], "labels" [B, N], "valid"
            [B, N]}``, tensors or numpy;
          * the reference's ragged form: a list of HWC images and a list of
            ``{"boxes" [n, 4], "labels" [n]}``, resized and padded here on
            the device.

        The module runs in eval mode whatever mode it was left in, so a
        ``freeze_bn=False`` detector uses its running statistics here and
        leaves them alone, as the JAX ``forward`` does; the ``Trainer``'s
        steps call the module in training mode themselves.
        """
        if isinstance(images, (list, tuple)):
            images, targets = self._pad_ragged(images, targets)
        dev = self.device
        return self._loss_impl(
            torch.as_tensor(images).to(dev),
            torch.as_tensor(targets["boxes"]).to(dev),
            torch.as_tensor(targets["labels"]).to(dev),
            torch.as_tensor(targets["valid"]).to(dev),
        )

    __call__ = forward

    def _pad_ragged(self, images, targets):
        """Ragged images and targets -> a padded batch on the device.

        Each image is resized on the device by the reference rule into an f32
        batch (a uint8 image to cv2's exact values, then /255), and its
        boxes scaled by the same factors; the batch is padded to the largest
        bucket in it, so a mixed-orientation list is letterboxed up to
        max_size x max_size, as the JAX package does.
        """
        resized, boxes, labels, valid = [], [], [], []
        for img, tgt in zip(images, targets):
            img = (img if isinstance(img, Tensor) else torch.as_tensor(np.asarray(img))).to(self.device)
            x, (new_h, new_w), (orig_h, orig_w), pad = resize_for_bucket(
                img, self.min_size, self.max_size)
            b = np.asarray(tgt["boxes"], np.float32).reshape(-1, 4)
            if len(b):
                sx, sy = new_w / orig_w, new_h / orig_h
                b = b * np.array([sx, sy, sx, sy], np.float32)
            pb, pl, pv = pad_targets(b, np.asarray(tgt["labels"]).reshape(-1), C.MAX_GT_BOXES)
            resized.append((x, pad))
            boxes.append(pb)
            labels.append(pl)
            valid.append(pv)
        max_h = max(pad[0] for _, pad in resized)
        max_w = max(pad[1] for _, pad in resized)
        batch = torch.zeros((len(resized), max_h, max_w, 3), dtype=torch.float32, device=self.device)
        for i, (x, _) in enumerate(resized):
            batch[i, : x.shape[0], : x.shape[1]] = x
        return batch, {
            "boxes": torch.from_numpy(np.stack(boxes)).to(self.device),
            "labels": torch.from_numpy(np.stack(labels)).to(self.device),
            "valid": torch.from_numpy(np.stack(valid)).to(self.device),
        }

    # ------------------------------------------------------------------ #
    def apply(self, variables: Optional[Mapping[str, Tensor]], images: Tensor,
              train: bool = False) -> Tuple[Tensor, Tensor]:
        """The module on padded images -> (cls_logits [N, A, K], box_deltas
        [N, A, 4]), with `variables` (a ``state_dict``, None for the
        detector's own weights) and in training mode when `train`."""
        with self._mode(train):
            if variables is None:
                return self.module(images)
            return torch.func.functional_call(self.module, dict(variables), (images,))

    def load_torch_backbone(self, path: str) -> None:
        """Load a torchvision ImageNet ResNet ``.pth`` into the backbone
        (its ``fc.*`` classifier is dropped)."""
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        sd = {k: v for k, v in sd.items() if not k.startswith("fc.")}
        self.module.backbone.backbone.load_state_dict(sd, strict=True)

    def load_torch_state_dict(self, state_dict_or_path: Any) -> None:
        """Load a whole reference-schema detector checkpoint (a path to a
        ``.pth`` or a ``state_dict``); the reference's ``anchor_generator.*``
        constants and an ImageNet ``fc.*`` are ignored, and missing
        ``num_batches_tracked`` counters keep their values."""
        sd = state_dict_or_path
        if isinstance(sd, (str, bytes)) or hasattr(sd, "__fspath__"):
            sd = torch.load(sd, map_location="cpu", weights_only=True)
            if isinstance(sd, dict) and "state_dict" in sd:
                sd = sd["state_dict"]
        sd = {k: v for k, v in sd.items() if not k.startswith(_IGNORABLE_PREFIXES)}
        for k, v in self.module.state_dict().items():
            if k.endswith("num_batches_tracked"):
                sd.setdefault(k, v)
        self.load_state_dict(sd)

    def to_torch_state_dict(self) -> Dict[str, Tensor]:
        """The weights in the reference detector's ``state_dict`` schema, as
        CPU tensors, which the reference ``Retinanet`` loads as they are."""
        return {k: v.detach().cpu().clone() for k, v in self.module.state_dict().items()}

    def save_torch_state_dict(self, path: str) -> None:
        """``torch.save`` :meth:`to_torch_state_dict` at `path`."""
        torch.save(self.to_torch_state_dict(), path)

    # ------------------------------------------------------------------ #
    def state_dict(self) -> Dict[str, Tensor]:
        """Weights in the reference detector's ``state_dict`` schema."""
        return self.module.state_dict()

    def load_state_dict(self, state: Any) -> None:
        """Load weights, ``strict=True``: a reference-schema ``state_dict``
        (tensors or numpy arrays) or the JAX package's ``{"params",
        "batch_stats"}`` variables."""
        if isinstance(state, Mapping) and "params" in state:
            state = from_jax_variables(state, self.backbone_kind)
        self.module.load_state_dict(
            {k: torch.as_tensor(np.asarray(v) if not isinstance(v, Tensor) else v)
             for k, v in state.items()},
            strict=True,
        )
