"""RetinaNet: backbone -> FPN -> head, and the user-facing ``Retinanet``.

Counterpart of ``pytorch_retinanet_tpu/models/retinanet.py`` for inference:

* :class:`RetinaNetModule` takes a padded NHWC batch (f32 in [0, 1], or the
  uint8 wire format with /255 folded into the normalize constants) and
  returns per-level logits and deltas.
* :func:`apply_detector` is the inference forward: it runs the fused stem
  kernel when the shape and dtype allow it, and the module's own stem
  otherwise.
* :class:`Retinanet` owns the weights and a device, resizes images on the
  device into the orientation buckets, and returns detections as numpy.
"""

from __future__ import annotations

import math
import os
import warnings
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import config as C
from ..config import ifnone
from ..kernels.stem import stem_forward, stem_supported
from ..ops import (
    Detections,
    generate_anchors_per_level,
    num_anchors_per_location,
    process_detections_multilevel_batch,
)
from .backbone import RESNET_SPECS, BackBone, backbone_out_channels
from .converter import from_jax_variables
from .fpn import FeaturePyramid
from .head import RetinaNetHead

Tensor = torch.Tensor

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class RetinaNetModule(nn.Module):
    """Padded [N, H, W, 3] images -> per-level (logits, deltas)."""

    def __init__(
        self,
        backbone_kind: str = "resnet50",
        num_classes: int = C.NUM_CLASSES,
        prior: float = C.PRIOR,
        channels: int = 256,
        mean: Sequence[float] = tuple(C.MEAN),
        std: Sequence[float] = tuple(C.STD),
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.backbone_kind = backbone_kind
        self.num_classes = num_classes
        self.prior = prior
        self.mean = tuple(mean)
        self.std = tuple(std)
        self.dtype = dtype
        self.backbone = BackBone(backbone_kind)
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
    ):
        """`stem_in`, when given, is the fused stem's NHWC output on the
        already normalized images, and `images` is not read."""
        if stem_in is None:
            x = self.normalize(images).permute(0, 3, 1, 2).to(self.dtype)
            feats = self.backbone(x)
        else:
            feats = self.backbone(None, stem_in.permute(0, 3, 1, 2).to(self.dtype))
        return self.retinanet_head(self.fpn(feats), return_levels)


def fused_stem_applicable(module: RetinaNetModule, image_shape: Sequence[int]) -> bool:
    """The fused stem serves the bf16 module on the shapes the kernel takes."""
    return module.dtype == torch.bfloat16 and stem_supported(image_shape)


def apply_detector(
    module: RetinaNetModule,
    images: Tensor,
    *,
    return_levels: bool = False,
    use_fused_stem: Optional[bool] = None,
):
    """Inference forward, through the fused stem kernel where it applies."""
    if use_fused_stem is None:
        use_fused_stem = fused_stem_applicable(module, images.shape)
    if not use_fused_stem:
        return module(images, return_levels)
    resnet = module.backbone.backbone
    scale, shift = resnet.bn1.folded()
    stem = stem_forward(module.normalize(images), resnet.conv1.weight, scale, shift)
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


def resize_for_bucket(
    image: Tensor, min_size: int, max_size: int
) -> Tuple[Tensor, Tuple[int, int], Tuple[int, int], Tuple[int, int]]:
    """The reference resize rule on the device, without the bucket pad.

    `image` is HWC, uint8 (scaled by 1/255) or float in [0, 1]. The resize is
    bilinear with half-pixel centres and no antialias, as ``cv2.INTER_LINEAR``
    is. Returns (resized HWC f32, resized (h, w), original (h, w), bucket
    (pad_h, pad_w)).
    """
    orig_h, orig_w = int(image.shape[0]), int(image.shape[1])
    (new_h, new_w), pad = _resize_plan(orig_h, orig_w, min_size, max_size)
    x = image.float() / 255.0 if image.dtype == torch.uint8 else image.float()
    if (new_h, new_w) != (orig_h, orig_w):
        x = F.interpolate(
            x.permute(2, 0, 1)[None], size=(new_h, new_w), mode="bilinear",
            align_corners=False, antialias=False,
        )[0].permute(1, 2, 0)
    return x, (new_h, new_w), (orig_h, orig_w), pad


def resize_to_bucket(
    image: Tensor, min_size: int, max_size: int
) -> Tuple[Tensor, Tuple[int, int], Tuple[int, int]]:
    """Resize and zero-pad into the orientation bucket: (padded HWC f32,
    resized (h, w), original (h, w))."""
    resized, new_hw, orig_hw, (pad_h, pad_w) = resize_for_bucket(image, min_size, max_size)
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
    ResNet checkpoint from ``pretrained_path`` when that file exists, and
    otherwise warns and keeps the random init (nothing is downloaded).
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
            prior=self.prior,
            dtype=_DTYPES[ifnone(compute_dtype, C.COMPUTE_DTYPE)],
        )
        self.module.reset_parameters(torch.Generator().manual_seed(seed))
        if self.pretrained:
            self._load_pretrained(pretrained_path)
        self.module.to(self.device, memory_format=torch.channels_last).eval()
        self._anchors: Dict[Tuple[int, int], List[Tensor]] = {}

    def _load_pretrained(self, path: Optional[str]) -> None:
        if not path or not os.path.exists(path):
            warnings.warn(
                f"no local {self.backbone_kind} checkpoint at {path!r}; using random init. "
                "Pass pretrained_path= a torchvision ResNet .pth to load one.",
                stacklevel=3,
            )
            return
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        sd = {k: v for k, v in sd.items() if not k.startswith("fc.")}
        self.module.backbone.backbone.load_state_dict(sd, strict=True)

    # ------------------------------------------------------------------ #
    def _anchors_for(self, bucket: Tuple[int, int]) -> List[Tensor]:
        if bucket not in self._anchors:
            self._anchors[bucket] = [
                torch.from_numpy(a).to(self.device) for a in generate_anchors_per_level(bucket)
            ]
        return self._anchors[bucket]

    @torch.inference_mode()
    def _predict_impl(self, images: Tensor, image_sizes: Tensor) -> Detections:
        """Padded [B, H, W, 3] batch and [B, 2] resized sizes -> batched detections."""
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
            batch = torch.zeros((len(idxs), pad_h, pad_w, 3), dtype=torch.float32, device=self.device)
            for row, i in enumerate(idxs):
                image = torch.as_tensor(np.asarray(images[i])).to(self.device)
                resized, (nh, nw), _, _ = resize_for_bucket(image, self.min_size, self.max_size)
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
