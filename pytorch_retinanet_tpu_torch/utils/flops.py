"""Analytic conv FLOPs of the detector, and the card's peak bf16 rate.

Counterpart of ``pytorch_retinanet_tpu/utils/flops.py``: the numerator and
denominator of a model-FLOPs utilization. FLOPs count conv MACs x 2 only
(batch norm, elementwise and pooling left out), so a utilization from them
is a lower bound.
"""

from __future__ import annotations

import os


def conv_flops(out_hw, k, cin, cout) -> int:
    """2 x MACs of one conv layer at output spatial size out_hw."""
    return 2 * out_hw[0] * out_hw[1] * k * k * cin * cout


_BOTTLENECK_DEPTHS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3),
                      "resnet152": (3, 8, 36, 3)}


def supported_trunks() -> set:
    """Backbone kinds the tables cover (bottleneck ResNets only)."""
    return set(_BOTTLENECK_DEPTHS)


def resnet_trunk_flops(h: int, w: int, kind: str = "resnet50") -> int:
    """Conv FLOPs of a bottleneck-ResNet trunk (stem and 4 stages) at h x w."""
    depths = _BOTTLENECK_DEPTHS[kind]
    fl = conv_flops((h // 2, w // 2), 7, 3, 64)  # stem
    cfg = [(depths[0], 64, 64, 1), (depths[1], 128, 256, 2),
           (depths[2], 256, 512, 2), (depths[3], 512, 1024, 2)]
    sh, sw = h // 4, w // 4
    for blocks, width, cin, stride in cfg:
        oh, ow = sh // stride, sw // stride
        for b in range(blocks):
            icin = cin if b == 0 else width * 4
            ih, iw = (sh, sw) if b == 0 else (oh, ow)
            fl += conv_flops((ih, iw), 1, icin, width)           # 1x1 reduce
            fl += conv_flops((oh, ow), 3, width, width)          # 3x3 (stride)
            fl += conv_flops((oh, ow), 1, width, width * 4)      # 1x1 expand
            if b == 0:
                fl += conv_flops((oh, ow), 1, icin, width * 4)   # downsample
        sh, sw = oh, ow
    return fl


def resnet50_flops(h: int, w: int) -> int:
    return resnet_trunk_flops(h, w, "resnet50")


def fpn_flops(h: int, w: int, channels: int = 256) -> int:
    fl = 0
    for lh, lw, cin in ((h // 8, w // 8, 512), (h // 16, w // 16, 1024),
                        (h // 32, w // 32, 2048)):
        fl += conv_flops((lh, lw), 1, cin, channels)       # lateral
        fl += conv_flops((lh, lw), 3, channels, channels)  # smooth
    fl += conv_flops((h // 64, w // 64), 3, 2048, channels)        # P6
    fl += conv_flops((h // 128, w // 128), 3, channels, channels)  # P7
    return fl


def head_flops(h: int, w: int, num_classes: int = 90, anchors: int = 9,
               channels: int = 256) -> int:
    fl = 0
    for s in (8, 16, 32, 64, 128):
        hw = (h // s, w // s)
        fl += 2 * 4 * conv_flops(hw, 3, channels, channels)       # both subnets
        fl += conv_flops(hw, 3, channels, anchors * num_classes)  # cls pred
        fl += conv_flops(hw, 3, channels, anchors * 4)            # box pred
    return fl


def detector_flops(h: int, w: int, num_classes: int = 90, kind: str = "resnet50") -> int:
    """Forward conv FLOPs of ResNet-FPN and the head for one image at h x w."""
    return resnet_trunk_flops(h, w, kind) + fpn_flops(h, w) + head_flops(h, w, num_classes)


# Dense bf16 tensor-core peak, TFLOP/s, by CUDA device name (lower case).
_PEAK_BY_NAME = (
    ("h100 80gb hbm3", 989.0),  # H100 SXM
    ("h100 sxm", 989.0),
)


def peak_bf16_tflops(device=None) -> float:
    """The card's dense bf16 TFLOP/s: the ``PEAK_TFLOPS`` environment
    variable when set, else by the CUDA device's name; raises for a card
    the table lacks."""
    env = os.environ.get("PEAK_TFLOPS")
    if env:
        return float(env)
    import torch

    name = torch.cuda.get_device_name(device).lower()
    for needle, peak in _PEAK_BY_NAME:
        if needle in name:
            return peak
    raise ValueError(f"no peak bf16 rate for {name!r}; set PEAK_TFLOPS")
