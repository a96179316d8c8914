"""Hand-written Hopper kernels of the port, each beside its plain version.

``KERNELS`` names every kernel: its wrapper (whose ``launches`` attribute
counts the kernel's launches), its route, its source, and the TPU kernel it
replaces.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

from .bottleneck import (
    bottleneck_args,
    BOTTLENECK_TRACE_FIELDS,
    bottleneck_launch_config,
    bottleneck_phase_trace,
    bottleneck_plain,
    bottleneck_weight_tiles,
    fused_bottleneck,
    fused_bottleneck_supported,
    pack_bottleneck_weights,
)
from .focal import focal_loss_backward_plain, focal_loss_sums, focal_loss_sums_plain
from .frozen_bn import frozen_batch_norm, frozen_bn_backward_plain, frozen_bn_plain
from .match import match_targets, match_targets_plain
from .nms import nms_keep_mask, nms_keep_mask_plain
from .select import top2_classes, top2_classes_plain
from .stem import pack_stem_weights, stem_forward, stem_gemm_weights, stem_plain, stem_supported


class Kernel(NamedTuple):
    name: str
    wrapper: Callable
    route: str
    source: str
    replaces: str


KERNELS: Tuple[Kernel, ...] = (
    Kernel("fused_stem", stem_forward, "cuda",
           "pytorch_retinanet_tpu_torch/csrc/stem.cu",
           "pytorch_retinanet_tpu/kernels/stem_pallas.py:248"),
    Kernel("nms_keep_mask", nms_keep_mask, "cuda",
           "pytorch_retinanet_tpu_torch/csrc/nms.cu",
           "pytorch_retinanet_tpu/kernels/nms_pallas.py:115"),
    Kernel("match_targets", match_targets, "cuda",
           "pytorch_retinanet_tpu_torch/csrc/match.cu",
           "pytorch_retinanet_tpu/kernels/match_pallas.py:221"),
    Kernel("fused_bottleneck", fused_bottleneck, "cuda",
           "pytorch_retinanet_tpu_torch/csrc/bottleneck.cu",
           "pytorch_retinanet_tpu/kernels/bottleneck_pallas.py:270"),
    Kernel("top2_classes", top2_classes, "cuda",
           "pytorch_retinanet_tpu_torch/csrc/top2.cu",
           "pytorch_retinanet_tpu/kernels/select_pallas.py:105"),
    Kernel("frozen_bn", frozen_batch_norm, "cuda",
           "pytorch_retinanet_tpu_torch/csrc/frozen_bn.cu",
           "none: the JAX package leaves frozen BN to XLA's fusion; bound by bytes, 6.8 ms "
           "backward and 4.5 ms forward a R-50 step at batch 16, 800x1344 (3.81 G elements)"),
    Kernel("focal_loss", focal_loss_sums, "cuda",
           "pytorch_retinanet_tpu_torch/csrc/focal.cu",
           "none: the JAX package leaves the focal loss to XLA's fusion; bound by bytes, 0.18 ms "
           "forward and 0.35 ms backward a R-50 step at batch 16, 800x1344 (290.3 M logits)"),
)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.wrapper.launches = 0


__all__ = [
    "BOTTLENECK_TRACE_FIELDS",
    "KERNELS",
    "Kernel",
    "bottleneck_args",
    "bottleneck_launch_config",
    "bottleneck_phase_trace",
    "bottleneck_plain",
    "bottleneck_weight_tiles",
    "focal_loss_backward_plain",
    "focal_loss_sums",
    "focal_loss_sums_plain",
    "frozen_batch_norm",
    "frozen_bn_backward_plain",
    "frozen_bn_plain",
    "fused_bottleneck",
    "fused_bottleneck_supported",
    "match_targets",
    "match_targets_plain",
    "nms_keep_mask",
    "nms_keep_mask_plain",
    "pack_bottleneck_weights",
    "pack_stem_weights",
    "reset_launch_counts",
    "stem_forward",
    "stem_gemm_weights",
    "stem_plain",
    "stem_supported",
    "top2_classes",
    "top2_classes_plain",
]
