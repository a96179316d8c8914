"""Hand-written Hopper kernels of the port, each beside its plain version.

``KERNELS`` names every kernel: its wrapper (whose ``launches`` attribute
counts the kernel's launches), its route, its source, and the TPU kernel it
replaces.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

from .nms import nms_keep_mask, nms_keep_mask_plain
from .stem import stem_forward, stem_plain, stem_supported


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
)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.wrapper.launches = 0


__all__ = [
    "KERNELS",
    "Kernel",
    "nms_keep_mask",
    "nms_keep_mask_plain",
    "reset_launch_counts",
    "stem_forward",
    "stem_plain",
    "stem_supported",
]
