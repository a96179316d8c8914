"""Detector network and the user-facing ``Retinanet``."""

from .backbone import RESNET_SPECS, BackBone, ResNet, backbone_out_channels
from .converter import from_jax_variables
from .fpn import FeaturePyramid
from .fused_backbone import apply_trunk_fused, entry_bottleneck, fused_trunk_applicable
from .head import RetinaNetHead
from .retinanet import (
    RetinaNetModule,
    Retinanet,
    apply_detector,
    fused_stem_applicable,
    resize_for_bucket,
    resize_to_bucket,
    resolution_buckets,
    stem_constants,
)

__all__ = [
    "RESNET_SPECS",
    "BackBone",
    "FeaturePyramid",
    "ResNet",
    "RetinaNetHead",
    "RetinaNetModule",
    "Retinanet",
    "apply_detector",
    "apply_trunk_fused",
    "backbone_out_channels",
    "entry_bottleneck",
    "from_jax_variables",
    "fused_stem_applicable",
    "fused_trunk_applicable",
    "resize_for_bucket",
    "resize_to_bucket",
    "resolution_buckets",
    "stem_constants",
]
