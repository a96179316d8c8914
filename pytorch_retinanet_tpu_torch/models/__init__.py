"""Detector network, the user-facing ``Retinanet`` and ``AnchorGenerator``."""

from .. import config as _C
from ..ops import generate_anchors as _generate_anchors
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
from .zoo import MODEL_URLS, fetch_backbone_weights


class AnchorGenerator:
    """The reference's anchor generator by name (JAX ``models/__init__.py``):
    anchors are a function of the padded image size, with the reference's
    sizes, aspect ratios, strides and offset unless given."""

    def __init__(self, sizes=None, aspect_ratios=None, strides=None, offset=None):
        self.sizes = tuple(tuple(s) for s in (sizes or _C.ANCHOR_SIZES))
        self.aspect_ratios = tuple(aspect_ratios or _C.ANCHOR_ASPECT_RATIOS)
        self.strides = tuple(strides or _C.ANCHOR_STRIDES)
        self.offset = _C.ANCHOR_OFFSET if offset is None else offset

    def __call__(self, image_size):
        """[A_total, 4] float32 XYXY anchors (numpy) for a padded (H, W)."""
        return _generate_anchors(tuple(image_size), sizes=self.sizes,
                                 aspect_ratios=self.aspect_ratios, strides=self.strides,
                                 offset=self.offset)


__all__ = [
    "AnchorGenerator",
    "MODEL_URLS",
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
    "fetch_backbone_weights",
    "from_jax_variables",
    "fused_stem_applicable",
    "fused_trunk_applicable",
    "resize_for_bucket",
    "resize_to_bucket",
    "resolution_buckets",
    "stem_constants",
]
