"""Box math, anchors, the matcher, the training losses and the detection postprocess, on tensors."""

from .anchors import (
    feature_grid_sizes,
    generate_anchors,
    generate_anchors_per_level,
    generate_cell_anchors,
    num_anchors_per_location,
)
from .boxes import (
    box_area,
    box_iou,
    clip_boxes,
    cxcywh_to_xyxy,
    decode_boxes,
    encode_boxes,
    rescale_boxes,
    small_box_mask,
    xyxy_to_cxcywh,
)
from .losses import retinanet_loss, retinanet_loss_levels, sigmoid_focal_loss, smooth_l1_loss
from .matcher import BACKGROUND, IGNORE, MatchResult, match_anchors, match_anchors_batch
from .nms import (
    Detections,
    merge_candidates,
    multilevel_candidates,
    nms_keep_mask,
    pack_detections,
    process_detections_multilevel,
    process_detections_multilevel_batch,
    top_k,
    unpack_detections,
)

__all__ = [
    "BACKGROUND",
    "Detections",
    "IGNORE",
    "MatchResult",
    "box_area",
    "box_iou",
    "clip_boxes",
    "cxcywh_to_xyxy",
    "decode_boxes",
    "encode_boxes",
    "feature_grid_sizes",
    "generate_anchors",
    "generate_anchors_per_level",
    "generate_cell_anchors",
    "match_anchors",
    "match_anchors_batch",
    "merge_candidates",
    "multilevel_candidates",
    "nms_keep_mask",
    "num_anchors_per_location",
    "pack_detections",
    "process_detections_multilevel",
    "process_detections_multilevel_batch",
    "rescale_boxes",
    "retinanet_loss",
    "retinanet_loss_levels",
    "sigmoid_focal_loss",
    "small_box_mask",
    "smooth_l1_loss",
    "top_k",
    "unpack_detections",
    "xyxy_to_cxcywh",
]
