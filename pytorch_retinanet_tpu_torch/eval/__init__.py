"""Evaluation: self-contained COCO mAP (pycocotools-compatible), the
counterpart of ``pytorch_retinanet_tpu/eval``."""

from .coco_eval import COCOeval, CocoEvaluator, Params, bbox_iou_xywh

__all__ = ["COCOeval", "CocoEvaluator", "Params", "bbox_iou_xywh"]
