"""Padding of ragged ground truth into the fixed-shape batch form.

Counterpart of ``pytorch_retinanet_tpu/data/loader.py::pad_targets``. The
rest of that loader (datasets, transforms, the batching loader) is ROADMAP
A8 and not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def pad_targets(
    boxes: np.ndarray, labels: np.ndarray, max_gt: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad [n, 4] / [n] GT to [max_gt] rows with a validity mask; boxes past
    ``max_gt`` are dropped."""
    n = min(len(boxes), max_gt)
    out_boxes = np.zeros((max_gt, 4), np.float32)
    out_labels = np.zeros((max_gt,), np.int32)
    out_valid = np.zeros((max_gt,), bool)
    out_boxes[:n] = boxes[:n]
    out_labels[:n] = labels[:n]
    out_valid[:n] = True
    return out_boxes, out_labels, out_valid
