"""ms of apply_detector(..., return_levels=True) on the cell's batch: the
stem kernel, trunk, FPN and head, by CUDA events around the call."""

import statistics

LAYER = "model"
UNIT = "ms"
MOVES = "predict_img_s"
SOURCE = "program_span"


def read(run):
    values = run["spans"].get("predict.forward")
    return statistics.median(values) if values else None
