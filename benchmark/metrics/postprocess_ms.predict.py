"""ms of process_detections_multilevel_batch on the forward's outputs (the
selection, decode and the NMS kernel), by CUDA events around the call."""

import statistics

LAYER = "postprocess"
UNIT = "ms"
MOVES = "predict_img_s"
SOURCE = "program_span"


def read(run):
    values = run["spans"].get("predict.postprocess")
    return statistics.median(values) if values else None
