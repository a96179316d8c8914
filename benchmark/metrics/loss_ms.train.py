"""ms of the per-level loss with the match kernel on the forward's outputs:
forward and loss by CUDA events, less the forward."""

import statistics

LAYER = "loss"
UNIT = "ms"
MOVES = "train_img_s"
SOURCE = "program_span"


def read(run):
    values = run["spans"].get("train.loss")
    return statistics.median(values) if values else None
