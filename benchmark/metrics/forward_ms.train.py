"""ms of the training-mode forward on one batch of the cell (the module's own
stem, trunk, FPN and head), by CUDA events."""

import statistics

LAYER = "model"
UNIT = "ms"
MOVES = "train_img_s"
SOURCE = "program_span"


def read(run):
    values = run["spans"].get("train.forward")
    return statistics.median(values) if values else None
