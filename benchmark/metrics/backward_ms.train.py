"""ms of autograd's backward of the loss: forward, loss and backward by CUDA
events, less forward and loss."""

import statistics

LAYER = "backward"
UNIT = "ms"
MOVES = "train_img_s"
SOURCE = "program_span"


def read(run):
    values = run["spans"].get("train.backward")
    return statistics.median(values) if values else None
