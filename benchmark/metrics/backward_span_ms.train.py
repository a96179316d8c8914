"""ms of a training step's backward on the card (under DDP with the gradient
all-reduce's finish): the program's ``train.backward`` span's CUDA events,
the median over the pass's steps on rank 0 (rnbench/spans.py)."""

from rnbench import spans

LAYER = "backward"
UNIT = "ms"
MOVES = "train_img_s"
SOURCE = "program_span"


def read(run):
    return spans.median_ms(run, "train.backward", "device_ms")
