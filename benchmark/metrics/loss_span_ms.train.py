"""ms of a training step's loss on the card (the per-level loss with the match
kernel): the program's ``train.loss`` span's CUDA events, the median over
the pass's steps on rank 0 (rnbench/spans.py)."""

from rnbench import spans

LAYER = "loss"
UNIT = "ms"
MOVES = "train_img_s"
SOURCE = "program_span"


def read(run):
    return spans.median_ms(run, "train.loss", "device_ms")
