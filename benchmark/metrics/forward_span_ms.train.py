"""ms of a training step's forward on the card (DDP's forward under more than
one rank): the program's ``train.forward`` span's CUDA events, the median
over the pass's steps on rank 0 (rnbench/spans.py)."""

from rnbench import spans

LAYER = "model"
UNIT = "ms"
MOVES = "train_img_s"
SOURCE = "program_span"


def read(run):
    return spans.median_ms(run, "train.forward", "device_ms")
