"""ms of a training step's optimizer on the card (clip, SGD's step,
zero_grad): the program's ``train.optimizer`` span's CUDA events, the median
over the pass's steps on rank 0 (rnbench/spans.py)."""

from rnbench import spans

LAYER = "optimizer"
UNIT = "ms"
MOVES = "train_img_s"
SOURCE = "program_span"


def read(run):
    return spans.median_ms(run, "train.optimizer", "device_ms")
