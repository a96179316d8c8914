"""ms of a training step's feed-forward sublayers on the card (norm2 and
the MixFFN branch, fc1, depthwise conv, GELU and fc2, of every PVT block,
the forward alone): the program's ``pvt.ffn`` spans' CUDA events summed
within a step, the median over the pass's steps on rank 0
(rnbench/spans.py). None where the program has no such span."""

from rnbench import spans

LAYER = "feed-forward"
UNIT = "ms"
MOVES = "train_img_s"
SOURCE = "program_span"


def read(run):
    return spans.median_ms(run, "pvt.ffn", "device_ms")
