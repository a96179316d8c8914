"""ms of a training step's spatial-reduction attention on the card (norm1
and the SRA branch of every PVT block, the forward alone): the program's
``pvt.attention`` spans' CUDA events summed within a step, the median over
the pass's steps on rank 0 (rnbench/spans.py). None where the program has
no such span: a ResNet trunk, or a program without the PVT trunk."""

from rnbench import spans

LAYER = "attention"
UNIT = "ms"
MOVES = "train_img_s"
SOURCE = "program_span"


def read(run):
    return spans.median_ms(run, "pvt.attention", "device_ms")
