"""ms of the forward on the card: the program's ``predict.forward`` span's
CUDA events (stem kernel, trunk, FPN, head), the median over the pass's
calls (rnbench/spans.py)."""

from rnbench import spans

LAYER = "model"
UNIT = "ms"
MOVES = "predict_img_s"
SOURCE = "program_span"


def read(run):
    return spans.median_ms(run, "predict.forward", "device_ms")
