"""ms of the postprocess on the card: the program's ``predict.postprocess``
span's CUDA events (selection, decode, the NMS kernel), the median over the
pass's calls (rnbench/spans.py)."""

from rnbench import spans

LAYER = "postprocess"
UNIT = "ms"
MOVES = "predict_img_s"
SOURCE = "program_span"


def read(run):
    return spans.median_ms(run, "predict.postprocess", "device_ms")
