"""ms a call of the images' pageable uploads: the program's ``predict.upload``
spans (one an image) on the host clock, summed within each call; the median
over the pass's calls (rnbench/spans.py)."""

from rnbench import spans

LAYER = "host front"
UNIT = "ms"
MOVES = "predict_img_s"
SOURCE = "program_span"


def read(run):
    return spans.median_ms(run, "predict.upload")
