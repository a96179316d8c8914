"""ms of Retinanet.predict's host front a call (grouping, the pageable uploads
and device resizes into the padded batch): the program's ``predict.front``
span on the host clock, the median over the pass's calls (rnbench/spans.py)."""

from rnbench import spans

LAYER = "host front"
UNIT = "ms"
MOVES = "predict_img_s"
SOURCE = "program_span"


def read(run):
    return spans.median_ms(run, "predict.front")
