"""ms the host spends in the forward's dispatch: the program's
``predict.forward`` span on the host clock (its launches, and any wait in
them), the median over the pass's calls (rnbench/spans.py)."""

from rnbench import spans

LAYER = "model"
UNIT = "ms"
MOVES = "predict_img_s"
SOURCE = "program_span"


def read(run):
    return spans.median_ms(run, "predict.forward")
