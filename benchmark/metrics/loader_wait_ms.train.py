"""ms the fit waits for the loader a step: the program's ``train.fetch`` span
(MetricLogger.log_every's wait) on the host clock, the median over the
pass's steps on rank 0 (rnbench/spans.py)."""

from rnbench import spans

LAYER = "loader"
UNIT = "ms"
MOVES = "train_img_s"
SOURCE = "program_span"


def read(run):
    return spans.median_ms(run, "train.fetch")
