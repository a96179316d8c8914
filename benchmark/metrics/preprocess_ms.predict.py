"""ms of Retinanet.predict's host front for one call: grouping, upload and the
device resize into the padded batch, from the call to its ``_predict_impl``
(after a synchronize there), on the host clock."""

import statistics

LAYER = "host front"
UNIT = "ms"
MOVES = "predict_img_s"
SOURCE = "program_span"


def read(run):
    values = run["spans"].get("predict.preprocess")
    return statistics.median(values) if values else None
