"""% of the card's idle time in the pass's profiler window of whole predict
calls that lies inside the program's ``predict.front`` spans (host user
annotations on the trace's clock; rnbench/spans.py)."""

from rnbench import spans

LAYER = "host front"
UNIT = "%"
MOVES = "predict_img_s"
SOURCE = "device_trace"


def read(run):
    window = (spans.program_pass(run) or {}).get("window")
    if not window or not window["idle_s"]:
        return None
    return 100.0 * window["idle_in"].get("predict.front", 0.0) / window["idle_s"]
