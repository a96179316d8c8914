"""Kernel launches a call of Retinanet.predict makes: the runtime's launch
calls (cudaLaunchKernel, cuLaunchKernel*) inside each ``predict`` span of
the pass's profiler window, the median over its calls (rnbench/spans.py)."""

import statistics

from rnbench import spans

LAYER = "device"
UNIT = "count"
MOVES = "predict_img_s"
SOURCE = "device_trace"


def read(run):
    window = (spans.program_pass(run) or {}).get("window")
    return statistics.median(window["launches"]) if window else None
