"""% of its roofline the fused stem kernel reaches in predict: the frozen
bound (operations or bytes, benchmark/rnbench/yardstick.py) over the
kernel's device time per call in the profiler window."""

from rnbench import yardstick

LAYER = "stem kernel"
UNIT = "%"
MOVES = "predict_img_s"
SOURCE = "device_trace"


def read(run):
    per_call = yardstick.kernel_s_per_call(run["trace"], ("stem_kernel",))
    if per_call is None:
        return None
    h, w = run["bucket"]
    bound, _ = yardstick.stem_bound_s(run["batch"], h, w, 1, yardstick.peaks(run["device_name"]))
    return 100.0 * bound / per_call
