"""% of a profiler window of whole predict calls in which no kernel, copy or
set ran on the card."""

LAYER = "device"
UNIT = "%"
MOVES = "predict_img_s"
SOURCE = "device_trace"


def read(run):
    t = run["trace"]
    if not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
