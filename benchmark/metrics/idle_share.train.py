"""% of a profiler window of whole training steps (inside the fit) in which
no kernel, copy or set ran on the card; the mean over the ranks."""

LAYER = "device"
UNIT = "%"
MOVES = "train_img_s"
SOURCE = "device_trace"


def read(run):
    t = run["trace"]
    if not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
