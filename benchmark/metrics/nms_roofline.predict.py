"""% of its roofline the NMS kernel reaches in predict: the frozen bound
(12 operations per IoU pair of valid candidates, counted at the kernel's
wrapper) over both passes' device time per call."""

from rnbench import yardstick

LAYER = "NMS kernel"
UNIT = "%"
MOVES = "predict_img_s"
SOURCE = "device_trace"


def read(run):
    per_call = yardstick.kernel_s_per_call(run["trace"], ("nms_mask_kernel", "nms_scan_kernel"))
    counts = run["counters"].get("nms.valid_per_image")
    if per_call is None or not counts:
        return None
    bound, _ = yardstick.nms_bound_s(counts, run["counters"]["nms.k"], yardstick.peaks(run["device_name"]))
    return 100.0 * bound / per_call
