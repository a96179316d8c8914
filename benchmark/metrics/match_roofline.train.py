"""% of its roofline the match kernel reaches over a step's five launches:
the frozen bound of the traced steps' batches (the cull's staged pairs)
over the kernel's device time per step."""

from rnbench import yardstick

LAYER = "match kernel"
UNIT = "%"
MOVES = "train_img_s"
SOURCE = "device_trace"


def read(run):
    per_step = yardstick.kernel_s_per_call(run["trace"], ("match_kernel",))
    c = run["counters"]
    if per_step is None or not c.get("match.cull_per_step"):
        return None
    p = yardstick.peaks(run["device_name"])
    bounds = [yardstick.match_bound_s(c["match.anchors"], c["match.batch"], c["match.max_gt"],
                                      staged, tested, p)[0] for staged, tested in c["match.cull_per_step"]]
    return 100.0 * (sum(bounds) / len(bounds)) / per_step
