"""% of rank 0's traced window of whole training steps that NCCL's kernels
(DDP's bucketed gradient all-reduce) ran on its card."""

LAYER = "collectives"
UNIT = "%"
MOVES = "train_img_s"
SOURCE = "device_trace"


def read(run):
    t = run["trace"]
    nccl = [s for name, (s, _) in t.get("ops", {}).items() if name.lower().startswith("nccl")]
    if not nccl or not t.get("window_s"):
        return None
    return 100.0 * sum(nccl) / t["window_s"]
