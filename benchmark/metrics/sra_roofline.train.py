"""% of its roofline the forward's attention cores reach in a training
step: the trunk family's ``attention_bound`` (the 16 cores' FLOPs at the
bf16 peak or their Q, K, V and O bytes at HBM bandwidth, whichever is
larger) for the step's batch at the bucket, over the program's ``pvt.sdpa``
spans' CUDA events summed within a step, the median over the pass's steps
on rank 0 (rnbench/spans.py). None on the CPU, for a family without
attention, and where the program has no such span."""

from rnbench import spans, yardstick

LAYER = "attention core"
UNIT = "%"
MOVES = "train_img_s"
SOURCE = "program_span"


def read(run):
    p = yardstick.device_peaks(run["device_name"])
    bound = getattr(run["family"], "attention_bound", None)
    if p is None or bound is None:
        return None
    ms = spans.median_ms(run, "pvt.sdpa", "device_ms")
    if not ms:
        return None
    h, w = run["bucket"]
    return 100.0 * bound(h, w, run["cfg"]["model"], run["batch"], p)[0] / (ms / 1e3)
