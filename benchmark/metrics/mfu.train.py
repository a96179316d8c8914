"""% of the cards' bf16 peak that a training step's convolutions reach: 3 x
the frozen forward conv FLOPs of an image times the traced run's
train_img_s, over 989 TFLOP/s per card. A lower bound (conv FLOPs only)."""

from rnbench import yardstick

LAYER = "device"
UNIT = "%"
MOVES = "train_img_s"
SOURCE = "host_clock"


def read(run):
    m = run["cfg"]["model"]
    if m["backbone_kind"] not in yardstick.TRUNKS:
        return None
    h, w = run["bucket"]
    flops = 3 * yardstick.detector_flops(h, w, m["num_classes"], m["backbone_kind"])
    peak = yardstick.peaks(run["device_name"])["bf16_flops"] * run["world"]
    return 100.0 * flops * run["e2e"]["train_img_s"] / peak
