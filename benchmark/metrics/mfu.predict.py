"""% of the card's bf16 peak that predict's convolutions reach: the frozen
conv FLOPs of an image at the padded bucket times the traced run's
predict_img_s, over 989 TFLOP/s. A lower bound (conv FLOPs only)."""

from rnbench import yardstick

LAYER = "device"
UNIT = "%"
MOVES = "predict_img_s"
SOURCE = "host_clock"


def read(run):
    m = run["cfg"]["model"]
    if m["backbone_kind"] not in yardstick.TRUNKS:
        return None
    h, w = run["bucket"]
    flops = yardstick.detector_flops(h, w, m["num_classes"], m["backbone_kind"])
    peak = yardstick.peaks(run["device_name"])["bf16_flops"]
    return 100.0 * flops * run["e2e"]["predict_img_s"] / peak
