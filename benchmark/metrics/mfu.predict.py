"""% of the card's bf16 peak that predict's convolutions and matmuls reach:
the frozen FLOPs of an image at the padded bucket (the trunk's from its
family) times the traced run's predict_img_s, over 989 TFLOP/s. A lower
bound (conv and matmul FLOPs only). None on the CPU."""

from rnbench import yardstick

LAYER = "device"
UNIT = "%"
MOVES = "predict_img_s"
SOURCE = "host_clock"


def read(run):
    p = yardstick.device_peaks(run["device_name"])
    if p is None:
        return None
    h, w = run["bucket"]
    flops = yardstick.detector_flops(h, w, run["family"], run["cfg"]["model"])
    return 100.0 * flops * run["e2e"]["predict_img_s"] / p["bf16_flops"]
