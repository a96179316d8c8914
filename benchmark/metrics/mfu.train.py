"""% of the cards' bf16 peak that a training step's convolutions and matmuls
reach: 3 x the frozen forward FLOPs of an image (the trunk's from its
family) times the traced run's train_img_s, over 989 TFLOP/s per card. A
lower bound (conv and matmul FLOPs only). None on the CPU."""

from rnbench import yardstick

LAYER = "device"
UNIT = "%"
MOVES = "train_img_s"
SOURCE = "host_clock"


def read(run):
    p = yardstick.device_peaks(run["device_name"])
    if p is None:
        return None
    h, w = run["bucket"]
    flops = 3 * yardstick.detector_flops(h, w, run["family"], run["cfg"]["model"])
    return 100.0 * flops * run["e2e"]["train_img_s"] / (p["bf16_flops"] * run["world"])
