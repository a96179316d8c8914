"""The benchmark's frozen yardstick: peaks, conv FLOPs, the hand-written
kernels' operation and byte counts, and the device's busy union.

Copies of ``pytorch_retinanet_tpu_torch/utils/flops.py`` (without its
``PEAK_TFLOPS`` override) and of ``chip_smoke.py``'s kernel bounds, kept
here so that a change to the program cannot change what it is measured
against. FLOPs count convolution MACs x 2 (batch norm, elementwise and
pooling left out), so a utilization built on them is a lower bound.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

# Published dense peaks of the cards the benchmark knows, by the name that
# torch.cuda.get_device_name gives (lower case, matched as a substring).
PEAKS = (
    ("h100 80gb hbm3", {"bf16_flops": 989e12, "f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}),
    ("h100 sxm", {"bf16_flops": 989e12, "f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}),
)

_DEPTHS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}
TRUNKS = frozenset(_DEPTHS)


def peaks(device_name: str) -> Dict[str, float]:
    """The card's peaks; raises for a card the table lacks."""
    name = device_name.lower()
    for needle, p in PEAKS:
        if needle in name:
            return p
    raise ValueError(f"no published peaks for {device_name!r} in the benchmark's table")


def conv_flops(out_hw, k: int, cin: int, cout: int) -> int:
    return 2 * out_hw[0] * out_hw[1] * k * k * cin * cout


def trunk_flops(h: int, w: int, kind: str) -> int:
    depths = _DEPTHS[kind]
    fl = conv_flops((h // 2, w // 2), 7, 3, 64)
    sh, sw = h // 4, w // 4
    for blocks, width, cin, stride in zip(depths, (64, 128, 256, 512), (64, 256, 512, 1024),
                                          (1, 2, 2, 2)):
        oh, ow = sh // stride, sw // stride
        for b in range(blocks):
            icin = cin if b == 0 else width * 4
            ih, iw = (sh, sw) if b == 0 else (oh, ow)
            fl += conv_flops((ih, iw), 1, icin, width)
            fl += conv_flops((oh, ow), 3, width, width)
            fl += conv_flops((oh, ow), 1, width, width * 4)
            if b == 0:
                fl += conv_flops((oh, ow), 1, icin, width * 4)
        sh, sw = oh, ow
    return fl


def fpn_flops(h: int, w: int, channels: int = 256) -> int:
    fl = 0
    for lh, lw, cin in ((h // 8, w // 8, 512), (h // 16, w // 16, 1024), (h // 32, w // 32, 2048)):
        fl += conv_flops((lh, lw), 1, cin, channels) + conv_flops((lh, lw), 3, channels, channels)
    return fl + conv_flops((h // 64, w // 64), 3, 2048, channels) \
        + conv_flops((h // 128, w // 128), 3, channels, channels)


def head_flops(h: int, w: int, num_classes: int, anchors: int = 9, channels: int = 256) -> int:
    fl = 0
    for s in (8, 16, 32, 64, 128):
        hw = (h // s, w // s)
        fl += 8 * conv_flops(hw, 3, channels, channels)
        fl += conv_flops(hw, 3, channels, anchors * num_classes) + conv_flops(hw, 3, channels, anchors * 4)
    return fl


def detector_flops(h: int, w: int, num_classes: int, kind: str) -> int:
    """Forward conv FLOPs of one image through ResNet-FPN and the head."""
    return trunk_flops(h, w, kind) + fpn_flops(h, w) + head_flops(h, w, num_classes)


def bound_s(bytes_: float, ops: float, ops_per_s: float, hbm: float) -> Tuple[float, str]:
    """The least time the card could take: the larger of bytes over the
    bandwidth and operations over the peak rate."""
    return max((bytes_ / hbm, "bytes"), (ops / ops_per_s, "operations"))


def stem_bound_s(batch: int, h: int, w: int, in_bytes: int, p: Dict[str, float]):
    """The fused stem (7x7/2 conv, normalize, BN, ReLU, 3x3/2 max pool) on a
    [batch, h, w, 3] input of `in_bytes` per element: bf16 tensor-core
    operations against the input read once and the bf16 pooled output
    written once."""
    ops = 2.0 * batch * (h // 2) * (w // 2) * 64 * 147
    out_elems = batch * (h // 4) * (w // 4) * 64
    bytes_ = batch * h * w * 3 * in_bytes + out_elems * 2 + 64 * 147 * 4 + 2 * 64 * 4 + 6 * 4
    return bound_s(bytes_, ops, p["bf16_flops"], p["hbm_bytes_per_s"])


def nms_bound_s(valid_counts: Iterable[float], k: int, p: Dict[str, float]):
    """The NMS kernel on [B, k] candidates: 12 f32 operations per IoU pair
    among each image's valid candidates, against the boxes and masks read
    once and the keep mask written once."""
    counts = list(valid_counts)
    pairs = sum(n * (n - 1) / 2 for n in counts)
    bytes_ = len(counts) * k * (16 + 1 + 1)
    return bound_s(bytes_, pairs * 12, p["f32_flops"], p["hbm_bytes_per_s"])


def match_cull_counts(anchors: torch.Tensor, gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                      block: int = 256) -> Tuple[float, float]:
    """What the match kernel's exact block cull leaves: the (anchor, valid GT
    row) pairs of each 256-anchor block whose bounding box the row overlaps,
    and the (block, valid row) overlap tests."""
    a = anchors.shape[0]
    nb = -(-a // block)
    padded = torch.cat([anchors, anchors[-1:].expand(nb * block - a, 4)]).view(nb, block, 4)
    lo, hi = padded[..., :2].amin(1), padded[..., 2:].amax(1)
    g = gt_boxes[:, None]
    culled = ((g[..., 2] <= lo[None, :, None, 0]) | (g[..., 0] >= hi[None, :, None, 0])
              | (g[..., 3] <= lo[None, :, None, 1]) | (g[..., 1] >= hi[None, :, None, 1]))
    kept = gt_valid[:, None, :] & ~culled
    per_block = torch.full((nb,), block, device=anchors.device)
    per_block[-1] = a - (nb - 1) * block
    return float((kept.sum(-1) * per_block).sum()), float(gt_valid.sum()) * nb


def match_bound_s(n_anchors: int, batch: int, max_gt: int, staged: float, tested: float,
                  p: Dict[str, float]):
    """The match kernel over the levels of one step: anchors and GT read
    once, the matches, labels and targets written once; 12 operations per
    staged IoU pair, 4 per overlap test (``match_cull_counts``), 4 per
    anchor for the blocks' boxes."""
    bytes_ = n_anchors * 16 + batch * max_gt * (16 + 4 + 1) + batch * n_anchors * (4 + 4 + 16)
    ops = staged * 12 + tested * 4 + n_anchors * 4
    return bound_s(bytes_, ops, p["f32_flops"], p["hbm_bytes_per_s"])


def kernel_s_per_call(trace: Dict, names: Iterable[str]):
    """Device seconds per traced call of the kernels in `names`: each
    kernel's mean launch times its launches per call (a whole number, so a
    launch the profiler dropped does not count against the kernel); None
    when none of them was recorded."""
    ops, calls = trace.get("ops", {}), trace.get("calls")
    found = [ops[n] for n in names if n in ops]
    if not found or not calls:
        return None
    return sum(s / n * max(round(n / calls), 1) for s, n in found)


def union_s(spans: Iterable[Tuple[float, float]]) -> float:
    """Seconds covered by the union of (start, end) intervals in seconds."""
    busy, end = 0.0, -float("inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy
