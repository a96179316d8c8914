"""Drive the PyTorch port on one CUDA card and hold each kernel to its plain version.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
NVIDIA Hopper card, ``nvcc`` and PyTorch built for CUDA; it never imports JAX
or the JAX package. Phases, each of which fails the run on any fault:

1. build the five kernels (fused stem, NMS, match, fused bottleneck, top-2)
   from ``pytorch_retinanet_tpu_torch/csrc`` (one ``nvcc`` per source, in
   parallel) and print the card's name and power limit;
2. fused stem kernel (normalize inside) against ``stem_plain`` at
   [32, 800, 1344, 3] from uint8 (the predict path's wire format) and f32
   images, and at ragged shapes (a small batch, the portrait bucket, a
   width whose last pooled tile is partial);
3. NMS kernel against ``nms_keep_mask_plain`` on dense synthetic clusters
   at [32, 1000], at K = 63, 65 (partial 64-candidate chunks) and 4096, on
   identical boxes (one long chain) and on disjoint ones (none);
4. the main path: R50-FPN ``Retinanet.predict`` on 32 seeded 800x1333 uint8
   images (the 800x1344 bucket, one uint8 batch), both launch counts read
   around that run alone, the stem launched on uint8; then the NMS kernel
   against its plain version on that run's candidates, the uint8 resize on
   the card against the CPU's bit for bit, and ``predict`` on the card
   against ``predict`` on the CPU at a small size (f32 and resized uint8);
5. times (CUDA events after warm-up): the stem kernel from uint8 and f32 and
   the NMS kernel beside their bounds, plain versions and PyTorch
   yardsticks, and predict img/s at batch 32; for NMS also its two
   kernels' device time from one ``torch.profiler`` window (``device_ms``
   in the ``kernels`` line), with the wrapper's host time per call and the
   registers and spills of its ``-Xptxas -v`` log;
6. match kernel against ``match_targets_plain`` at the training shapes:
   batch 16, the five levels of the 800x1344 bucket, 100 GT rows, seeded GT
   with 0, 1, a few and 100 valid rows and a constructed IoU tie; then at
   P3, blocks that stage no GT row, a first valid row past row 0, a tie
   across a row culled in its block and an image without GT, at the
   detector's thresholds and at ones that show the first valid row;
7. the training path: ``Trainer(max_steps=7).fit`` of an R50-FPN
   ``RetinaNetModel`` (the ``configs/hparams.yaml`` values) on seeded uint8
   batches of 16 at 800x1344; the match launches read around the fit
   alone, finite losses, every parameter moved, BN statistics unchanged;
8. one training step on the card against the same step on the CPU (f32
   resnet18 at 128x192, the card through the match kernel, the CPU through
   the plain composition);
9. times: the match kernel (summed over the five levels, CUDA events;
   device time from the profiler as ``device_ms``, per level too, with the
   host time, the share of (anchor, GT row) pairs the block cull stages and
   the ptxas registers and spills) beside its bound and plain version, the loss
   forward and forward+backward with and without the kernel, the training step's stages, the training step
   (median of 5, host clock), peak memory.

Then the opt-in fused trunk (``apply_detector(use_fused_trunk=True)``) and
the top-2 kernel, on the batch and detector of phase 4:

a. bottleneck kernel against ``bottleneck_plain`` at batch 32 at the three R50
   stage shapes of the 800x1344 bucket, and at small batch at shapes whose H
   and W do not divide the tile the kernel picks, one or more per mid (at
   mid 512 an odd and an even number of tiles along W), b1 drawn in
   [0.5, 1] so that conv2's zero padding matters, rows 0 and H-1 held to the
   same tolerance as the rest; each stage's launch configuration (tile,
   cluster size, CTAs, dynamic shared memory, CTAs per SM) and its
   registers and spills from the ``-Xptxas -v`` log;
b. the gradient through the kernel's ``autograd.Function`` against autograd
   through ``bottleneck_plain``, on a small shape;
c. the fused-trunk forward of R50-FPN at [32, 800, 1344, 3] against the
   module forward: c3/c4/c5 and every head output, within the bf16 depth
   drift; the bottleneck launches read around that one forward (exactly 10);
d. the fused-trunk predict: ``apply_detector(use_fused_trunk=True)`` and
   ``process_detections_multilevel_batch``, as ``Retinanet._predict_impl``
   composes them, every launch count read around it, its detections checked
   as phase 4 checks them;
e. top-2 kernel against ``top2_classes_plain``, exactly, at the five level
   shapes of one 800x1344 image in bf16, on ties, and on phase d's level
   logits reshaped to [32 * A_l, 90];
f. times: the bottleneck kernel per stage and summed over the 10 blocks of a
   forward, beside its bound, its plain version and the port's cuDNN
   ``Bottleneck`` module, with its achieved TFLOP/s (useful work) and the
   weight bytes its CTAs stream through L2; the top-2 kernel at [32 * 151200, 90] beside its
   bound, plain version and ``torch.topk``; the trunk, the forward and the
   predict composition through the fused trunk against the default path.

Then the training engine and live batch norm at full width (R50-FPN, 90
classes, ``configs/hparams.yaml``'s values, seeded uint8 batches of 16 at
800x1344):

10. ``Trainer.fit`` for 2 epochs of 3 steps with a 1-batch validation
    loader, ``checkpoint_dir``, ``EarlyStopping``, ``LearningRateMonitor``,
    the CSV and TensorBoard loggers and the profiler over steps 2-3: match
    launched 5 times per train and validation step (read around this fit),
    ``last/`` and ``best/`` written, the CSV rows and TensorBoard scalars
    equal to the logged metrics, ``hparams.yaml`` (and the PyYAML-free
    block YAML) holding the config, a trace written; the checkpoint's size
    and save and restore seconds; the same run interrupted by SIGTERM from
    its loader as epoch 2 starts: ``fit`` returns with ``interrupt/``
    written, a new ``Trainer(auto_resume=True)`` restores it bit for bit and
    finishes with the uninterrupted run's LRs exactly and its losses within
    ``STEP_LOSS_RTOL``; ``best/`` through ``load_torch_state_dict`` into a
    ``Retinanet`` whose ``predict`` on phase 4's images (score threshold 0)
    launches stem and NMS once each;
11. live BN: 3 ``freeze_bn=False`` steps at batch 16 (finite losses, every
    running buffer moved, ``num_batches_tracked`` 3, 15 match launches);
    one live-BN f32 resnet18 step on the card against the CPU (running
    statistics within ``BN_STATS_TOL``); remat on against off with frozen
    and with live BN (the loss within ``STEP_LOSS_RTOL``, the running
    statistics within ``REMAT_STATS_RTOL``, updated once), with step times
    and peak memory.

The last lines are the ``kernels`` JSON, the ``nvidia-smi`` name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import csv
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_TENSOR_FLOPS = 989e12  # H100 SXM dense bf16
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores

BATCH, H, W = 32, 800, 1344
STEM_TOL = "|kernel - plain| <= 1 bf16 ulp of the larger value + 1e-6"
PREDICT_KERNELS = ("fused_stem", "nms_keep_mask")
# NMS beyond the main path's [32, 1000]: partial 64-candidate chunks and a K
# whose mask rows are 4x the main path's.
NMS_SHAPES = ((2, 63), (2, 65), (1, 4096))
# Ragged stem shapes: a small batch, the portrait bucket, and a width whose
# last 16-wide pooled tile is partial (1000 / 4 = 250 = 15 x 16 + 10).
STEM_RAGGED = ((3, 96, 132), (1, 1344, 800), (2, 128, 1000))
# R50 identity blocks the fused trunk sends to the kernel at 800x1344:
# (H, W, mid, blocks per forward) of layers 2, 3 and 4.
BOTTLENECK_STAGES = ((100, 168, 128, 3), (50, 84, 256, 5), (25, 42, 512, 2))
# The f32 sums run in another order than cuDNN's and flip bf16 roundings of
# y1 and y2; a flip moves an output by a term of the output's scale, not of
# the element's, so the bound adds one bf16 ulp of the largest output.
BOTTLENECK_TOL = ("|kernel - plain| <= 1 bf16 ulp of the element + 1 bf16 ulp of the output's "
                  "largest |value| (2**-8 of it) on every row, >= 90% exactly equal")
# The fused trunk against the module: both round to bf16 after every conv or
# BN, at other points, and one-ulp differences grow through 16 blocks, the
# FPN and the head of a random R50.
TRUNK_DRIFT = 2.0**-4
TOP2_LEVELS = (151200, 37800, 9450, 2457, 693)
MATCH_TOL = "matches, fg_labels and centre targets exact; tw, th within 2 f32 ulp"
TRAIN_BATCH, TRAIN_STEPS, MAX_GT = 16, 7, 100
# configs/hparams.yaml, written out: the card has no yaml.
HPARAMS = {
    "model": {"backbone_kind": "resnet50", "num_classes": 90, "freeze_bn": True,
              "min_size": 800, "max_size": 1333, "pretrained": False},
    "dataloader": {"train_bs": TRAIN_BATCH, "valid_bs": TRAIN_BATCH, "test_bs": TRAIN_BATCH},
    "optimizer": {"class_name": "torch.optim.SGD",
                  "params": {"lr": 0.001, "weight_decay": 0.001, "momentum": 0.9}},
    "scheduler": {"class_name": "torch.optim.lr_scheduler.ReduceLROnPlateau",
                  "params": {"mode": "min", "factor": 0.1, "patience": 5},
                  "interval": "epoch", "frequency": 1, "monitor": "val_loss"},
}
# One step on the card against one on the CPU (f32): the step's loss, and
# each parameter's update (after - before) against that tensor's largest.
# cuDNN's f32 backward algorithms sum (or transform) in another order than
# the CPU's: the largest relative differences show in the FPN's convs.
STEP_LOSS_RTOL, STEP_UPDATE_TOL = 1e-4, 1e-2
# Live BN running mean / var on the card against the CPU, of each tensor's
# largest |value|: the batch statistics sum in another order.
BN_STATS_TOL = 1e-4
# Remat on against off: the running statistics after one live-BN step, relative.
REMAT_STATS_RTOL = 1e-5
# Phases 10-11: epochs of steps at TRAIN_BATCH for the engine.
ENGINE_EPOCHS, ENGINE_STEPS = 2, 3


def log(msg: str) -> None:
    print(msg, flush=True)


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """Spacing of bf16 numbers at |t| (2^(e - 8) for |t| in [2^(e-1), 2^e))."""
    _, e = torch.frexp(t.float().abs())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


def stem_error(out: torch.Tensor, ref: torch.Tensor):
    a, b = out.float(), ref.float()
    diff = (a - b).abs()
    bad = diff > bf16_ulp(torch.maximum(a.abs(), b.abs())) + 1e-6
    return diff.max().item(), int(bad.sum().item())


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_times(fn, iters: int = 10) -> dict:
    """``fn``'s calls back to back after a warm-up, timed twice: without the
    profiler, the CUDA-event ms per call and the host's us per call to
    enqueue them (no synchronize inside); then in one ``torch.profiler``
    window, each CUDA kernel's device us per call, by name, with its
    launches per call. Fails the run if the window recorded no kernel."""
    import re

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_us = (time.perf_counter() - t0) * 1e6 / iters
    end.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        m = re.search(r"(\w+_kernel)\b", e.name)
        name = m.group(1) if m else e.name[:60]
        us, n = kernels.get(name, (0.0, 0))
        kernels[name] = (us + e.time_range.elapsed_us(), n + 1)
    if not kernels:
        raise SystemExit("the profiler recorded no CUDA kernel: device time not measured")
    # The profiler may drop an event of the window: the mean launch times the
    # launches per call (a whole number) stands for the call.
    per_call = {k: max(round(n / iters), 1) for k, (_, n) in kernels.items()}
    return {"kernels": {k: (us / n * per_call[k], per_call[k]) for k, (us, n) in kernels.items()},
            "event_ms": start.elapsed_time(end) / iters, "host_us": host_us}


def device_ms(t: dict) -> float:
    """The device ms per call of ``device_times``' kernels."""
    return sum(us for us, _ in t["kernels"].values()) / 1e3


def log_device_times(what: str, t: dict) -> None:
    log(f"[trace] {what}: device {device_ms(t) * 1e3:.1f} us per call ("
        + ", ".join(f"{k} {us:.1f} us x{n:g}" for k, (us, n) in t["kernels"].items())
        + f"); CUDA events {t['event_ms'] * 1e3:.1f} us per call; host enqueue "
        f"{t['host_us']:.1f} us per call")


def build_report(name: str, functions) -> dict:
    """Kernel function -> (registers, spill store bytes, spill load bytes),
    from the ``-Xptxas -v`` log that ``build.py`` keeps beside the library."""
    import re

    from pytorch_retinanet_tpu_torch.kernels.build import library_path

    report, fn = {}, None
    for line in library_path(name).with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            fn = next((f for f in functions if f in line), None)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn is not None:
            report.setdefault(fn, [None, 0, 0])[1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            report.setdefault(fn, [None, 0, 0])[0] = int(m.group(1))
    return {k: tuple(v) for k, v in report.items()}


def log_build_report(name: str, functions) -> None:
    log(f"[build] {name}.cu: " + "; ".join(
        f"{fn} {regs} registers, {st} B spill stores, {ld} B spill loads"
        for fn, (regs, st, ld) in build_report(name, functions).items()))


def dense_clusters(gen: torch.Generator, batch: int, k: int, device) -> tuple:
    """Score-ordered, class-offset boxes in tight clusters, ~90% valid."""
    centers = torch.rand((batch, k // 20 + 1, 2), generator=gen) * torch.tensor([W, H])
    which = torch.randint(0, centers.shape[1], (batch, k), generator=gen)
    c = torch.gather(centers, 1, which[..., None].expand(-1, -1, 2))
    c = c + torch.randn((batch, k, 2), generator=gen) * 6.0
    wh = 20.0 + torch.rand((batch, k, 2), generator=gen) * 60.0
    boxes = torch.cat([c - wh / 2, c + wh / 2], dim=-1)
    cls = torch.randint(0, 3, (batch, k), generator=gen).float()
    boxes = boxes + (cls * 4097.0)[..., None]
    valid = torch.rand((batch, k), generator=gen) < 0.9
    return boxes.to(device), valid.to(device)


def check_nms_kernel(dev, gen, nms_keep_mask, nms_keep_mask_plain) -> None:
    """Phase 3: clusters at the main path's [32, 1000], partial 64-candidate
    chunks and a larger K, identical boxes (one long chain) and disjoint ones
    (no chain at all), each equal to the plain version."""
    same = torch.tensor([[10.0, 10.0, 50.0, 50.0]], device=dev).expand(2, 500, 4).contiguous()
    i = torch.arange(2000, device=dev, dtype=torch.float32)
    grid = torch.stack([(i % 40) * 30, (i // 40) * 30, (i % 40) * 30 + 20, (i // 40) * 30 + 20], -1)
    cases = [(f"clusters [{b}, {k}]", *dense_clusters(gen, b, k, dev))
             for b, k in ((BATCH, 1000),) + NMS_SHAPES]
    cases += [("identical [2, 500]", same, torch.ones((2, 500), dtype=torch.bool, device=dev)),
              ("disjoint [1, 2000]", grid[None], torch.ones((1, 2000), dtype=torch.bool, device=dev))]
    kept = {}
    for name, boxes, valid in cases:
        keep = nms_keep_mask(boxes, valid, 0.5)
        keep_ref = nms_keep_mask_plain(boxes, valid, 0.5)
        if not torch.equal(keep, keep_ref):
            raise SystemExit(f"nms kernel differs from plain on {name} at "
                             f"{int((keep != keep_ref).sum())} of {keep.numel()} candidates")
        kept[name] = f"{int(keep.sum())} of {int(valid.sum())}"
    if kept["identical [2, 500]"] != "2 of 1000" or kept["disjoint [1, 2000]"] != "2000 of 2000":
        raise SystemExit(f"nms kernel: identical boxes kept or disjoint ones suppressed: {kept}")
    log("[nms] equal to plain, kept of valid: " + ", ".join(f"{k} {v}" for k, v in kept.items()))


def check_detections(preds, score_thres: float = 0.05) -> None:
    """Per image: boxes [n, 4], scores and labels [n], n > 0, finite, labels in
    1..90, scores in (score_thres, 1], boxes inside the 800x1333 image."""
    for p in preds:
        b, s, lab = p["boxes"], p["scores"], p["labels"]
        if not (b.ndim == 2 and b.shape[1] == 4 and len(b) == len(s) == len(lab) > 0):
            raise SystemExit(f"bad detection shapes {b.shape} {s.shape} {lab.shape}")
        if not (np.isfinite(b).all() and np.isfinite(s).all()):
            raise SystemExit("non-finite detections")
        if not ((lab >= 1) & (lab <= 90)).all() or not ((s > score_thres) & (s <= 1)).all():
            raise SystemExit("labels or scores out of range")
        if (b < -1e-3).any() or (b[:, [0, 2]] > 1333 + 1e-2).any() or (b[:, [1, 3]] > 800 + 1e-2).any():
            raise SystemExit("boxes outside the image")


def log_kernel_time(r: dict) -> None:
    device = f", device {r['device_ms']:.4f} ms" if "device_ms" in r else ""
    log(f"[time] {r['name']}: {r['ms']:.4f} ms{device} (plain {r['plain_ms']:.4f}, library "
        f"{r['library_ms']}, bound {r['bound_ms']:.4f} ms by {r['bound_by']})")


def f32_ulp_distance(a: torch.Tensor, b: torch.Tensor) -> int:
    def ordered(x):
        i = x.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def seeded_gt(rng: np.random.Generator, n_valid, h: int, w: int):
    """Padded [B, MAX_GT] boxes, labels and valid rows inside an h x w image."""
    b = len(n_valid)
    ctr = rng.uniform([0, 0], [w, h], (b, MAX_GT, 2))
    wh = rng.uniform(16, 400, (b, MAX_GT, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).clip(0, [w, h, w, h])
    valid = np.arange(MAX_GT)[None] < np.asarray(n_valid)[:, None]
    boxes = np.where(valid[..., None], boxes, 0.0).astype(np.float32)
    labels = np.where(valid, rng.integers(1, 91, (b, MAX_GT)), 0).astype(np.int32)
    return boxes, labels, valid


def seeded_batches(steps: int, batch: int, h: int, w: int, seed: int) -> list:
    """A train loader: `steps` batches of uint8 images and padded GT, made
    from a seed (1-100 boxes per image, the first image of each batch none)."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (batch, h, w, 3), dtype=np.uint8)
    batches = []
    for _ in range(steps):
        n_valid = rng.integers(1, MAX_GT + 1, batch)
        n_valid[0] = 0
        boxes, labels, valid = seeded_gt(rng, n_valid, h, w)
        batches.append({"images": images, "boxes": boxes, "labels": labels, "valid": valid})
    return batches


def match_inputs(anchors_levels, dev) -> list:
    """Phase 6's GT at the training shapes: [16, 100] padded rows with 0, 1,
    3, 100 and seeded counts of valid rows, and a tie under anchor 5000 of
    level 0 (image 3's rows 4 and 5 are that anchor's box; the first must win)."""
    rng = np.random.default_rng(6)
    n_valid = np.concatenate([[0, 1, 3, 100], rng.integers(1, MAX_GT + 1, TRAIN_BATCH - 4)])
    boxes, labels, valid = seeded_gt(rng, n_valid, H, W)
    boxes[3, 4] = boxes[3, 5] = anchors_levels[0][5000].cpu().numpy()
    return [torch.from_numpy(x).to(dev) for x in (boxes, labels, valid)]


def main_path_batch(dev):
    """Phase 4's input: 32 seeded 800x1333 uint8 images, and the padded
    800x1344 batch and sizes that ``predict`` builds from them."""
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (800, 1333, 3), dtype=np.uint8) for _ in range(BATCH)]
    batch = torch.zeros((BATCH, H, W, 3), dtype=torch.uint8, device=dev)
    batch[:, :800, :1333] = torch.from_numpy(np.stack(images)).to(dev)
    sizes = torch.tensor([[800.0, 1333.0]] * BATCH, device=dev)
    return rng, images, batch, sizes


def nms_candidates(net, batch, sizes):
    """The class-offset candidates that ``predict`` hands the NMS kernel."""
    from pytorch_retinanet_tpu_torch.models.retinanet import apply_detector
    from pytorch_retinanet_tpu_torch.ops import merge_candidates, multilevel_candidates

    with torch.inference_mode():
        cls_l, box_l = apply_detector(net.module, batch, return_levels=True)
        cand = multilevel_candidates(cls_l, box_l, net._anchors_for(tuple(batch.shape[1:3])))
        cboxes, _, cidx, cvalid = merge_candidates(*cand, sizes)
    return cboxes + (cidx.float() * 4097.0)[..., None], cvalid


def check_match_kernel(dev, results, match_targets, match_targets_plain, anchors_levels):
    """Phase 6: the kernel against its plain version at the training shapes.
    Returns the inputs, for the timing phase."""
    gt = match_inputs(anchors_levels, dev)
    err = 0.0
    for level, anchors in enumerate(anchors_levels):
        got = match_targets(anchors, *gt)
        want = match_targets_plain(anchors, *gt)
        torch.cuda.synchronize()
        exact = (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                 and torch.equal(got[2][..., :2], want[2][..., :2]))
        ulps = f32_ulp_distance(got[2][..., 2:], want[2][..., 2:])
        if not exact or ulps > 2:
            raise SystemExit(f"match kernel disagrees with plain at level {level}: "
                             f"exact parts equal {exact}, size targets {ulps} ulp")
        err = max(err, float((got[2] - want[2]).abs().max()))
        if level == 0 and int(got[0][3, 5000]) != 4:
            raise SystemExit(f"match kernel tie went to row {int(got[0][3, 5000])}, not 4")
        log(f"[match] level {level}: [{TRAIN_BATCH}, {anchors.shape[0]}] x {MAX_GT} GT rows: "
            f"{MATCH_TOL} ({ulps} ulp); fg {int((got[0] >= 0).sum())}, "
            f"ignored {int((got[0] == -2).sum())}")
    # Blocks that stage no row (their anchors take the first valid row, 5,
    # at IoU 0), a tie across a row culled in the tie's block, an image
    # without GT; at the detector's thresholds and at ones under which the
    # first valid row shows in ``matches``.
    edge = match_edge_case(anchors_levels[0], dev)
    for fg, bg in ((0.5, 0.4), (-0.5, 0.0)):
        got = match_targets(anchors_levels[0], *edge, fg_iou_thr=fg, bg_iou_thr=bg)
        want = match_targets_plain(anchors_levels[0], *edge, fg_iou_thr=fg, bg_iou_thr=bg)
        exact = all(torch.equal(a, b) for a, b in zip(got[:2], want[:2])) and \
            torch.equal(got[2][..., :2], want[2][..., :2])
        if not exact or f32_ulp_distance(got[2][..., 2:], want[2][..., 2:]) > 2 \
                or (got[0][:2, MATCH_TIE_ANCHOR] != 5).any() or (got[0][2] != -2).any() \
                or (fg < 0 and (got[0][0, :256] != 5).any()):
            raise SystemExit(f"match kernel on the edge blocks at thresholds {(fg, bg)} disagrees "
                             f"with plain or puts the tie or the first valid row wrong")
    log(f"[match] edge blocks at P3 [3, {anchors_levels[0].shape[0]}]: blocks that stage no row, "
        f"first valid row 5, a tie across a culled row, no GT; equal at thresholds (0.5, 0.4) "
        f"and (-0.5, 0.0)")
    results["match_targets"]["max_abs_err"] = err
    return gt


# P3 of 800x1344: position row 90, column 84, the first anchor shape.
MATCH_TIE_ANCHOR = 9 * (90 * 168 + 84)


def match_edge_case(anchors: torch.Tensor, dev) -> list:
    """Three images of 12 padded rows: image 0 has rows 5 and 7 valid, both
    the box of MATCH_TIE_ANCHOR near the bottom, so the upper blocks stage no
    row; image 1 adds row 6 in the top corner, culled in the tie's block;
    image 2 has no GT."""
    gt = torch.zeros((3, 12, 4), device=dev)
    gt[:, 5] = gt[:, 7] = anchors[MATCH_TIE_ANCHOR]
    gt[:, 6] = torch.tensor([0.0, 0.0, 2.0, 2.0], device=dev)
    valid = torch.zeros((3, 12), dtype=torch.bool, device=dev)
    valid[0, [5, 7]] = True
    valid[1, 5:8] = True
    gt = torch.where(valid[..., None], gt, torch.zeros_like(gt))
    labels = torch.where(valid, torch.arange(1, 13, device=dev), torch.zeros_like(valid, dtype=torch.long))
    return [gt, labels.to(torch.int32), valid]


def match_cull_counts(anchors: torch.Tensor, gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                      block: int = 256) -> tuple:
    """What the match kernel's block cull leaves to compute (``csrc/match.cu``,
    step 2): the (anchor, valid GT row) pairs it stages, per block of 256
    anchors the valid rows that overlap the block's bounding box; and its
    (block, valid GT row) overlap tests."""
    a = anchors.shape[0]
    nb = -(-a // block)
    padded = torch.cat([anchors, anchors[-1:].expand(nb * block - a, 4)]).view(nb, block, 4)
    lo, hi = padded[..., :2].amin(1), padded[..., 2:].amax(1)  # [nb, 2]
    g = gt_boxes[:, None]  # [B, 1, N, 4]
    culled = ((g[..., 2] <= lo[None, :, None, 0]) | (g[..., 0] >= hi[None, :, None, 0])
              | (g[..., 3] <= lo[None, :, None, 1]) | (g[..., 1] >= hi[None, :, None, 1]))
    kept = gt_valid[:, None, :] & ~culled  # [B, nb, N]
    per_block = torch.full((nb,), block, device=anchors.device)
    per_block[-1] = a - (nb - 1) * block
    return float((kept.sum(-1) * per_block).sum()), float(gt_valid.sum()) * nb


def trace_match(match_targets, anchors_levels, gt) -> dict:
    """The match kernel's device, CUDA-event and host time per level, with the
    share of valid pairs its cull stages, then over the five levels of one
    step; returns the step's ``device_times``."""
    for level, a in enumerate(anchors_levels):
        staged, _ = match_cull_counts(a, gt[0], gt[2])
        share = staged / max(float(gt[2].sum()) * a.shape[0], 1.0)
        log_device_times(f"match_targets level {level} [{TRAIN_BATCH}, {a.shape[0]}], {share:.2%} "
                         f"of the valid (anchor, GT row) pairs staged",
                         device_times(lambda: match_targets(a, *gt), 20))
    step = device_times(lambda: [match_targets(a, *gt) for a in anchors_levels], 20)
    log_device_times("match_targets, the five levels of one step", step)
    return step


def time_loss_arms(dev, anchors_levels, gt, retinanet_loss_levels) -> None:
    """The loss forward and forward+backward on R50 head outputs at batch 16
    (bf16, as the head emits them), with the match kernel and with the
    plain composition, in turns: plain, kernel, kernel, plain."""
    g = torch.Generator().manual_seed(9)
    cls = [(torch.randn((TRAIN_BATCH, a.shape[0], 90), generator=g) * 2 - 4).to(dev, torch.bfloat16)
           .requires_grad_() for a in anchors_levels]
    box = [(torch.randn((TRAIN_BATCH, a.shape[0], 4), generator=g) * 0.3).to(dev, torch.bfloat16)
           .requires_grad_() for a in anchors_levels]

    def fwd(kernel):
        return retinanet_loss_levels(cls, box, anchors_levels, *gt, num_classes=90,
                                     use_match_kernel=kernel)

    def fwd_bwd(kernel):
        for t in cls + box:
            t.grad = None
        out = fwd(kernel)
        (out["classification_loss"] + out["regression_loss"]).backward()

    times = {}
    for kernel in (False, True, True, False):
        for name, fn in (("forward", fwd), ("forward+backward", fwd_bwd)):
            times.setdefault((name, kernel), []).append(time_ms(lambda: fn(kernel), 5))
    for name in ("forward", "forward+backward"):
        k, p = np.mean(times[(name, True)]), np.mean(times[(name, False)])
        log(f"[time] loss {name}, R50 head outputs, batch {TRAIN_BATCH}, 800x1344, 90 classes: "
            f"match kernel {k:.3f} ms, plain composition {p:.3f} ms "
            f"(each the mean of 2 turns: {times[(name, True)]} / {times[(name, False)]})")


def time_train_stages(dev, model, trainer, batch, retinanet_loss_levels) -> None:
    """Where a training step's time goes (CUDA events, after warm-up): the
    upload of the batch, the forward, the loss, the backward, and the
    optimizer step as the whole step on an uploaded batch minus those."""
    net, module = model.net, model.net.module
    on_card = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    images = on_card["images"]
    gt = [on_card[k] for k in ("boxes", "labels", "valid")]
    anchors = net._anchors_for(tuple(images.shape[1:3]))

    def forward():
        return module(images, return_levels=True)

    def forward_loss():
        out = retinanet_loss_levels(*forward(), anchors, *gt, num_classes=net.num_classes)
        return out["classification_loss"] + out["regression_loss"]

    def forward_loss_backward():
        forward_loss().backward()
        module.zero_grad(set_to_none=True)

    t = {"upload": time_ms(lambda: {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}, 5),
         "forward": time_ms(forward, 3), "forward+loss": time_ms(forward_loss, 3),
         "forward+loss+backward": time_ms(forward_loss_backward, 3),
         "step on the card": time_ms(lambda: trainer.train_step(on_card), 3)}
    log(f"[time] train step stages, batch {TRAIN_BATCH}: upload {t['upload']:.2f} ms; forward "
        f"{t['forward']:.2f}; loss {t['forward+loss'] - t['forward']:.2f}; backward "
        f"{t['forward+loss+backward'] - t['forward+loss']:.2f}; optimizer and the rest "
        f"{t['step on the card'] - t['forward+loss+backward']:.2f}; whole step on an uploaded "
        f"batch {t['step on the card']:.2f} ms")


def served_model(RetinaNetModel):
    """The task model serving ``self.loader`` and ``self.val_loader`` (the
    data slice is ROADMAP A8)."""

    class Served(RetinaNetModel):
        loader = val_loader = None

        def prepare_data(self):
            pass

        def train_dataloader(self, shard=0, num_shards=1):
            return self.loader

        def val_dataloader(self, shard=0, num_shards=1):
            return self.val_loader

    return Served


def train_main_path(Model, Trainer, ConfigDict, reset_launch_counts, kernels):
    """Phase 7: R50-FPN Trainer.fit for TRAIN_STEPS steps at 800x1344."""
    model = Model(ConfigDict(HPARAMS))
    model.loader = seeded_batches(TRAIN_STEPS, TRAIN_BATCH, H, W, seed=7)
    module = model.net.module
    params0 = {k: p.detach().clone() for k, p in module.named_parameters()}
    buffers0 = {k: b.clone() for k, b in module.named_buffers()}
    trainer = Trainer(max_steps=TRAIN_STEPS, warmup_steps=500, gradient_clip_val=None,
                      log_every_n_steps=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.time()
    trainer.fit(model)
    torch.cuda.synchronize()
    fit_s = time.time() - t0
    launches = {k.name: k.wrapper.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    meters = trainer.logger_.meters
    losses = meters["loss"].window
    log(f"[train] R50-FPN, 90 classes, {TRAIN_STEPS} steps of {TRAIN_BATCH} x 800x1344 uint8 in "
        f"{fit_s:.1f} s (first step included); launches {launches}")
    log(f"[train] per-step loss {['%.5f' % v for v in losses]}; classification "
        f"{['%.5f' % v for v in meters['classification_loss'].window]}; regression "
        f"{['%.5f' % v for v in meters['regression_loss'].window]}")
    if launches["match_targets"] != 5 * TRAIN_STEPS:
        raise SystemExit(f"training launched match_targets {launches['match_targets']} times, "
                         f"not 5 x {TRAIN_STEPS}")
    if trainer.global_step != TRAIN_STEPS or len(losses) != TRAIN_STEPS \
            or not np.isfinite(losses).all():
        raise SystemExit(f"training ran {trainer.global_step} steps with losses {losses}")
    still = [k for k, p in module.named_parameters() if torch.equal(p.detach(), params0[k])]
    if still:
        raise SystemExit(f"{len(still)} parameters did not change, e.g. {still[:3]}")
    moved = [k for k, b in module.named_buffers() if not torch.equal(b, buffers0[k])]
    if moved:
        raise SystemExit(f"BN statistics changed: {moved[:3]}")
    log(f"[train] all {len(params0)} parameters changed; all {len(buffers0)} BN buffers unchanged; "
        f"peak memory {peak / 2**30:.1f} GiB")
    return model, trainer, launches["match_targets"], peak


def train_card_vs_cpu(Model, Trainer, ConfigDict, freeze_bn: bool = True):
    """Phase 8 (and 11 with live BN): one f32 resnet18 step on the card
    (match kernel) and on the CPU (plain composition) from the same weights
    and batch; with live BN also the running statistics after it."""
    hp = ConfigDict(HPARAMS).merge({
        "model": {"backbone_kind": "resnet18", "min_size": 128, "max_size": 192,
                  "compute_dtype": "float32", "prior": 0.1, "seed": 3, "freeze_bn": freeze_bn},
        "optimizer": {"params": {"lr": 0.01}}})
    rng = np.random.default_rng(8)
    boxes, labels, valid = seeded_gt(rng, [5, 0], 128, 192)
    batch = {"images": rng.random((2, 128, 192, 3), dtype=np.float32), "boxes": boxes,
             "labels": labels, "valid": valid}
    models = {d: Model(hp, device=d) for d in ("cuda", "cpu")}
    models["cpu"].net.load_state_dict({k: v.cpu() for k, v in models["cuda"].net.state_dict().items()})
    before = {k: p.detach().clone() for k, p in models["cpu"].net.module.named_parameters()}
    before_stats = {k: b.clone() for k, b in models["cpu"].net.module.named_buffers()}
    loss, after, stats = {}, {}, {}
    for d, m in models.items():
        m.loader = [batch]
        t = Trainer(max_steps=1, warmup_steps=0, log_every_n_steps=1, num_sanity_val_steps=0)
        t.fit(m)
        loss[d] = t.logger_.meters["loss"].value
        after[d] = {k: p.detach().cpu() for k, p in m.net.module.named_parameters()}
        stats[d] = {k: b.cpu() for k, b in m.net.module.named_buffers() if "running_" in k}
    rel = {}
    for k, p0 in before.items():
        du_card, du_cpu = after["cuda"][k] - p0, after["cpu"][k] - p0
        rel[k] = float((du_card - du_cpu).abs().max()) / max(float(du_cpu.abs().max()), 1e-12)
    worst = sorted(rel, key=rel.get, reverse=True)[:3]
    report = ", ".join(f"{k} {rel[k]:.2e}" for k in worst)
    if abs(loss["cuda"] - loss["cpu"]) > STEP_LOSS_RTOL * abs(loss["cpu"]) \
            or rel[worst[0]] > STEP_UPDATE_TOL:
        raise SystemExit(f"train step card vs CPU: loss {loss['cuda']} vs {loss['cpu']}; update "
                         f"differences of the tensor's largest, worst: {report}")
    what = "frozen BN" if freeze_bn else "live BN"
    log(f"[train] f32 resnet18 128x192 step, {what}, card (match kernel) vs CPU (plain): loss "
        f"{loss['cuda']:.7f} vs {loss['cpu']:.7f} (limit {STEP_LOSS_RTOL} rel); parameter "
        f"updates within {STEP_UPDATE_TOL} of each tensor's largest, worst: {report}")
    if not freeze_bn:
        err = {k: float((v - stats["cpu"][k]).abs().max()) / float(stats["cpu"][k].abs().max())
               for k, v in stats["cuda"].items()}
        worst = max(err, key=err.get)
        if err[worst] > BN_STATS_TOL or any(torch.equal(v, before_stats[k])
                                             for k, v in stats["cpu"].items()):
            raise SystemExit(f"live BN running statistics card vs CPU: worst {worst} "
                             f"{err[worst]:.2e} of the tensor's largest, or a buffer did not move")
        log(f"[train] live BN running mean / var card vs CPU within {BN_STATS_TOL} of each "
            f"tensor's largest, worst {worst} {err[worst]:.2e}; all {len(err)} moved")


def training_phases(dev, results) -> None:
    """Phases 6-9: the match kernel, the training path and their times."""
    from pytorch_retinanet_tpu_torch import KERNELS, ConfigDict, RetinaNetModel, Trainer
    from pytorch_retinanet_tpu_torch.kernels import (
        match_targets, match_targets_plain, reset_launch_counts,
    )
    from pytorch_retinanet_tpu_torch.ops import generate_anchors_per_level, retinanet_loss_levels

    # 6. Match kernel against its plain version at the training shapes.
    anchors_levels = [torch.from_numpy(a).to(dev) for a in generate_anchors_per_level((H, W))]
    match_gt = check_match_kernel(dev, results, match_targets, match_targets_plain, anchors_levels)

    # 7. The training path, and 8. one step on the card against the CPU.
    Model = served_model(RetinaNetModel)
    model, trainer, n_match, train_peak = train_main_path(
        Model, Trainer, ConfigDict, reset_launch_counts, KERNELS)
    results["match_targets"]["launches"] = n_match
    train_card_vs_cpu(Model, Trainer, ConfigDict)

    # 9. Times of the training path.
    mt = results["match_targets"]
    mt["ms"] = time_ms(lambda: [match_targets(a, *match_gt) for a in anchors_levels], 20)
    mt["device_ms"] = device_ms(trace_match(match_targets, anchors_levels, match_gt))
    mt["plain_ms"] = time_ms(lambda: [match_targets_plain(a, *match_gt) for a in anchors_levels], 3)
    mt["library_ms"] = None  # no single PyTorch call computes the match and its targets
    n_anchors = sum(a.shape[0] for a in anchors_levels)
    staged, tested = (sum(c) for c in zip(*(match_cull_counts(a, match_gt[0], match_gt[2])
                                            for a in anchors_levels)))
    match_bytes = (n_anchors * 16 + TRAIN_BATCH * MAX_GT * (16 + 4 + 1)
                   + TRAIN_BATCH * n_anchors * (4 + 4 + 16))
    # What this run's data needs after the block cull: 12 flop per staged
    # IoU pair, 4 compares per (block, valid row) test, 4 min / max per anchor
    # for the blocks' boxes.
    mt["bound_ms"], mt["bound_by"] = max(
        (match_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
        ((staged * 12 + tested * 4 + n_anchors * 4) / F32_FLOPS * 1e3, "operations"),
    )
    log_kernel_time(mt)
    log_build_report("match", ("match_kernel",))
    time_loss_arms(dev, anchors_levels, match_gt, retinanet_loss_levels)
    time_train_stages(dev, model, trainer, model.loader[0], retinanet_loss_levels)
    step_s = []
    for batch in model.loader[:5]:
        torch.cuda.synchronize()
        t0 = time.time()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        step_s.append(time.time() - t0)
    step = float(np.median(step_s))
    log(f"[e2e] train step R50-FPN batch {TRAIN_BATCH} 800x1344 (forward, loss, backward, SGD): "
        f"median {step * 1e3:.1f} ms over 5 -> {TRAIN_BATCH / step:.1f} img/s; peak memory of "
        f"the fit {train_peak / 2**30:.1f} GiB")


class SigtermLoader:
    """A train loader that sends SIGTERM to this process when epoch 2 asks
    for its first batch (the interrupted run of phase 10)."""

    def __init__(self, batches: list):
        self.batches, self.epoch = batches, 0

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self):
        self.epoch += 1
        for i, batch in enumerate(self.batches):
            if self.epoch == 2 and i == 0:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch


def recording(trainer) -> list:
    """Wrap the trainer's steps: each train step appends (lr, loss), each
    eval step ("eval", batch size); the loss read is a host sync."""
    seen = []
    train_step, eval_step = trainer.train_step, trainer.eval_step

    def train(batch):
        lr = trainer.current_lr
        out = train_step(batch)
        seen.append((lr, out["loss"].item()))
        return out

    def evaluate(batch):
        seen.append(("eval", len(batch["images"])))
        return eval_step(batch)

    trainer.train_step, trainer.eval_step = train, evaluate
    return seen


def same_state(a, b, path: str = "") -> list:
    """Where two nested checkpoint states differ (tensors bit for bit)."""
    if torch.is_tensor(a) or torch.is_tensor(b):
        ok = torch.is_tensor(a) and torch.is_tensor(b) and a.dtype == b.dtype \
            and torch.equal(a, b.to(a.device))
        return [] if ok else [path]
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return [f"{path} keys {sorted(set(a) ^ set(b))[:3]}"]
        return [d for k in a for d in same_state(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)) and len(a) == len(b):
        return [d for i, (x, y) in enumerate(zip(a, b)) for d in same_state(x, y, f"{path}/{i}")]
    return [] if a == b else [f"{path}: {a!r} != {b!r}"]


def engine_fit(Model, Trainer, hp, loader, val_loader, **trainer_kw):
    """A Model on `loader`, its Trainer (2 epochs, warmup as phase 7) and
    the recorded steps, not yet fitted."""
    model = Model(hp)
    model.loader, model.val_loader = loader, val_loader
    trainer = Trainer(max_epochs=ENGINE_EPOCHS, warmup_steps=500, log_every_n_steps=1,
                      **trainer_kw)
    return model, trainer, recording(trainer)


def engine_main_path(dev, results, images, work: str) -> None:
    """Phase 10: checkpoints, loggers, profiler, interrupt and resume of an
    R50-FPN fit at full width, then predict from the saved checkpoint."""
    import shutil

    from pytorch_retinanet_tpu_torch import ConfigDict, Retinanet, RetinaNetModel, Trainer
    from pytorch_retinanet_tpu_torch.config import to_block_yaml
    from pytorch_retinanet_tpu_torch.engine import (
        Callback, CSVLogger, EarlyStopping, LearningRateMonitor, TensorBoardLogger,
    )
    from pytorch_retinanet_tpu_torch.engine.tb import read_events
    from pytorch_retinanet_tpu_torch.engine.trainer import CHECKPOINT_FILE
    from pytorch_retinanet_tpu_torch.kernels import KERNELS, reset_launch_counts
    from pytorch_retinanet_tpu_torch.utils import ProfilerHook

    shutil.rmtree(work, ignore_errors=True)
    Model = served_model(RetinaNetModel)
    hp = ConfigDict(HPARAMS)
    batches = seeded_batches(ENGINE_STEPS, TRAIN_BATCH, H, W, seed=10)
    val = seeded_batches(1, TRAIN_BATCH, H, W, seed=11)

    # The uninterrupted run, with every callback and logger attached.
    class Epochs(Callback):
        """Each epoch's metrics as the loggers get them."""

        def __init__(self):
            self.metrics = []

        def on_epoch_end(self, trainer, metrics):
            self.metrics.append(dict(metrics))

    epochs, tb_logger = Epochs(), TensorBoardLogger(os.path.join(work, "logs"), name="tb")
    csv_logger = CSVLogger(os.path.join(work, "logs"), name="csv")
    model, trainer, steps = engine_fit(
        Model, Trainer, hp, batches, val, checkpoint_dir=os.path.join(work, "run"),
        callbacks=[EarlyStopping(patience=5), LearningRateMonitor(), tb_logger, epochs],
        logger=csv_logger, profile_dir=os.path.join(work, "profile"))
    trainer.profiler = ProfilerHook(os.path.join(work, "profile"), start_step=1, num_steps=2)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.time()
    trainer.fit(model)
    torch.cuda.synchronize()
    fit_s = time.time() - t0
    launches = {k.name: k.wrapper.launches for k in KERNELS}
    train = [x for x in steps if x[0] != "eval"]
    n_eval = sum(1 for x in steps if x[0] == "eval")
    log(f"[engine] R50-FPN fit, {ENGINE_EPOCHS} epochs of {ENGINE_STEPS} steps at batch "
        f"{TRAIN_BATCH}, 1-batch validation, checkpoints, EarlyStopping, LearningRateMonitor, "
        f"CSV and TensorBoard loggers, profiler over steps 2-3: {fit_s:.1f} s; {len(train)} "
        f"train and {n_eval} validation steps (sanity check included); launches {launches}")
    log(f"[engine] per-step (lr, loss): {[(lr, round(v, 5)) for lr, v in train]}")
    if len(train) != ENGINE_EPOCHS * ENGINE_STEPS or not np.isfinite([v for _, v in train]).all():
        raise SystemExit(f"the engine fit ran {len(train)} steps: {train}")
    if launches["match_targets"] != 5 * (len(train) + n_eval):
        raise SystemExit(f"match_targets launched {launches['match_targets']} times over "
                         f"{len(train)} train and {n_eval} validation steps, not 5 per step")
    results["match_targets"]["engine_launches"] = launches["match_targets"]
    run = os.path.join(work, "run")
    for name in ("last", "best"):
        if not os.path.isfile(os.path.join(run, name, CHECKPOINT_FILE)):
            raise SystemExit(f"no {name}/ checkpoint in {run}")
    with open(os.path.join(csv_logger.log_dir, "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    (events,) = [os.path.join(tb_logger.log_dir, e) for e in os.listdir(tb_logger.log_dir)
                 if e.startswith("events.out")]
    scalars = [e for e in read_events(events) if e["values"]]
    if len(rows) != ENGINE_EPOCHS or len(scalars) != ENGINE_EPOCHS:
        raise SystemExit(f"{len(rows)} CSV rows and {len(scalars)} TensorBoard events for "
                         f"{ENGINE_EPOCHS} epochs")
    for m, row, ev in zip(epochs.metrics, rows, scalars):
        bad = [k for k, v in m.items() if float(row[k]) != v or ev["values"][k] != np.float32(v)]
        if bad or "val_loss" not in m or "lr" not in m:
            raise SystemExit(f"logged metrics read back differently: {bad} of {sorted(m)}")
    try:
        import yaml
    except ImportError:
        yaml = None
    hparams = open(os.path.join(csv_logger.log_dir, "hparams.yaml")).read()
    own = to_block_yaml(hp.to_dict())  # what to_yaml writes where PyYAML is missing
    if "num_classes: 90" not in hparams or "num_classes: 90" not in own or (
            yaml and not yaml.safe_load(hparams) == yaml.safe_load(own) == hp.to_dict()):
        raise SystemExit("hparams.yaml does not hold the model's config")
    trace = trainer.profiler.trace_path
    if not trace or not os.path.getsize(trace):
        raise SystemExit("the profiler wrote no trace")
    log(f"[engine] last/ and best/ written; {len(rows)} CSV rows and {len(scalars)} TensorBoard "
        f"events read back equal to the logged metrics ({sorted(epochs.metrics[-1])}); "
        f"hparams.yaml written ({'with PyYAML on this machine; the PyYAML-free block YAML loads '
        f'back equal' if yaml else 'without PyYAML on this machine'}); trace "
        f"{os.path.basename(trace)} {os.path.getsize(trace) / 2**20:.1f} MB")

    # Checkpoint size and its save and restore times.
    path = os.path.join(work, "timed")
    torch.cuda.synchronize()
    t0 = time.time()
    trainer.save_checkpoint(path)
    save_s = time.time() - t0
    t0 = time.time()
    trainer.restore_checkpoint(path)
    torch.cuda.synchronize()
    restore_s = time.time() - t0
    size = os.path.getsize(os.path.join(path, CHECKPOINT_FILE))
    log(f"[engine] checkpoint of R50-FPN and its SGD momentum: {size / 1e6:.1f} MB; save "
        f"{save_s:.3f} s, restore {restore_s:.3f} s")
    del model, trainer
    torch.cuda.empty_cache()

    # The interrupted run: SIGTERM from the loader as epoch 2 starts.
    loader = SigtermLoader(batches)
    model, trainer, cut = engine_fit(Model, Trainer, hp, loader, val,
                                     checkpoint_dir=os.path.join(work, "cut"))
    trainer.fit(model)
    interrupt = os.path.join(work, "cut", "interrupt")
    cut = [x for x in cut if x[0] != "eval"]
    if not trainer._interrupted or not os.path.isfile(os.path.join(interrupt, CHECKPOINT_FILE)) \
            or len(cut) != ENGINE_STEPS:
        raise SystemExit(f"SIGTERM in epoch 2: interrupted {trainer._interrupted}, "
                         f"{len(cut)} steps, interrupt/ {os.path.isdir(interrupt)}")
    saved = torch.load(os.path.join(interrupt, CHECKPOINT_FILE), map_location=dev,
                       weights_only=True)
    del model, trainer
    model, resumed, rest = engine_fit(Model, Trainer, hp, batches, val,
                                      checkpoint_dir=os.path.join(work, "cut"), auto_resume=True)
    restored = {}
    restore = resumed.restore_checkpoint

    def restore_and_keep(p):
        # What the restore left in the trainer, written back out by
        # save_checkpoint itself (the restored epoch count as it stands).
        restore(p)
        again = os.path.join(work, "restored")
        resumed.save_checkpoint(again, completed_epochs=resumed.current_epoch)
        restored.update(state=torch.load(os.path.join(again, CHECKPOINT_FILE), map_location=dev,
                                         weights_only=True), path=p)

    resumed.restore_checkpoint = restore_and_keep
    resumed.fit(model)
    got = cut + [x for x in rest if x[0] != "eval"]
    diff = same_state(restored.get("state"), saved)
    if restored.get("path") != interrupt or diff:
        raise SystemExit(f"resume from {restored.get('path')}: restored state differs from "
                         f"the saved one at {diff[:5]}")
    lr_ok = [a[0] for a in got] == [b[0] for b in train]
    loss_err = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(got, train))
    if len(got) != len(train) or not lr_ok or loss_err > STEP_LOSS_RTOL:
        raise SystemExit(f"interrupted + resumed steps {got} against the uninterrupted {train}")
    log(f"[engine] SIGTERM from the loader as epoch 2 started: fit returned after "
        f"{len(cut)} steps with interrupt/ written; a new Trainer(auto_resume=True) restored "
        f"it bit for bit (parameters, buffers, momentum, epoch {saved['epoch']}, global_step "
        f"{saved['global_step']}, sched_lr, scheduler) and ran {len(got) - len(cut)} steps: "
        f"LRs equal to the uninterrupted run's, losses within {loss_err:.2e} relative "
        f"(limit {STEP_LOSS_RTOL})")
    del model, resumed
    torch.cuda.empty_cache()

    # The best/ checkpoint back into predict. Six steps from the 0.01 prior
    # leave every score below the 0.05 threshold: threshold 0 gives NMS its
    # full 1000 candidates per image.
    net = Retinanet(**hp.model, seed=5, score_thres=0.0)
    net.load_torch_state_dict(torch.load(os.path.join(run, "best", CHECKPOINT_FILE),
                                         map_location="cpu", weights_only=True)["module"])
    net.predict(images[:2])  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    preds = net.predict(images)
    launches = {k.name: k.wrapper.launches for k in KERNELS}
    if launches["fused_stem"] != 1 or launches["nms_keep_mask"] != 1:
        raise SystemExit(f"predict from best/ launched {launches}, not stem and NMS once each")
    check_detections(preds, score_thres=0.0)
    log(f"[engine] best/ loaded through load_torch_state_dict into a Retinanet: predict on "
        f"phase 4's 32 images (score threshold 0) launched {launches}; detections per image "
        f"{[len(p['scores']) for p in preds[:8]]} ...")
    del net
    torch.cuda.empty_cache()


def remat_arm(Model, Trainer, hp, batch) -> dict:
    """One step of a fresh model on `batch`, then 3 more timed (host
    clock around a synchronize); the step's loss, the running statistics
    after it, the median step ms and the peak memory."""
    model = Model(hp)
    model.loader = [batch]
    trainer = Trainer(max_steps=1, warmup_steps=0, log_every_n_steps=1, num_sanity_val_steps=0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer.fit(model)
    out = {"loss": trainer.logger_.meters["loss"].value,
           "stats": {k: b.clone() for k, b in model.net.module.named_buffers()}}
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    out["ms"] = float(np.median(times)) * 1e3
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def live_bn_phases(dev) -> None:
    """Phase 11: live BN at full width, one live-BN step card against CPU,
    and remat on against off with frozen and with live BN."""
    from pytorch_retinanet_tpu_torch import ConfigDict, RetinaNetModel, Trainer
    from pytorch_retinanet_tpu_torch.kernels import KERNELS, reset_launch_counts

    Model = served_model(RetinaNetModel)
    live = ConfigDict(HPARAMS).merge({"model": {"freeze_bn": False}})
    model = Model(live)
    model.loader = seeded_batches(ENGINE_STEPS, TRAIN_BATCH, H, W, seed=12)
    module = model.net.module
    before = {k: b.clone() for k, b in module.named_buffers()}
    trainer = Trainer(max_steps=ENGINE_STEPS, warmup_steps=500, log_every_n_steps=1)
    torch.cuda.synchronize()
    reset_launch_counts()
    trainer.fit(model)
    torch.cuda.synchronize()
    launches = {k.name: k.wrapper.launches for k in KERNELS}
    losses = trainer.logger_.meters["loss"].window
    still = [k for k, b in module.named_buffers()
             if "running_" in k and torch.equal(b, before[k])]
    counts = {int(b) for k, b in module.named_buffers() if k.endswith("num_batches_tracked")}
    if len(losses) != ENGINE_STEPS or not np.isfinite(losses).all() or still \
            or counts != {ENGINE_STEPS} or launches["match_targets"] != 5 * ENGINE_STEPS:
        raise SystemExit(f"live BN fit: losses {losses}, unmoved buffers {still[:3]}, "
                         f"num_batches_tracked {counts}, launches {launches}")
    n_bn = sum(1 for k in before if k.endswith("num_batches_tracked"))
    log(f"[live-bn] R50-FPN freeze_bn=False, {ENGINE_STEPS} steps at batch {TRAIN_BATCH}: losses "
        f"{['%.5f' % v for v in losses]}; all {2 * n_bn} running buffers moved, each of the "
        f"{n_bn} num_batches_tracked is {ENGINE_STEPS}; launches {launches}")
    batch = model.loader[0]
    del model, trainer, module
    torch.cuda.empty_cache()

    train_card_vs_cpu(Model, Trainer, ConfigDict, freeze_bn=False)

    arms = {}
    for freeze_bn in (True, False):
        for remat in (False, True):
            hp = ConfigDict(HPARAMS).merge({"model": {"freeze_bn": freeze_bn, "remat": remat}})
            arms[freeze_bn, remat] = remat_arm(Model, Trainer, hp, batch)
            torch.cuda.empty_cache()
    for freeze_bn in (True, False):
        off, on = arms[freeze_bn, False], arms[freeze_bn, True]
        what = "frozen BN" if freeze_bn else "live BN"
        loss_err = abs(on["loss"] - off["loss"]) / abs(off["loss"])
        stats_err = max(float(((on["stats"][k] - v).abs() / v.abs().clamp_min(1e-12)).max())
                        for k, v in off["stats"].items() if "running_" in k)
        tracked = {int(v) for k, v in on["stats"].items() if k.endswith("num_batches_tracked")}
        if loss_err > STEP_LOSS_RTOL or stats_err > REMAT_STATS_RTOL \
                or tracked != {0 if freeze_bn else 1}:
            raise SystemExit(f"remat vs not, {what}: loss {on['loss']} vs {off['loss']}, "
                             f"running statistics {stats_err:.2e} relative, "
                             f"num_batches_tracked {tracked}")
        log(f"[remat] {what}, batch {TRAIN_BATCH} 800x1344, one step on against off: loss "
            f"{on['loss']:.6f} vs {off['loss']:.6f} ({loss_err:.2e} rel, limit {STEP_LOSS_RTOL}); "
            f"running statistics within {stats_err:.2e} relative (limit {REMAT_STATS_RTOL}), "
            f"num_batches_tracked {sorted(tracked)}; step {on['ms']:.1f} vs {off['ms']:.1f} ms "
            f"(median of 3, host clock); peak memory {on['peak_gib']:.2f} vs "
            f"{off['peak_gib']:.2f} GiB")
    log(f"[time] train step R50-FPN batch {TRAIN_BATCH}, live BN {arms[False, False]['ms']:.1f} "
        f"ms against frozen {arms[True, False]['ms']:.1f} ms (median of 3, host clock)")


def bottleneck_case(dev, b: int, h: int, w: int, mid: int, seed: int) -> list:
    """Seeded block inputs on the card: x [b, h, w, 4 mid] bf16, GEMM-layout
    bf16 weights, folded BN with b1 in [0.5, 1]."""
    g = torch.Generator(device=dev).manual_seed(seed)
    c = 4 * mid

    def u(lo, hi, n):
        return lo + (hi - lo) * torch.rand(n, generator=g, device=dev)

    def wt(*shape):
        return (torch.randn(shape, generator=g, device=dev) * 0.05).to(torch.bfloat16)

    x = torch.randn((b, h, w, c), generator=g, device=dev).to(torch.bfloat16)
    return [x, wt(c, mid), u(0.5, 1.5, mid), u(0.5, 1.0, mid), wt(9, mid, mid), u(0.5, 1.5, mid),
            u(-0.2, 0.2, mid), wt(mid, c), u(0.5, 1.5, c), u(-0.2, 0.2, c)]


def bottleneck_error(got: torch.Tensor, want: torch.Tensor):
    """(max |diff|, per-row excess over BOTTLENECK_TOL, share exactly equal)."""
    a, b = got.float(), want.float()
    diff = (a - b).abs()
    tol = bf16_ulp(torch.maximum(a.abs(), b.abs())) + 2.0**-8 * b.abs().max()
    excess = (diff - tol).amax(dim=(0, 2, 3))
    return diff.max().item(), excess, (diff == 0).float().mean().item()


def cudnn_block(args, dev):
    """The port's cuDNN ``Bottleneck`` module holding the same weights and BN
    (weight = s, bias = b, mean 0, var 1 - eps): the library yardstick."""
    from pytorch_retinanet_tpu_torch.models.backbone import Bottleneck

    _, w1, s1, b1, w2, s2, b2, w3, s3, b3 = args
    c, mid = w1.shape
    block = Bottleneck(c, mid)
    with torch.no_grad():
        block.conv1.weight.copy_(w1.float().t().reshape(mid, c, 1, 1))
        block.conv2.weight.copy_(w2.float().reshape(3, 3, mid, mid).permute(3, 2, 0, 1))
        block.conv3.weight.copy_(w3.float().t().reshape(c, mid, 1, 1))
        for bn, s, b in ((block.bn1, s1, b1), (block.bn2, s2, b2), (block.bn3, s3, b3)):
            bn.weight.copy_(s)
            bn.bias.copy_(b)
            bn.running_var.fill_(1.0 - bn.eps)
    return block.to(dev, memory_format=torch.channels_last).eval()


# Shapes whose H and W do not divide the kernel's tile (10x12 at mid 128 and
# 256, 5x12 at mid 512): (batch, H, W, mid). At mid 512, 29 columns make 3
# tiles along W and 40 make 4 (an odd and an even count along the dimension a
# CTA cluster would pair).
BOTTLENECK_RAGGED = ((4, 13, 21, 128), (2, 23, 29, 128), (2, 17, 31, 256), (2, 11, 29, 512),
                     (2, 12, 40, 512))


def bottleneck_build_report() -> dict:
    """mid -> (registers, spill store bytes, spill load bytes) of each kernel
    instance, from the ``-Xptxas -v`` log."""
    mids = (128, 256, 512)
    report = build_report("bottleneck", [f"bottleneck_kernelILi{mid}E" for mid in mids])
    return {mid: report[f"bottleneck_kernelILi{mid}E"] for mid in mids
            if f"bottleneck_kernelILi{mid}E" in report}


def log_bottleneck_config(shape, bottleneck_launch_config, registers) -> dict:
    b, h, w, mid = shape
    cfg = bottleneck_launch_config(mid, h, w, b)
    regs, st, ld = registers.get(mid, (None, None, None))
    log(f"[bottleneck] launch at [{b}, {h}, {w}, {4 * mid}] mid {mid}: tile {cfg['tile_h']}x"
        f"{cfg['tile_w']}, cluster {cfg['cluster']}, {cfg['ctas']} CTAs of {cfg['threads']} threads, "
        f"{cfg['smem_bytes']} B dynamic shared memory ({cfg['slots']} ring slots of "
        f"{cfg['slot_bytes']} B), {cfg['ctas_per_sm']} CTA(s) per SM; {regs} registers at launch, "
        f"{st} B spill stores, {ld} B spill loads")
    return cfg


def check_bottleneck_kernel(dev, results, fused_bottleneck, bottleneck_plain) -> list:
    """Phase a: the kernel against its plain version at the stage shapes of
    batch 32 and ragged ones. Returns the stage inputs, for the times."""
    from pytorch_retinanet_tpu_torch.kernels import bottleneck_launch_config

    registers = bottleneck_build_report()
    stage_args, err = [], 0.0
    shapes = [(BATCH, h, w, mid) for h, w, mid, _ in BOTTLENECK_STAGES] + list(BOTTLENECK_RAGGED)
    for i, (b, h, w, mid) in enumerate(shapes):
        if b == BATCH:
            log_bottleneck_config((b, h, w, mid), bottleneck_launch_config, registers)
        args = bottleneck_case(dev, b, h, w, mid, seed=10 + i)
        got = fused_bottleneck(*args)
        want = bottleneck_plain(*args)
        torch.cuda.synchronize()
        e, excess, equal = bottleneck_error(got, want)
        border = max(excess[0].item(), excess[-1].item())
        log(f"[bottleneck] [{b}, {h}, {w}, {4 * mid}] mid {mid}: max |diff| {e:.4g}, worst row "
            f"excess over the tolerance {excess.max().item():.3g} (rows 0 and H-1: {border:.3g}), "
            f"{equal:.4f} exactly equal ({BOTTLENECK_TOL})")
        if got.shape != want.shape or got.dtype != torch.bfloat16 or (excess > 0).any() \
                or equal < 0.9:
            raise SystemExit(f"bottleneck kernel disagrees with its plain version at {(b, h, w, mid)}")
        err = max(err, e)
        if b == BATCH:
            stage_args.append(args)
        del got, want
    results["fused_bottleneck"]["max_abs_err"] = err

    # b. The gradient through the autograd.Function against plain autograd.
    args = bottleneck_case(dev, 2, 12, 20, 128, seed=20)
    args = [t if i == 0 else t.float() for i, t in enumerate(args)]
    ker = [t.clone().requires_grad_(True) for t in args]
    ref = [t.clone().requires_grad_(True) for t in args]
    cot = torch.randn(args[0].shape, device=dev)
    # Both backwards recompute through the plain version; deterministic cuDNN
    # algorithms keep the comparison about the autograd wiring.
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        (fused_bottleneck(*ker).float() * cot).sum().backward()
        (bottleneck_plain(*ref).float() * cot).sum().backward()
    worst = max(((a.grad - b.grad).abs().max() / b.grad.abs().max()).item() for a, b in zip(ker, ref))
    if worst > 1e-3:
        raise SystemExit(f"bottleneck gradient through the kernel differs by {worst:.3g} of the largest")
    log(f"[bottleneck] gradient of x and the nine parameters through the kernel's autograd.Function "
        f"equals plain autograd within {worst:.3g} of each gradient's largest (limit 1e-3: the "
        f"backward recomputes through the plain version, where cuDNN may sum in another order)")
    return stage_args


def time_bottleneck_stages(dev, stage_args, fused_bottleneck, bottleneck_plain) -> dict:
    """Per R50 stage at batch 32: the kernel (through its wrapper, weight
    packing included), the weight packing alone, the plain version and the
    port's cuDNN ``Bottleneck`` module, beside the bound, the achieved
    TFLOP/s of useful work and the weight bytes the CTAs stream through L2.
    Returns the sums over the 10 blocks of a forward."""
    from pytorch_retinanet_tpu_torch.kernels import (
        bottleneck_launch_config, pack_bottleneck_weights,
    )

    tot = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms", "ops_ms"), 0.0)
    for (h, w, mid, blocks), args in zip(BOTTLENECK_STAGES, stage_args):
        c = 4 * mid
        block = cudnn_block(args, dev)
        x_nchw = args[0].permute(0, 3, 1, 2)
        with torch.inference_mode():
            t = {"ms": time_ms(lambda: fused_bottleneck(*args), 10),
                 "plain_ms": time_ms(lambda: bottleneck_plain(*args), 3),
                 "library_ms": time_ms(lambda: block(x_nchw), 10)}
            pack_ms = time_ms(lambda: pack_bottleneck_weights(args[1], args[4], args[7]), 10)
        weights = (2 * c * mid + 9 * mid * mid) * 2 + (2 * mid + 2 * mid + 2 * c) * 4
        flops = 2.0 * BATCH * h * w * (2 * c * mid + 9 * mid * mid)
        t["bytes_ms"] = (2 * args[0].numel() * 2 + weights) / HBM_BYTES_PER_S * 1e3
        t["ops_ms"] = flops / BF16_TENSOR_FLOPS * 1e3
        t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
        ctas = bottleneck_launch_config(mid, h, w, BATCH)["ctas"]
        l2_gb = ctas * 34 * mid * mid / 1e9
        log(f"[time] bottleneck [{BATCH}, {h}, {w}, {c}] mid {mid}: kernel {t['ms']:.4f} ms "
            f"({flops / t['ms'] / 1e9:.1f} TFLOP/s of useful work, {ctas} CTAs stream "
            f"{l2_gb:.2f} GB of weights through L2; weight packing alone {pack_ms:.4f} ms), plain "
            f"{t['plain_ms']:.4f}, cuDNN Bottleneck module {t['library_ms']:.4f}, bound "
            f"{t['bound_ms']:.4f} ms (bytes {t['bytes_ms']:.4f}, operations {t['ops_ms']:.4f}); "
            f"{blocks} per forward")
        for k in tot:
            tot[k] += blocks * t[k]
        del block
    return tot


def fused_predict(net, images, sizes, apply_detector, process_detections_multilevel_batch):
    """``Retinanet._predict_impl`` through the opt-in fused trunk."""
    cls_l, box_l = apply_detector(net.module, images, return_levels=True, use_fused_trunk=True)
    det = process_detections_multilevel_batch(
        cls_l, box_l, net._anchors_for(tuple(images.shape[1:3])), sizes,
        score_thres=net.score_thres, nms_thres=net.nms_thres, max_detections=net.max_detections)
    return det, cls_l


def fused_trunk_phases(dev, results, net, batch, sizes) -> None:
    """Phases a-f: the fused bottleneck and top-2 kernels, the fused trunk."""
    from pytorch_retinanet_tpu_torch import KERNELS
    from pytorch_retinanet_tpu_torch.kernels import (
        bottleneck_args, bottleneck_plain, fused_bottleneck, reset_launch_counts, stem_forward,
        top2_classes, top2_classes_plain,
    )
    from pytorch_retinanet_tpu_torch.models import apply_detector, apply_trunk_fused, stem_constants
    from pytorch_retinanet_tpu_torch.ops import process_detections_multilevel_batch

    stage_args = check_bottleneck_kernel(dev, results, fused_bottleneck, bottleneck_plain)

    # c. The fused-trunk forward against the module forward, one batch of 32.
    module = net.module
    resnet = module.backbone.backbone
    with torch.inference_mode():
        scale, shift = resnet.bn1.folded()
        stem = stem_forward(batch, *stem_constants(module, batch.dtype), resnet.conv1.weight,
                            scale, shift)
        module_feats = resnet(None, stem.permute(0, 3, 1, 2))
        module_out = apply_detector(module, batch, return_levels=True)
        torch.cuda.synchronize()
        reset_launch_counts()
        fused_out = apply_detector(module, batch, return_levels=True, use_fused_trunk=True)
        torch.cuda.synchronize()
        n_forward = fused_bottleneck.launches
        fused_feats = apply_trunk_fused(resnet, stem, module.backbone_kind)
    if n_forward != 10:
        raise SystemExit(f"the fused-trunk forward launched the bottleneck kernel {n_forward} times, "
                         f"not 10")
    drift = {}
    pairs = [(k, fused_feats[k], module_feats[k]) for k in ("c3", "c4", "c5")]
    pairs += [(f"{kind} P{lvl + 3}", a, b) for kind, i in (("logits", 0), ("deltas", 1))
              for lvl, (a, b) in enumerate(zip(fused_out[i], module_out[i]))]
    for name, a, b in pairs:
        a, b = a.float(), b.float()
        if not torch.isfinite(a).all():
            raise SystemExit(f"fused trunk: non-finite {name}")
        drift[name] = ((a - b).abs().max() / b.abs().max()).item()
    log(f"[trunk] R50-FPN {list(batch.shape)}, fused trunk vs module: 10 bottleneck launches in one "
        f"forward; |fused - module| / max|module|: "
        + ", ".join(f"{k} {v:.3g}" for k, v in drift.items()) + f" (limit {TRUNK_DRIFT})")
    if max(drift.values()) > TRUNK_DRIFT:
        raise SystemExit("fused trunk drifts from the module forward beyond the bf16 depth drift")
    del module_feats, fused_feats, module_out, fused_out

    # d. The fused-trunk predict, the counted main path of this slice.
    torch.cuda.synchronize()
    reset_launch_counts()
    with torch.inference_mode():
        det, cls_l = fused_predict(net, batch, sizes, apply_detector,
                                   process_detections_multilevel_batch)
    torch.cuda.synchronize()
    launches = {k.name: k.wrapper.launches for k in KERNELS}
    log(f"[fused predict] R50-FPN batch {BATCH} through the fused trunk: launches {launches}")
    for name in ("fused_stem", "fused_bottleneck", "nms_keep_mask"):
        if launches[name] < 1:
            raise SystemExit(f"the fused-trunk predict never launched {name}")
    results["fused_bottleneck"]["launches"] = launches["fused_bottleneck"]
    results["top2_classes"]["launches"] = launches["top2_classes"]  # off every path: 0
    boxes, scores, labels, valid = (t.cpu().numpy() for t in det)
    preds = [{"boxes": boxes[i][valid[i]], "scores": scores[i][valid[i]],
              "labels": labels[i][valid[i]]} for i in range(BATCH)]
    check_detections(preds)
    log(f"[fused predict] detections per image: {[len(p['scores']) for p in preds[:8]]} ...")

    # e. The top-2 kernel against its plain version, exactly.
    g = torch.Generator(device=dev).manual_seed(30)
    cases = [(f"level [{a}, 90]", (torch.randn((a, 90), generator=g, device=dev) * 2 - 4)
              .to(torch.bfloat16)) for a in TOP2_LEVELS]
    tie = torch.zeros((4096, 90), dtype=torch.bfloat16, device=dev)
    tie[:, 7] = tie[:, 50] = tie[::3, 2] = 3.0
    cases.append(("ties [4096, 90]", tie))
    cases += [(f"fused predict P{lvl + 3} logits {tuple(c.reshape(-1, 90).shape)}", c.reshape(-1, 90))
              for lvl, c in enumerate(cls_l)]
    for name, logits in cases:
        got, want = top2_classes(logits), top2_classes_plain(logits)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise SystemExit(f"top-2 kernel differs from plain on {name}")
    if not ((got[1] != got[3]).all() and (got[0] >= got[2]).all()):
        raise SystemExit("top-2 kernel: the two classes of a row coincide or are out of order")
    log(f"[top2] kernel equals plain exactly on {', '.join(n for n, _ in cases)}")
    results["top2_classes"]["max_abs_err"] = 0.0
    del det, cls_l, cases

    # f. Times.
    bt = results["fused_bottleneck"]
    tot = time_bottleneck_stages(dev, stage_args, fused_bottleneck, bottleneck_plain)
    bt.update({k: tot[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")})
    bt["bound_by"] = "operations" if tot["ops_ms"] >= tot["bytes_ms"] else "bytes"
    log("[time] fused_bottleneck, the 10 blocks of one forward summed:")
    log_kernel_time(bt)
    del stage_args

    tp = results["top2_classes"]
    a = BATCH * TOP2_LEVELS[0]
    logits = (torch.randn((a, 90), generator=g, device=dev) * 2 - 4).to(torch.bfloat16)
    tp["ms"] = time_ms(lambda: top2_classes(logits), 20)
    tp["plain_ms"] = time_ms(lambda: top2_classes_plain(logits), 3)
    tp["library_ms"] = time_ms(lambda: torch.topk(logits, 2, dim=1), 10)
    tp["bound_ms"], tp["bound_by"] = max(
        ((logits.numel() * 2 + a * 16) / HBM_BYTES_PER_S * 1e3, "bytes"),
        (2.0 * logits.numel() / F32_FLOPS * 1e3, "operations"),  # two compare scans
    )
    log(f"[time] top2_classes at [{a}, 90] bf16 (P3 of 32 images):")
    log_kernel_time(tp)
    del logits

    # The trunk, the forward and the predict composition, fused trunk against
    # the default path, in turns: default, fused, fused, default.
    with torch.inference_mode():
        stem_nchw = stem.permute(0, 3, 1, 2)
        arms = {
            "trunk": (lambda: resnet(None, stem_nchw),
                      lambda: apply_trunk_fused(resnet, stem, module.backbone_kind)),
            "forward": (lambda: apply_detector(module, batch, return_levels=True),
                        lambda: apply_detector(module, batch, return_levels=True,
                                               use_fused_trunk=True)),
            "predict composition": (
                lambda: net._predict_impl(batch, sizes),
                lambda: fused_predict(net, batch, sizes, apply_detector,
                                      process_detections_multilevel_batch)),
        }
        for name, (default, fused) in arms.items():
            d1, f1, f2, d2 = (time_ms(fn, 5) for fn in (default, fused, fused, default))
            d, f = (d1 + d2) / 2, (f1 + f2) / 2
            extra = (f" -> {BATCH / d * 1e3:.1f} vs {BATCH / f * 1e3:.1f} img/s"
                     if name == "predict composition" else "")
            log(f"[time] {name}, batch {BATCH}, {H}x{W}: default {d:.3f} ms ({d1:.3f}, {d2:.3f}), "
                f"fused trunk {f:.3f} ms ({f1:.3f}, {f2:.3f}){extra}")
            if name == "trunk":
                fused_blocks = [blk for stage, depth in ((2, 4), (3, 6), (4, 3))
                                for blk in list(getattr(resnet, f"layer{stage}"))[1:depth]]
                prep = time_ms(lambda: [bottleneck_args(blk) for blk in fused_blocks], 5)
                log(f"[time] fused trunk, batch {BATCH}: the 10 kernel launches {tot['ms']:.3f} ms "
                    f"(from the per-stage times), their arguments (BN fold, bf16 GEMM-layout "
                    f"weights) {prep:.3f} ms, the 6 blocks left to cuDNN {f - tot['ms'] - prep:.3f} "
                    f"ms (their module blocks {d - tot['library_ms']:.3f} ms)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pytorch_retinanet_tpu_torch import KERNELS
    from pytorch_retinanet_tpu_torch.config import MEAN, STD
    from pytorch_retinanet_tpu_torch.kernels import (
        nms_keep_mask, nms_keep_mask_plain, reset_launch_counts, stem_forward, stem_plain,
    )
    from pytorch_retinanet_tpu_torch.kernels.build import build
    from pytorch_retinanet_tpu_torch.models.retinanet import (
        Retinanet, apply_detector, resize_for_bucket,
    )

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 1. Build.
    t0 = time.time()
    libs = build(["stem", "nms", "match", "bottleneck", "top2"])
    log(f"[build] {len(libs)} kernels built in {time.time() - t0:.1f} s")
    for name, path in libs.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    results = {k.name: {"name": k.name, "route": k.route, "source": k.source,
                        "replaces": k.replaces} for k in KERNELS}
    gen = torch.Generator().manual_seed(0)

    # 2. Stem kernel against its plain version: the main-path shape from
    # uint8 and from f32, then ragged shapes.
    w = (torch.randn((64, 3, 7, 7), generator=gen) * (2.0 / (64 * 49)) ** 0.5).to(dev)
    scale = (0.5 + torch.rand(64, generator=gen)).to(dev)
    bias = (torch.randn(64, generator=gen) * 0.3).to(dev)
    mean8, std8 = tuple(m * 255.0 for m in MEAN), tuple(s * 255.0 for s in STD)
    stem_in = {}
    err = 0.0
    for b, h, wd in [(BATCH, H, W)] + list(STEM_RAGGED):
        raw = torch.randint(0, 256, (b, h, wd, 3), generator=gen, dtype=torch.uint8).to(dev)
        for x, mean, std in ((raw, mean8, std8), (raw.float() / 255.0, MEAN, STD)):
            out = stem_forward(x, mean, std, w, scale, bias)
            ref = stem_plain(x, mean, std, w, scale, bias)
            torch.cuda.synchronize()
            e, n_bad = stem_error(out, ref)
            log(f"[stem] kernel vs plain at {tuple(x.shape)} {x.dtype}: max |diff| {e:.3g}, "
                f"{n_bad} of {out.numel()} outside {STEM_TOL}")
            if out.shape != (b, h // 4, wd // 4, 64) or out.dtype != torch.bfloat16 or n_bad:
                raise SystemExit("stem kernel disagrees with its plain version")
            err = max(err, e)
            if b == BATCH:
                stem_in[x.dtype] = (x, mean, std)
            del out, ref
    results["fused_stem"]["max_abs_err"] = err

    # 3. NMS kernel against its plain version on dense clusters and edge cases.
    check_nms_kernel(dev, gen, nms_keep_mask, nms_keep_mask_plain)

    # 4. Main path.
    rng, images, batch, sizes = main_path_batch(dev)
    net = Retinanet(backbone_kind="resnet50", num_classes=90, pretrained=False, prior=0.5,
                    seed=0)
    net.predict(images[:2])  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.time()
    preds = net.predict(images)
    first_s = time.time() - t0
    launches = {k.name: k.wrapper.launches for k in KERNELS}
    log(f"[predict] R50-FPN, 90 classes, 32 x 800x1333 -> bucket 800x1344 in {first_s:.3f} s; "
        f"launches {launches}")
    for name in PREDICT_KERNELS:
        if launches[name] < 1:
            raise SystemExit(f"predict never launched {name}")
        results[name]["launches"] = launches[name]
    if launches["fused_stem"] != 1 or stem_forward.last_dtype != torch.uint8:
        raise SystemExit(f"predict of one batch launched fused_stem {launches['fused_stem']} "
                         f"times, last on {stem_forward.last_dtype}, not once on uint8")
    log("[predict] the one 800x1344 batch went through fused_stem as uint8")
    check_detections(preds)
    log(f"[predict] detections per image: {[len(p['scores']) for p in preds[:8]]} ...")

    # The same batch's NMS input, rebuilt outside the counted run.
    offset_boxes, cvalid = nms_candidates(net, batch, sizes)
    with torch.inference_mode():
        keep = nms_keep_mask(offset_boxes, cvalid, net.nms_thres)
        keep_ref = nms_keep_mask_plain(offset_boxes, cvalid, net.nms_thres)
    if not torch.equal(keep, keep_ref):
        raise SystemExit("nms kernel differs from plain on the main path's candidates")
    n_valid = int(cvalid.sum())
    log(f"[nms] main-path candidates [32, {cvalid.shape[1]}]: equal; "
        f"{n_valid} valid ({n_valid / BATCH:.1f} per image), {int(keep.sum())} kept")
    results["nms_keep_mask"]["max_abs_err"] = 0.0

    # Predict on the card against predict on the CPU, f32, small images.
    small = [rng.random((128, 192, 3), dtype=np.float32) for _ in range(2)]
    kw = dict(backbone_kind="resnet50", num_classes=90, pretrained=False, prior=0.5, seed=1,
              min_size=128, max_size=192, compute_dtype="float32")
    gpu_net, cpu_net = Retinanet(**kw), Retinanet(device="cpu", **kw)
    cpu_net.load_state_dict({k: v.cpu() for k, v in gpu_net.state_dict().items()})
    for g, c in zip(gpu_net.predict(small), cpu_net.predict(small)):
        if not np.array_equal(g["labels"], c["labels"]):
            raise SystemExit("f32 predict: labels differ between the card and the CPU")
        box_err = float(np.abs(g["boxes"] - c["boxes"]).max())
        score_err = float(np.abs(g["scores"] - c["scores"]).max())
        if box_err > 1e-2 or score_err > 1e-5:
            raise SystemExit(f"f32 predict: card vs CPU box err {box_err}, score err {score_err}")
    log(f"[predict] f32 R50 128x192 on the card equals the CPU: labels exact, "
        f"boxes within 1e-2, scores within 1e-5")

    # The same on two portrait uint8 images that need a resize (one uint8
    # batch). Random weights put many scores within 1e-5 of each other, and
    # such neighbours may trade places: the sorted scores agree within 1e-5,
    # and labels and boxes at every rank whose score is 2e-5 from its
    # neighbours' (the last of a full list only if nothing was cut below it).
    small8 = [rng.integers(0, 256, (150, 100, 3), dtype=np.uint8) for _ in range(2)]
    n_ranks = 0
    for g, c in zip(gpu_net.predict(small8), cpu_net.predict(small8)):
        go, co = (np.argsort(-d["scores"], kind="stable") for d in (g, c))
        gs, cs = g["scores"][go], c["scores"][co]
        if len(gs) != len(cs) or float(np.abs(gs - cs).max()) > 1e-5:
            raise SystemExit("uint8 predict: sorted scores differ between the card and the CPU")
        gap = np.minimum(np.abs(np.diff(cs, prepend=np.inf)), np.abs(np.diff(cs, append=-np.inf)))
        apart = gap > 2e-5
        apart[-1] &= len(cs) < gpu_net.max_detections  # the cut at 100 may fall between neighbours
        if not np.array_equal(g["labels"][go][apart], c["labels"][co][apart]) or \
                float(np.abs(g["boxes"][go][apart] - c["boxes"][co][apart]).max()) > 1e-2:
            raise SystemExit("uint8 predict: labels or boxes differ between the card and the CPU")
        n_ranks += int(apart.sum())
    log(f"[predict] uint8 R50 150x100 -> 192x128 (resized on the device) on the card equals the "
        f"CPU: sorted scores within 1e-5, labels exact and boxes within 1e-2 at the {n_ranks} "
        f"ranks whose scores are 2e-5 from their neighbours'")

    # The uint8 resize (cv2's fixed-point bilinear) on the card and the CPU.
    photo = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
    on_card, hw, _, _ = resize_for_bucket(torch.from_numpy(photo).to(dev), 800, 1333,
                                          wire_dtype=torch.uint8)
    on_cpu, _, _, _ = resize_for_bucket(torch.from_numpy(photo), 800, 1333, wire_dtype=torch.uint8)
    if hw != (800, 1067) or not torch.equal(on_card.cpu(), on_cpu):
        raise SystemExit(f"uint8 resize to {hw}: card and CPU differ at "
                         f"{int((on_card.cpu() != on_cpu).sum())} values")
    log("[resize] uint8 (480, 640) -> (800, 1067): card equals CPU bit for bit")

    # 5. Times. The stem from uint8 (the main path's input) goes into the
    # kernels line; from f32 it is logged beside it.
    st = results["fused_stem"]
    wcl = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    out_elems = BATCH * (H // 4) * (W // 4) * 64
    stem_flops = 2.0 * BATCH * (H // 2) * (W // 2) * 64 * 147
    for dtype in (torch.float32, torch.uint8):
        x, mean, std = stem_in[dtype]
        mean_t, std_t = (torch.tensor(c, dtype=torch.float32, device=dev) for c in (mean, std))

        def cudnn_stem():
            xb = ((x.float() - mean_t) / std_t).to(torch.bfloat16).permute(0, 3, 1, 2)
            y = torch.relu(F.conv2d(xb, wcl, stride=2, padding=3) * scale[:, None, None].bfloat16()
                           + bias[:, None, None].bfloat16())
            return F.max_pool2d(y, 3, 2, 1)

        t = {"name": f"fused_stem from {str(dtype).split('.')[-1]}",
             "ms": time_ms(lambda: stem_forward(x, mean, std, w, scale, bias), 20),
             "plain_ms": time_ms(lambda: stem_plain(x, mean, std, w, scale, bias), 5),
             "library_ms": time_ms(cudnn_stem, 20)}
        stem_bytes = x.numel() * x.element_size() + out_elems * 2 + w.numel() * 4 + 2 * 64 * 4 + 6 * 4
        t["bound_ms"], t["bound_by"] = max(
            (stem_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
            (stem_flops / BF16_TENSOR_FLOPS * 1e3, "operations"),
        )
        log(f"[time] stem at {tuple(x.shape)} {x.dtype}, normalize inside (the library "
            f"composition: normalize, cuDNN bf16 conv, BN, ReLU, max_pool2d):")
        log_kernel_time(t)
        if dtype == torch.uint8:
            st.update({k: t[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
    nm = results["nms_keep_mask"]
    nm["ms"] = time_ms(lambda: nms_keep_mask(offset_boxes, cvalid, 0.5), 50)
    nms_times = device_times(lambda: nms_keep_mask(offset_boxes, cvalid, 0.5), 50)
    nm["device_ms"] = device_ms(nms_times)
    nm["plain_ms"] = time_ms(lambda: nms_keep_mask_plain(offset_boxes, cvalid, 0.5), 3)
    nm["library_ms"] = None  # no single PyTorch call computes greedy NMS
    nv = cvalid.sum(dim=1).double()
    pairs = float((nv * (nv - 1) / 2).sum())  # IoU pairs this run's valid candidates need
    nms_bytes = offset_boxes.numel() * 4 + 2 * cvalid.numel()
    nm["bound_ms"], nm["bound_by"] = max(
        (nms_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
        (pairs * 12 / F32_FLOPS * 1e3, "operations"),
    )
    for name in PREDICT_KERNELS:
        log_kernel_time(results[name])
    log_build_report("nms", ("nms_mask_kernel", "nms_scan_kernel"))
    log_device_times(f"nms_keep_mask on the main path's candidates [32, {cvalid.shape[1]}]",
                     nms_times)

    with torch.inference_mode():
        t_net = time_ms(lambda: apply_detector(net.module, batch, return_levels=True), 5)
        t_post = time_ms(lambda: net._predict_impl(batch, sizes), 5) - t_net
    times = []
    for _ in range(5):
        t0 = time.time()
        net.predict(images)
        times.append(time.time() - t0)
    per_batch = float(np.median(times))
    log(f"[e2e] predict batch 32: median {per_batch * 1e3:.1f} ms over 5 -> "
        f"{BATCH / per_batch:.1f} img/s; forward on the uint8 batch (stem with the normalize "
        f"folded in+trunk+FPN+head) {t_net:.2f} ms; postprocess {t_post:.2f} ms; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    del gpu_net, cpu_net, x, stem_in
    torch.cuda.empty_cache()

    fused_trunk_phases(dev, results, net, batch, sizes)
    del net, batch
    torch.cuda.empty_cache()

    training_phases(dev, results)
    torch.cuda.empty_cache()

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_engine")
    engine_main_path(dev, results, images, work)
    live_bn_phases(dev)

    log(json.dumps({"kernels": [results[k.name] for k in KERNELS]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
