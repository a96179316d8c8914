"""Drive the PyTorch port on one CUDA card and hold each kernel to its plain version.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
NVIDIA Hopper card, ``nvcc`` and PyTorch built for CUDA; it never imports JAX
or the JAX package. Phases, each of which fails the run on any fault:

1. build the six kernels (fused stem, NMS, match, fused bottleneck, top-2,
   frozen BN)
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
   yardsticks, and predict img/s at batch 32; for NMS and the stem also
   their kernels' device time from a ``torch.profiler`` window
   (``device_ms`` in the ``kernels`` line: the hand-written kernels' alone,
   not the wrapper's PyTorch ops), with the wrapper's host time per call and
   the registers and spills of the NMS kernel's ``-Xptxas -v`` log;
6. match kernel against ``match_targets_plain`` at the training shapes:
   batch 16, the five levels of the 800x1344 bucket, 100 GT rows, seeded GT
   with 0, 1, a few and 100 valid rows and a constructed IoU tie; then at
   P3, blocks that stage no GT row, a first valid row past row 0, a tie
   across a row culled in its block and an image without GT, at the
   detector's thresholds and at ones that show the first valid row;
7. the training path: ``Trainer(max_steps=7).fit`` of an R50-FPN
   ``RetinaNetModel`` (the ``configs/hparams.yaml`` values) on seeded uint8
   batches of 16 at 800x1344; the match launches read around the fit
   alone (and frozen BN's: a forward and a backward for each of the 53
   BNs a step), finite losses, every parameter moved, BN statistics
   unchanged;
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
   bound, plain version and ``torch.topk``; both kernels' device time from
   the profiler (``device_ms``); the trunk, the forward and the
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

Then data and eval from files on disk (phase 12), R50-FPN at full width:

12. a. the versions of cv2 and pandas (the script stops at its start,
       naming them, where either is missing);
    b. a seeded COCO-format dataset under ``build/chip_smoke_data/``: 96
       val and 48 train JPEGs, COCO-like 640x480 and 480x640 with about a
       fifth 1333x800 and 800x1333, 1-30 solid rectangles each labelled
       with COCO's 80 ids, a few crowd boxes, one val image without GT;
    c. the evaluator on its own GT (the non-crowd boxes as detections with
       score 1): AP stats 0-5 and AR@100 stats 8-11 read 1 where an area
       range has GT and -1 where it has none; AR@1 and AR@10 printed;
    d. ``Trainer.test`` (test_bs 32, score threshold 0.001, random
       weights): AP and the 12 stats, test-loop img/s on the host clock,
       per batch the time blocked in ``next(loader)`` and predict ms, the
       evaluator's seconds; stem (on the f32 batch) and NMS launched once a
       batch; then ``Trainer.predict`` inside a profiler window: one entry
       per image, boxes inside each original image, the card's idle share;
    e. ``Trainer.fit`` from ``dataset.kind: coco`` for 4 steps of 16 on the
       pinned uint8 wire: match launched 5 times a step, the step with the
       loader in the loop against phase 9's, the upload from pinned memory
       against the same batch from pageable memory;
    f. resnet18 at min 96 / max 160 overfits 8 seeded CSV images (300
       epochs of 2 steps, warmup 100, clip 10), then ``Trainer.test``: AP
       above 0.5, with its seconds.

Then export and serving (phase 13), R50-FPN at full width (90 classes,
prior 0.5, seed 0), under ``build/chip_smoke_export/``:

13. a. ``export.save_exported`` of both buckets (800x1344, 1344x800) at
       batch 8 on the uint8 wire, and ``load_exported`` of each: export,
       load seconds and ``.pt2`` megabytes;
    b. per bucket, the loaded program's weights and buffers equal the
       module's bit for bit with the same strides (channels_last kept);
       one artifact call on 8 seeded uint8 images against
       ``Retinanet._predict_impl`` on the same batch: labels and valid
       exactly, boxes and scores bit for bit or within 1e-3 px and 1e-5
       (the gap printed); stem (on uint8) and NMS launched once each by
       that call, read around it alone;
    c. ``examples/torch_serve.py``'s ``serve`` over 20 seeded landscape
       JPEGs of mixed sizes written to disk (the last batch partial) at
       depth 2: stem and NMS once per batch, read around that run; held
       against ``Retinanet.predict`` on the same decoded images in the
       server's batches of 8 (the last filled up with black images, since
       cuDNN picks its algorithms by batch size): labels exactly, scores
       within 1e-5, boxes within 1e-3 px (the last batch unfilled and one
       predict of all 20 are printed beside it, not checked);
    d. times: ``tools/torch_bench_latency.py``'s rows at batch 1 and 8,
       eager and artifact; the serve loop's img/s at depth 1 against 2 (in
       turns); the uint8 batch of 8's upload from pinned against pageable
       memory (CUDA events).

Then data parallel (phase 14), on ``torch.distributed``. The card machine has
one H100: NCCL runs at world size 1, and the cross-rank checks run two gloo
ranks sharing the card (``tools/torch_multihost_smoke.py`` spawns them, each
joins within ``DDP_TIMEOUT``; the kernels, built in phase 1, are loaded, not
rebuilt, by the ranks), under ``build/chip_smoke_ddp/``. No figure here is a
multi-GPU scaling figure.

14. a. ``init_distributed(backend="nccl")`` and ``Trainer(devices=[0])``:
       phase 7's fit (R50-FPN, seeded uint8 batches of 16 at 800x1344)
       through ``DistributedDataParallel``: match launched 35 times (read
       around this fit), the parameters against phase 7's bit for bit where
       a second plain fit is, else within ``DDP_GAP_FACTOR`` of that pair's
       gap (both printed); ``all_gather_objects`` and ``reduce_dict``
       through NCCL; the DDP step against the plain step on an uploaded
       batch, in turns, medians of 5;
    b. two gloo ranks: the live BN layer on each rank's 8 rows of
       ``LAYER_BN_SHAPE`` (f32 and bf16) against ``F.batch_norm`` in f64
       over the 16: the output, input gradient, the summed weight and bias
       gradients and the running statistics within ``BN_RTOL`` (bf16's
       output and input gradient within ``BN_BF16_TOL``); the
       ``match_mesh`` loss at phase 7's shapes equal to the unsplit
       kernel's, targets and per-image losses, with 5 match launches a rank
       in the split call; f32 resnet18 at 128x192, live BN, 2 SGD steps at
       batch 2 a rank against one process over the batch of 4 (the layer
       on its global-batch path there): losses within ``SMALL_LOSS_RTOL``, the first step's
       updates within ``SMALL_UPDATE_RTOL`` of each tensor's largest (plus
       2 ulp), running statistics within ``SMALL_STATS_RTOL``; then
       R50-FPN bf16, live BN, ``FULL_STEPS`` steps at batch 8 a rank:
       finite losses, match launched 5 times a step in each rank, the two
       ranks' parameters and running statistics bit for bit, each rank's
       peak memory and step ms;
    c. ``Trainer.test`` merged across two gloo ranks on 12d's 96 JPEGs at
       test_bs 32 a rank: stem (f32) and NMS launched once a batch in each
       rank, the merged records and AP against 12d's one process (equal, or
       JAX's multi-process bar: ``MERGED_OVERLAP`` and ``MERGED_AP_TOL``).

Then the flat postprocess and the parity tools (phase 15), at full width:

15. a. the flat postprocess (``ops.process_detections_batch``, the top
       ``FLAT_TOP_K`` of the sigmoid over all 18.1M (anchor, class) pairs)
       on phase 4's head outputs of its first ``FLAT_IMAGES`` images, one
       image a call, through the NMS kernel and through its plain version:
       labels, valid flags, boxes and scores equal, the NMS kernel launched
       once a call and nothing else (read around each arm), its detections
       checked as phase 4's; ms a call and the peak memory;
    b. ``tools/torch_parity_report.py`` at 800x1344, 90 classes,
       ``PARITY_IMAGES`` images: every port row (flat and multilevel, plain
       and kernel NMS) at ΔAP +0.0000 against the torch oracle, the NMS
       kernel launched once an image in each kernel row (and once more, in
       its untimed first call);
    c. ``tools/torch_loss_parity.py`` at 800x1344, batch 4, 90 classes: both
       arms within JAX's bar of the oracle, the match kernel launched 5
       times in its arm and not in the plain one, the focal pair's forward
       5 times in each (the plain arm is the match's alone).

Then the spatial and tensor-parallel meshes (phase 16,
``parallel/sharding.py``), R50-FPN at full width on two gloo ranks sharing
the card, as 14b runs them (``spatial_job``, under
``build/chip_smoke_spatial/``; no figure is a scaling figure):

16. a. the split forward at spatial 2, batch 2 of 800x1344: in f32 (TF32
       off) every level against the unsplit forward within
       ``SPLIT_F32_TOL``; in bf16, predict's detections through it against
       the unsplit forward's (``MERGED_OVERLAP`` at ``SPLIT_BF16_*_TOL``),
       the NMS kernel launched once in each rank;
    b. ``build_sharded_forward(data=2)`` on a uint8 batch of 4: the stem
       kernel launched once a call in each rank, the outputs equal to
       ``apply_detector`` on the rank's rows bit for bit;
    c. tensor parallel, model 2, f32: against the unsplit forward within
       ``SPLIT_F32_TOL``;
    d. spatial training (data 1, spatial 2, frozen BN): f32 resnet18 at
       128x192, 2 SGD steps against one process (14b's small bars); R50-FPN
       bf16 at batch 2, ``SPATIAL_STEPS`` steps: finite losses, match
       launched 5 times a step in each rank, the ranks' parameters bit for
       bit, each rank's peak memory and step ms beside one process's.

Then the frozen-BN kernel pair (phase 17, ``kernels/frozen_bn.py``; it runs
right after phase 1, since late in a long run the card's profiler drops
kernel events, and a window that lost any leaves its device time "not
measured"):

17. the forward and backward kernels against ``frozen_bn_plain`` and
    ``frozen_bn_backward_plain`` on the card: y and dx bit for bit in x's
    strides, dweight and dbias within ``FROZEN_BN_SUM_TOL`` of the sums of
    their terms' magnitudes, the backward twice bit for bit, at
    ``FROZEN_BN_CASES`` (f32, unvectorised channels, one row a block,
    unaligned storage, NCHW) and at R-50's 53 frozen BNs at batch 16,
    800x1344 in bf16 channels-last; through autograd equal to the kernels;
    then a step's forward and backward (CUDA events, and the profiler's
    device time) beside their byte bounds (4 and 6 bytes an element), the
    plain version, and ATen's eval-mode ``F.batch_norm`` (+ ``relu_``)
    forward and backward, timed only, beside the Function's through autograd.

Then the focal-loss kernel pair (phase 18, ``kernels/focal.py``; it runs
right after phase 17, for the same reason):

18. the forward and backward kernels against ``focal_loss_sums_plain`` and
    ``focal_loss_backward_plain`` on the card: the per-image sums within
    ``FOCAL_SUM_TOL`` of the sums of their terms' magnitudes, dx within 1
    bf16 ulp of the larger value (bf16) or ``FOCAL_SUM_TOL`` of the largest
    |dx| (f32), both twice bit for bit, at ``FOCAL_CASES`` (fewer classes
    than a vector, heads and tails around an image's run, unaligned
    storage, f32) and at R-50's five levels at batch 16, 800x1344, 90
    classes, bf16; through autograd equal to the kernels; then a step's
    forward and backward (CUDA events, and the profiler's device time)
    beside their byte bounds, the plain version, and ATen's composition
    (the f32 cast, one-hot and ``sigmoid_focal_loss`` under autograd) as
    ``library_ms``. Phase 7 checks 2 x 5 launches a training step.

The last lines are the ``kernels`` JSON, the ``nvidia-smi`` name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import csv
import importlib
import importlib.util
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


PROFILER_WINDOWS = 3


def device_times(fn, iters: int = 10) -> dict:
    """``fn``'s calls back to back after a warm-up, timed twice: without the
    profiler, the CUDA-event ms per call and the host's us per call to
    enqueue them (no synchronize inside); then in one ``torch.profiler``
    window, each CUDA kernel's device us per call, by name, with its
    launches per call. A window that recorded no kernel at all (the card's
    tracer now and then returns an empty one) is run again, up to
    ``PROFILER_WINDOWS`` in all; the run fails if none recorded a kernel."""
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
    kernels = {}
    for window in range(PROFILER_WINDOWS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            m = re.search(r"(\w+_kernel)\b", e.name)
            name = m.group(1) if m else e.name[:60]
            us, n = kernels.get(name, (0.0, 0))
            kernels[name] = (us + e.time_range.elapsed_us(), n + 1)
        if kernels:
            break
        log(f"[trace] profiler window {window + 1} of {PROFILER_WINDOWS} recorded no CUDA kernel")
    if not kernels:
        raise SystemExit("the profiler recorded no CUDA kernel: device time not measured")
    # The profiler may drop an event of the window: the mean launch times the
    # launches per call (a whole number) stands for the call.
    per_call = {k: max(round(n / iters), 1) for k, (_, n) in kernels.items()}
    return {"kernels": {k: (us / n * per_call[k], per_call[k]) for k, (us, n) in kernels.items()},
            "event_ms": start.elapsed_time(end) / iters, "host_us": host_us}


def device_ms(t: dict, names=None) -> float:
    """The device ms per call of ``device_times``' kernels, or of those in
    `names` alone (a hand-written kernel's, without the wrapper's PyTorch ops);
    fails if none of `names` was recorded."""
    us = [v for k, (v, _) in t["kernels"].items() if names is None or k in names]
    if not us:
        raise SystemExit(f"the profiler recorded none of {names}: device time not measured")
    return sum(us) / 1e3


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
    """The task model serving ``self.loader`` and ``self.val_loader``
    (seeded batches, no dataset on disk)."""

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
    if launches["focal_loss"] != 2 * 5 * TRAIN_STEPS:
        raise SystemExit(f"training launched focal_loss {launches['focal_loss']} times, not a "
                         f"forward and a backward for each of 5 levels x {TRAIN_STEPS} steps")
    n_bn = len(r50_frozen_bn_shapes(TRAIN_BATCH, H, W))
    if launches["frozen_bn"] != 2 * n_bn * TRAIN_STEPS:
        raise SystemExit(f"training launched frozen_bn {launches['frozen_bn']} times, not a "
                         f"forward and a backward for each of {n_bn} BNs x {TRAIN_STEPS} steps")
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
    return model, trainer, launches, peak


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


def training_phases(dev, results) -> tuple:
    """Phases 6-9: the match kernel, the training path and their times.
    Returns phase 9's median step on an uploaded batch, in ms, and phase
    7's parameters after its fit (on the host)."""
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
    model, trainer, launches, train_peak = train_main_path(
        Model, Trainer, ConfigDict, reset_launch_counts, KERNELS)
    fitted = {k: p.detach().cpu().clone() for k, p in model.net.module.named_parameters()}
    results["match_targets"]["launches"] = launches["match_targets"]
    results["frozen_bn"]["launches"] = launches["frozen_bn"]
    results["focal_loss"]["launches"] = launches["focal_loss"]
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
    return step * 1e3, fitted


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


# COCO's 80 category ids, non-contiguous in 1..90.
COCO_IDS = [i for i in range(1, 91) if i not in (12, 26, 29, 30, 45, 66, 68, 69, 71, 83)]
# Phase 12's seeded COCO-format dataset: (images, landscape images) per split.
# Every test bucket ends in a partial batch of 32 (58 = 32 + 26, 38 = 32 + 6);
# the train split gives 3 full batches of 16 an epoch (32 + 16).
DATA_SPLITS = {"val": (96, 58), "train": (48, 32)}
TEST_BATCH = 32
DATA_TRAIN_STEPS = 4
# Phase 12f: resnet18 at min 96 / max 160 overfits 8 CSV images, then is tested.
OVERFIT = {"images": 8, "epochs": 300, "train_bs": 4, "lr": 0.01, "min_ap": 0.5}


def write_coco_split(root: str, split: str, rng: np.random.Generator) -> dict:
    """`split`2017/ of seeded JPEGs (COCO-like 640x480 and 480x640, about a
    fifth 1333x800 and 800x1333) and annotations/instances_`split`2017.json:
    1-30 solid rectangles per image labelled with COCO ids, a few crowd
    boxes, and in val one image without annotations."""
    import cv2

    n, n_land = DATA_SPLITS[split]
    img_dir = os.path.join(root, f"{split}2017")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    images, anns = [], []
    for i in range(n):
        h, w = (800, 1333) if rng.random() < 0.2 else (480, 640)
        if i >= n_land:
            h, w = w, h
        noise = rng.integers(0, 256, (h // 16 + 1, w // 16 + 1, 3), dtype=np.uint8)
        img = cv2.resize(noise, (w, h), interpolation=cv2.INTER_NEAREST)
        image_id = 1000 * (split == "train") + i + 1
        n_gt = 0 if (split == "val" and i == n - 1) else int(rng.integers(1, 31))
        for _ in range(n_gt):
            bw, bh = (float(v) for v in rng.uniform(8, 0.45 * min(h, w), 2))
            x, y = float(rng.uniform(0, w - bw)), float(rng.uniform(0, h - bh))
            cv2.rectangle(img, (int(x), int(y)), (int(x + bw), int(y + bh)),
                          tuple(int(c) for c in rng.integers(0, 256, 3)), -1)
            anns.append({"id": len(anns) + 1, "image_id": image_id,
                         "category_id": int(rng.choice(COCO_IDS)), "bbox": [x, y, bw, bh],
                         "area": bw * bh, "iscrowd": int(rng.random() < 0.03)})
        cv2.imwrite(os.path.join(img_dir, f"{image_id:012d}.jpg"), img,
                    [cv2.IMWRITE_JPEG_QUALITY, 90])
        images.append({"id": image_id, "file_name": f"{image_id:012d}.jpg", "height": h,
                       "width": w})
    coco = {"images": images, "annotations": anns,
            "categories": [{"id": c, "name": str(c)} for c in COCO_IDS]}
    with open(os.path.join(root, "annotations", f"instances_{split}2017.json"), "w") as f:
        json.dump(coco, f)
    return coco


def check_evaluator_on_gt(coco: dict) -> None:
    """12c: the non-crowd GT fed back as detections with score 1: AP (stats
    0-5) and AR@100 (8-11) read 1 where an area range has GT, -1 where it
    has none, as pycocotools gives them."""
    from pytorch_retinanet_tpu_torch.data import COCOIndex
    from pytorch_retinanet_tpu_torch.eval import CocoEvaluator

    evaluator = CocoEvaluator(COCOIndex(coco), ["bbox"])
    preds = {img["id"]: {"boxes": [], "scores": [], "labels": []} for img in coco["images"]}
    for a in coco["annotations"]:
        if not a["iscrowd"]:
            x, y, w, h = a["bbox"]
            p = preds[a["image_id"]]
            p["boxes"].append([x, y, x + w, y + h])
            p["scores"].append(1.0)
            p["labels"].append(a["category_id"])
    evaluator.update(preds)
    evaluator.synchronize_between_processes()
    evaluator.accumulate()
    stats = evaluator.summarize(verbose=False)["bbox"]
    areas = [a["area"] for a in coco["annotations"] if not a["iscrowd"]]
    ranges = {"small": (0.0, 32.0**2), "medium": (32.0**2, 96.0**2), "large": (96.0**2, 1e10)}
    has = {k: any(lo <= v <= hi for v in areas) for k, (lo, hi) in ranges.items()}
    want = [1.0, 1.0, 1.0] + [1.0 if has[k] else -1.0 for k in ranges]
    checked = {i: w for i, w in enumerate(want)}
    checked.update({8: 1.0, **{9 + j: w for j, w in enumerate(want[3:])}})
    bad = {i: (float(stats[i]), w) for i, w in checked.items() if abs(stats[i] - w) > 1e-12}
    if bad:
        raise SystemExit(f"evaluator on its own GT: stats (got, want) {bad}")
    log(f"[eval] {len(areas)} non-crowd GT boxes of {len(coco['images'])} val images fed back "
        f"as detections: AP stats 0-5 {[float(s) for s in stats[:6]]}, AR@100 stats 8-11 "
        f"{[float(s) for s in stats[8:]]} as expected (1 where a range has GT: {has}); AR@1 "
        f"{stats[6]:.4f}, AR@10 {stats[7]:.4f} (not checked)")


def device_busy_share(fn) -> tuple:
    """``fn()`` once inside a ``torch.profiler`` window: (its result, wall
    seconds, the share of that wall the card spent in kernels and copies,
    from the union of their intervals). A window that recorded nothing on
    the card is run again, as in :func:`device_times`."""
    from torch.profiler import ProfilerActivity, profile

    for window in range(PROFILER_WINDOWS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        if spans:
            break
        log(f"[trace] profiler window {window + 1} of {PROFILER_WINDOWS} recorded no CUDA "
            "activity")
    if not spans:
        raise SystemExit("the profiler recorded no CUDA activity: idle share not measured")
    busy, end = 0.0, -float("inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return out, wall, busy / 1e6 / wall


def timed_loader(loader, blocked: list):
    """`loader`, with each ``next`` timed into `blocked` (seconds)."""

    class Timed:
        def __len__(self):
            return len(loader)

        def __iter__(self):
            it = iter(loader)
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                blocked.append(time.perf_counter() - t0)
                yield batch

    return Timed()


def data_test_phase(hp, coco: dict) -> tuple:
    """12d: Trainer.test and Trainer.predict of R50-FPN on the val split.
    Returns the test's AP and its detection records."""
    from pytorch_retinanet_tpu_torch import RetinaNetModel, Trainer
    from pytorch_retinanet_tpu_torch.kernels import KERNELS, reset_launch_counts, stem_forward

    model = RetinaNetModel(hp)
    net = model.net
    blocked, predict_s, eval_s, out = [], [], {}, {}
    make_loader, predict_impl, make_evaluator = (model.test_dataloader, net._predict_impl,
                                                 model.test_evaluator)

    def predict(images, sizes):
        t0 = time.perf_counter()
        out = predict_impl(images, sizes)
        torch.cuda.synchronize()
        predict_s.append(time.perf_counter() - t0)
        return out

    def evaluator(*args, **kw):
        e = make_evaluator(*args, **kw)
        for name in ("accumulate", "summarize"):
            def timed(*a, _f=getattr(e, name), _name=name, **k):
                t0 = time.perf_counter()
                out[_name] = _f(*a, **k)
                eval_s[_name] = time.perf_counter() - t0
                return out[_name]
            setattr(e, name, timed)
        return e

    model.test_dataloader = lambda *a, **k: timed_loader(make_loader(*a, **k), blocked)
    net._predict_impl, model.test_evaluator = predict, evaluator
    trainer = Trainer(logger=False, log_every_n_steps=1000)
    model.prepare_data()
    n_batches = len(make_loader())
    warm = next(iter(make_loader()))  # cuDNN plans and the allocator, outside the count
    predict_impl(warm["images"].to(net.device), warm["image_sizes"].to(net.device))
    del warm
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    tested = tool("torch_multihost_smoke").test_with_records(trainer, model)
    ap = tested["AP"]
    total_s = time.perf_counter() - t0
    launches = {k.name: k.wrapper.launches for k in KERNELS}
    stats = out["summarize"]["bbox"]
    loop_s = sum(blocked) + sum(predict_s)
    n_images = len(coco["images"])
    if launches["fused_stem"] != n_batches or launches["nms_keep_mask"] != n_batches \
            or stem_forward.last_dtype != torch.float32:
        raise SystemExit(f"Trainer.test of {n_batches} batches launched {launches}, the stem "
                         f"last on {stem_forward.last_dtype}; want stem and NMS once a batch, f32")
    if not 0.0 <= ap <= 1.0:
        raise SystemExit(f"Trainer.test AP {ap}")
    log(f"[data] Trainer.test R50-FPN, 90 classes, {n_images} val images in {n_batches} batches "
        f"of {TEST_BATCH} (both buckets, each ending in a partial batch): AP {ap:.6f}; "
        f"launches {launches} (stem on the f32 batch); the 12 stats "
        f"{[round(float(s), 6) for s in stats]}")
    log(f"[data] test loop {loop_s:.3f} s for {n_images} images -> {n_images / loop_s:.1f} img/s "
        f"(host clock, loader and predict); per batch blocked in next(loader) "
        f"{['%.1f' % (s * 1e3) for s in blocked]} ms, predict "
        f"{['%.1f' % (s * 1e3) for s in predict_s]} ms; evaluator evaluate+accumulate "
        f"{eval_s['accumulate']:.3f} s, summarize {eval_s['summarize']:.3f} s; whole "
        f"Trainer.test {total_s:.3f} s")

    # Trainer.predict over the same loader, inside a profiler window.
    blocked.clear()
    predict_s.clear()
    preds, wall, busy = device_busy_share(lambda: trainer.predict(model))
    ids = {img["id"]: img for img in coco["images"]}
    if set(preds) != set(ids):
        raise SystemExit(f"Trainer.predict returned {len(preds)} image ids, want {len(ids)}")
    for image_id, p in preds.items():
        h, w = ids[image_id]["height"], ids[image_id]["width"]
        b = p["boxes"]
        if len(b) and (b.min() < -1e-3 or b[:, [0, 2]].max() > w + 1e-3
                       or b[:, [1, 3]].max() > h + 1e-3 or not np.isfinite(b).all()):
            raise SystemExit(f"Trainer.predict: boxes of image {image_id} outside {w}x{h}")
    n_det = sum(len(p["scores"]) for p in preds.values())
    log(f"[data] Trainer.predict: one entry per val image ({len(preds)}), {n_det} detections, "
        f"boxes inside each original image; under the profiler {wall:.3f} s, the card busy "
        f"{busy:.3f} of it (idle share {1 - busy:.3f}); blocked in next(loader) "
        f"{['%.1f' % (s * 1e3) for s in blocked]} ms, predict "
        f"{['%.1f' % (s * 1e3) for s in predict_s]} ms")
    return ap, tested["records"]


def data_fit_phase(dev, hp, step_ms: float) -> None:
    """12e: Trainer.fit from dataset.kind coco through the loader (uint8 wire)."""
    from pytorch_retinanet_tpu_torch import RetinaNetModel, Trainer
    from pytorch_retinanet_tpu_torch.kernels import KERNELS, reset_launch_counts

    model = RetinaNetModel(hp)
    blocked, ends = [], []
    make_loader = model.train_dataloader
    model.train_dataloader = lambda *a, **k: timed_loader(make_loader(*a, **k), blocked)
    trainer = Trainer(max_epochs=2, max_steps=DATA_TRAIN_STEPS, warmup_steps=500,
                      log_every_n_steps=1, num_sanity_val_steps=0, check_val_every_n_epoch=100,
                      logger=False)
    train_step = trainer.train_step

    def step(batch):
        out = train_step(batch)
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        return out

    trainer.train_step = step
    reset_launch_counts()
    t0 = time.perf_counter()
    trainer.fit(model)
    fit_s = time.perf_counter() - t0
    launches = {k.name: k.wrapper.launches for k in KERNELS}
    losses = trainer.logger_.meters["loss"].window
    if trainer.global_step != DATA_TRAIN_STEPS or not np.isfinite(losses).all() \
            or launches["match_targets"] != 5 * DATA_TRAIN_STEPS:
        raise SystemExit(f"fit from the coco dataset: {trainer.global_step} steps, losses "
                         f"{losses}, launches {launches}")
    batch = next(iter(make_loader()))
    if batch["images"].dtype != torch.uint8 or not batch["images"].is_pinned():
        raise SystemExit(f"train batch {batch['images'].dtype}, pinned "
                         f"{batch['images'].is_pinned()}: want the pinned uint8 wire")
    with_loader = np.diff(ends) * 1e3
    pageable = {k: v.clone() for k, v in batch.items()}

    def upload(b, non_blocking):
        return {k: v.to(dev, non_blocking=non_blocking) for k, v in b.items()}

    pinned_ms = time_ms(lambda: upload(batch, True), 5)
    pageable_ms = time_ms(lambda: upload(pageable, False), 5)
    mb = sum(v.numel() * v.element_size() for v in batch.values()) / 1e6
    log(f"[data] Trainer.fit from dataset.kind coco, {DATA_TRAIN_STEPS} steps of "
        f"{tuple(batch['images'].shape)} uint8 (pinned) in {fit_s:.2f} s: losses "
        f"{['%.5f' % v for v in losses]}; launches {launches}")
    log(f"[data] step with the loader in the loop (previous step's end to this one's, host "
        f"clock) {['%.1f' % v for v in with_loader]} ms, median "
        f"{float(np.median(with_loader)):.1f} ms, against phase 9's {step_ms:.1f} ms on an "
        f"uploaded batch; blocked in next(loader) {['%.1f' % (s * 1e3) for s in blocked]} ms")
    log(f"[data] upload of a {mb:.1f} MB train batch: pinned, non_blocking {pinned_ms:.2f} ms; "
        f"the same from pageable memory {pageable_ms:.2f} ms (CUDA events, mean of 5)")


def write_overfit_csv(root: str, rng: np.random.Generator) -> str:
    """8 images of 120x160 with 1-2 red or blue rectangles (2 classes) and
    their CSV in the reference schema."""
    import cv2
    import pandas as pd

    os.makedirs(root, exist_ok=True)
    colors = {"red": (0, 0, 230), "blue": (230, 0, 0)}
    rows = []
    for i in range(OVERFIT["images"]):
        img = np.full((120, 160, 3), 255, np.uint8)
        path = os.path.join(root, f"{i}.png")
        for _ in range(int(rng.integers(1, 3))):
            cls = ["red", "blue"][int(rng.integers(0, 2))]
            w, h = int(rng.integers(30, 70)), int(rng.integers(30, 70))
            x, y = int(rng.integers(0, 160 - w)), int(rng.integers(0, 120 - h))
            cv2.rectangle(img, (x, y), (x + w, y + h), colors[cls], -1)
            rows.append({"filename": path, "width": 160, "height": 120, "class": cls,
                         "xmin": float(x), "ymin": float(y), "xmax": float(x + w),
                         "ymax": float(y + h), "labels": 1 if cls == "red" else 2})
        cv2.imwrite(path, img)
    csv_path = os.path.join(root, "train.csv")
    pd.DataFrame(rows).to_csv(csv_path, index=False)
    return csv_path


def overfit_phase(root: str) -> None:
    """12f: resnet18 at min 96 / max 160 overfits 8 CSV images, then
    Trainer.test scores them: AP above OVERFIT["min_ap"]."""
    from pytorch_retinanet_tpu_torch import ConfigDict, RetinaNetModel, Trainer

    csv_path = write_overfit_csv(root, np.random.default_rng(12))
    hp = ConfigDict({
        "model": {"backbone_kind": "resnet18", "num_classes": 2, "min_size": 96,
                  "max_size": 160, "pretrained": False},
        "dataset": {"kind": "csv", "trn_paths": csv_path, "valid_paths": False,
                    "test_paths": csv_path},
        "dataloader": {"train_bs": OVERFIT["train_bs"], "valid_bs": 8, "test_bs": 8,
                       "args": {"num_workers": 4}},
        "transforms": [],
        "optimizer": {"class_name": "torch.optim.SGD",
                      "params": {"lr": OVERFIT["lr"], "momentum": 0.9, "weight_decay": 1e-4}},
    })
    model = RetinaNetModel(hp)
    trainer = Trainer(max_epochs=OVERFIT["epochs"], warmup_steps=100, gradient_clip_val=10.0,
                      log_every_n_steps=100, num_sanity_val_steps=0, logger=False)
    t0 = time.perf_counter()
    trainer.fit(model)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    ap = trainer.test(model)[0]["AP"]
    total_s = time.perf_counter() - t0
    log(f"[overfit] resnet18 min 96 / max 160, {OVERFIT['images']} CSV images, "
        f"{trainer.global_step} steps of {OVERFIT['train_bs']} (warmup 100, clip 10): fit "
        f"{fit_s:.1f} s, with Trainer.test {total_s:.1f} s; last loss "
        f"{trainer.logger_.meters['loss'].value:.4f}; AP {ap:.4f} (must exceed "
        f"{OVERFIT['min_ap']})")
    if not ap > OVERFIT["min_ap"]:
        raise SystemExit(f"the overfit reached AP {ap}, not above {OVERFIT['min_ap']}")


def data_eval_phases(dev, step_ms: float) -> tuple:
    """Phase 12: data and eval, from files on disk, at full width. Returns
    12d's config, AP and detection records, for phase 14c."""
    import shutil

    import cv2
    import pandas as pd

    from pytorch_retinanet_tpu_torch import ConfigDict

    log(f"[data] cv2 {cv2.__version__}, pandas {pd.__version__}")
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_data")
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(20)
    t0 = time.perf_counter()
    coco = {split: write_coco_split(root, split, rng) for split in ("val", "train")}
    log(f"[data] wrote {sum(len(c['images']) for c in coco.values())} JPEGs and their COCO "
        f"annotations ({sum(len(c['annotations']) for c in coco.values())} boxes) in "
        f"{time.perf_counter() - t0:.1f} s")
    check_evaluator_on_gt(coco["val"])
    hp = ConfigDict(HPARAMS).merge({
        "model": {"score_thres": 0.001},
        "dataset": {"kind": "coco", "root_dir": root},
        "dataloader": {"test_bs": TEST_BATCH, "args": {"num_workers": 8}},
        "transforms": [{"class_name": "albumentations.HorizontalFlip", "params": {"p": 0.5}}],
    })
    test_ref = data_test_phase(hp, coco["val"])
    torch.cuda.empty_cache()
    data_fit_phase(dev, hp, step_ms)
    torch.cuda.empty_cache()
    overfit_phase(os.path.join(root, "overfit"))
    return (hp, *test_ref)


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

    tot = dict.fromkeys(("ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms",
                         "ops_ms"), 0.0)
    for (h, w, mid, blocks), args in zip(BOTTLENECK_STAGES, stage_args):
        c = 4 * mid
        block = cudnn_block(args, dev)
        x_nchw = args[0].permute(0, 3, 1, 2)
        with torch.inference_mode():
            t = {"ms": time_ms(lambda: fused_bottleneck(*args), 10),
                 "plain_ms": time_ms(lambda: bottleneck_plain(*args), 3),
                 "library_ms": time_ms(lambda: block(x_nchw), 10)}
            pack_ms = time_ms(lambda: pack_bottleneck_weights(args[1], args[4], args[7]), 10)
            trace = device_times(lambda: fused_bottleneck(*args), 10)
        t["device_ms"] = device_ms(trace, ("bottleneck_kernel",))
        log_device_times(f"fused_bottleneck [{BATCH}, {h}, {w}, {c}] mid {mid}", trace)
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
    bt.update({k: tot[k] for k in ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms")})
    bt["bound_by"] = "operations" if tot["ops_ms"] >= tot["bytes_ms"] else "bytes"
    log("[time] fused_bottleneck, the 10 blocks of one forward summed:")
    log_kernel_time(bt)
    del stage_args

    tp = results["top2_classes"]
    a = BATCH * TOP2_LEVELS[0]
    logits = (torch.randn((a, 90), generator=g, device=dev) * 2 - 4).to(torch.bfloat16)
    tp["ms"] = time_ms(lambda: top2_classes(logits), 20)
    top2_times = device_times(lambda: top2_classes(logits), 20)
    tp["device_ms"] = device_ms(top2_times, ("top2_kernel",))
    log_device_times(f"top2_classes at [{a}, 90] bf16", top2_times)
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


# Phase 13: export and serving. Artifacts and the served JPEGs land under
# build/chip_smoke_export/.
SERVE_BATCH = 8
# 20 landscape JPEGs of mixed sizes: two full batches of 8 and a partial one.
SERVE_SIZES = ((800, 1333), (480, 640), (600, 1000), (720, 1280), (427, 640))
SERVE_IMAGES = 20
SERVE_SCORE_TOL, SERVE_BOX_TOL = 1e-5, 1e-3
SERVE_NET = dict(backbone_kind="resnet50", num_classes=90, pretrained=False, prior=0.5, seed=0)


def load_script(name: str, relpath: str):
    """A script of this checkout (``examples/``, ``tools/``) as a module."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), relpath)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_launches() -> dict:
    from pytorch_retinanet_tpu_torch import KERNELS

    return {k.name: k.wrapper.launches for k in KERNELS}


def check_served_launches(what: str, launches: dict, calls: int) -> None:
    """The export/serve path launched stem (last on uint8) and NMS `calls`
    times each, and no other kernel."""
    from pytorch_retinanet_tpu_torch.kernels import stem_forward

    want = {k: calls if k in PREDICT_KERNELS else 0 for k in launches}
    if launches != want or stem_forward.last_dtype != torch.uint8:
        raise SystemExit(f"{what} launched {launches}, the stem last on {stem_forward.last_dtype}; "
                         f"expected {want}, the stem on uint8")


def export_buckets(net, work: str) -> dict:
    """13a: both buckets at batch 8 on the uint8 wire, saved and loaded."""
    from pytorch_retinanet_tpu_torch.export import load_exported, save_exported
    from pytorch_retinanet_tpu_torch.models.retinanet import resolution_buckets

    loaded = {}
    for bucket in resolution_buckets(net.min_size, net.max_size):
        name = f"{net.backbone_kind}_{bucket[0]}x{bucket[1]}_b{SERVE_BATCH}_u8.pt2"
        path = os.path.join(work, name)
        t0 = time.perf_counter()
        save_exported(net, path, SERVE_BATCH, bucket, wire_dtype="uint8")
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        infer = load_exported(path)
        load_s = time.perf_counter() - t0
        if infer.in_shapes[0] != ((SERVE_BATCH, *bucket, 3), torch.uint8) or \
                infer.device != net.device:
            raise SystemExit(f"artifact {path}: inputs {infer.in_shapes}, device {infer.device}")
        log(f"[export] {bucket[0]}x{bucket[1]} batch {SERVE_BATCH} uint8: export (trace and save) "
            f"{export_s:.2f} s, load {load_s:.2f} s, {os.path.getsize(path) / 1e6:.1f} MB")
        loaded[bucket] = infer
    return loaded


def artifact_against_eager(net, infer, bucket, rng) -> None:
    """13b: the loaded weights, then one artifact call against
    ``_predict_impl`` on the same seeded uint8 batch, with the launches
    read around the artifact call alone."""
    from pytorch_retinanet_tpu_torch.kernels import reset_launch_counts

    mine = dict(net.module.named_parameters())
    mine.update(net.module.named_buffers())
    anchors = net._anchors_for(bucket)
    n_cl = 0
    for name, t in list(infer.program.named_parameters()) + list(infer.program.named_buffers()):
        ref = anchors[int(name[8:])] if name.startswith("anchors_") else mine[name[7:]]
        if not torch.equal(t, ref) or t.stride() != ref.stride():
            raise SystemExit(f"artifact tensor {name} differs from the module's (strides "
                             f"{t.stride()} against {ref.stride()})")
        n_cl += t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last)
    h, w = bucket
    x = torch.from_numpy(rng.integers(0, 256, (SERVE_BATCH, h, w, 3), dtype=np.uint8))
    x = x.to(net.device)
    resized = (net.min_size, net.max_size) if h < w else (net.max_size, net.min_size)
    sizes = torch.tensor([resized] * SERVE_BATCH, dtype=torch.float32, device=net.device)
    torch.cuda.synchronize()
    reset_launch_counts()
    got = infer.dispatch(x, sizes)
    torch.cuda.synchronize()
    check_served_launches(f"the {h}x{w} artifact's call", read_launches(), 1)
    want = net._predict_impl(x, sizes)
    for k, g, r in zip(("boxes", "scores", "labels", "valid"), got, want):
        if g.shape != r.shape or g.dtype != r.dtype:
            raise SystemExit(f"artifact {k}: {tuple(g.shape)} {g.dtype} against eager "
                             f"{tuple(r.shape)} {r.dtype}")
    if not (torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])):
        raise SystemExit("artifact labels or valid differ from eager _predict_impl")
    box_gap = float((got[0] - want[0]).abs().max())
    score_gap = float((got[1] - want[1]).abs().max())
    same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if not same and (box_gap > SERVE_BOX_TOL or score_gap > SERVE_SCORE_TOL):
        raise SystemExit(f"artifact against eager: boxes {box_gap}, scores {score_gap}")
    log(f"[export] {h}x{w} artifact against eager _predict_impl on {SERVE_BATCH} uint8 images: "
        f"labels and valid exact, boxes and scores "
        + ("bit for bit" if same else f"within {box_gap:.3g} px / {score_gap:.3g}")
        + f"; {int(want[3].sum())} detections; its {len(mine)} weights and buffers equal the "
        f"module's, {n_cl} 4-D ones channels_last; stem (uint8) and NMS launched once")


def write_serve_images(root: str, rng) -> list:
    import cv2

    os.makedirs(root, exist_ok=True)
    paths = []
    for i in range(SERVE_IMAGES):
        h, w = SERVE_SIZES[i % len(SERVE_SIZES)]
        path = os.path.join(root, f"{i:02d}.jpg")
        cv2.imwrite(path, rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        paths.append(path)
    return paths


def detection_gaps(got: list, want: list) -> tuple:
    """(the images whose labels differ, max score gap, max box gap over the
    others)."""
    bad, s_gap, b_gap = [], 0.0, 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if len(g["labels"]) != len(w["labels"]) or not np.array_equal(g["labels"], w["labels"]):
            bad.append(i)
        elif len(g["labels"]):
            s_gap = max(s_gap, float(np.abs(g["scores"] - w["scores"]).max()))
            b_gap = max(b_gap, float(np.abs(g["boxes"] - w["boxes"]).max()))
    return bad, s_gap, b_gap


def log_gaps(what: str, gaps: tuple) -> None:
    bad, s_gap, b_gap = gaps
    log(f"[serve] {what}: labels " + (f"differ on images {bad}" if bad else "exact")
        + f", scores within {s_gap:.3g}, boxes within {b_gap:.3g} px")


def serve_against_predict(net, infer, paths, serve) -> None:
    """13c: the serve core over the JPEGs against ``Retinanet.predict`` on
    the same decoded images, in the server's batches; the launches read
    around the serve run. cuDNN picks its algorithms by batch size, so
    predict's last, partial batch is filled up to the server's batch with
    black images of its first image's size (the server fills it with zero
    rows): each image then goes through the same convolutions."""
    from pytorch_retinanet_tpu_torch.kernels import reset_launch_counts

    serve.serve(infer, paths[:SERVE_BATCH])  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    got = serve.serve(infer, paths, depth=2)
    torch.cuda.synchronize()
    batches = -(-len(paths) // SERVE_BATCH)
    check_served_launches(f"serving {len(paths)} images", read_launches(), batches)
    decoded = [serve.read_rgb(p) for p in paths]
    want, unfilled = [], []
    for i in range(0, len(decoded), SERVE_BATCH):
        chunk = decoded[i:i + SERVE_BATCH]
        fill = [np.zeros_like(chunk[0])] * (SERVE_BATCH - len(chunk))
        want += net.predict(chunk + fill)[:len(chunk)]
        unfilled += net.predict(chunk) if fill else []
    gaps = detection_gaps(got, want)
    log(f"[serve] {len(paths)} JPEGs ({', '.join(f'{h}x{w}' for h, w in SERVE_SIZES)}) in "
        f"{batches} batches of {SERVE_BATCH}, the last partial, at depth 2; stem (uint8) and NMS "
        f"{batches} launches each")
    log_gaps(f"against predict in batches of {SERVE_BATCH}", gaps)
    tail = len(paths) - len(unfilled)
    log_gaps(f"(not checked) images {tail}-{len(paths) - 1} against predict at batch "
             f"{len(unfilled)}", detection_gaps(got[tail:], unfilled))
    log_gaps(f"(not checked) against one predict of all {len(paths)}",
             detection_gaps(got, net.predict(decoded)))
    if gaps[0] or gaps[1] > SERVE_SCORE_TOL or gaps[2] > SERVE_BOX_TOL:
        raise SystemExit("the serve loop's detections differ from predict's")
    check_detections(got)


def serving_times(net, infer, paths, serve) -> None:
    """13d: the latency rows at batch 1 and 8, eager and artifact; the serve
    loop at depth 1 against 2; the uint8 batch's upload, pinned against
    pageable."""
    latency = load_script("torch_bench_latency", os.path.join("tools", "torch_bench_latency.py"))
    latency.bench(net, (1, SERVE_BATCH), iters=20, artifacts={SERVE_BATCH: infer})
    rates = {1: [], 2: []}
    for depth in (1, 2, 2, 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serve.serve(infer, paths, depth=depth)
        rates[depth].append(len(paths) / (time.perf_counter() - t0))
    log(f"[serve] {len(paths)} JPEGs (decode, cv2 resize, upload, artifact, fetch), host clock: "
        f"depth 1 {rates[1][0]:.1f} / {rates[1][1]:.1f} img/s, depth 2 {rates[2][0]:.1f} / "
        f"{rates[2][1]:.1f} img/s (runs in turns 1, 2, 2, 1)")
    h, w = infer.in_shapes[0].shape[1:3]
    pinned = latency.transfer_ms(SERVE_BATCH, h, w, torch.uint8)
    pageable = latency.transfer_ms(SERVE_BATCH, h, w, torch.uint8, pinned=False)
    mb = SERVE_BATCH * h * w * 3 / 1e6
    log(f"[serve] upload of the uint8 batch [{SERVE_BATCH}, {h}, {w}, 3] ({mb:.1f} MB), CUDA "
        f"events, median of 10: pinned {pinned:.3f} ms ({mb / pinned:.1f} GB/s), pageable "
        f"{pageable:.3f} ms ({mb / pageable:.1f} GB/s)")


def export_serve_phases(dev) -> None:
    """Phase 13: export, load and serve R50-FPN at full width."""
    from pytorch_retinanet_tpu_torch.models.retinanet import Retinanet, resolution_buckets

    t0 = time.perf_counter()
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_export")
    net = Retinanet(**SERVE_NET)
    rng = np.random.default_rng(13)
    artifacts = export_buckets(net, work)
    for bucket, infer in artifacts.items():
        artifact_against_eager(net, infer, bucket, rng)
    landscape = artifacts[resolution_buckets(net.min_size, net.max_size)[0]]
    serve = load_script("torch_serve", os.path.join("examples", "torch_serve.py"))
    paths = write_serve_images(os.path.join(work, "images"), rng)
    serve_against_predict(net, landscape, paths, serve)
    serving_times(net, landscape, paths, serve)
    log(f"[export] phase 13 took {time.perf_counter() - t0:.1f} s")


# Phase 14: data parallel. The card machine has one H100, so NCCL runs at
# world size 1 there (NCCL refuses two ranks on one card); the cross-rank
# checks run two gloo ranks that share the card. No figure of this phase
# is a multi-GPU scaling figure.
DDP_TIMEOUT = 600  # join timeout of each two-rank spawn, seconds
# A DDP fit at world size 1 against phase 7's plain fit: bit for bit where a
# second plain fit is; else its largest parameter gap (of each tensor's
# update) may be this many times the plain pair's (cuDNN's backward is not
# bit-reproducible from run to run).
DDP_GAP_FACTOR = 4.0
# 14b small: two ranks at batch 2 against one process over the batch of 4.
SMALL_LOSS_RTOL, SMALL_UPDATE_RTOL, SMALL_STATS_RTOL = 1e-5, 1e-4, 1e-5
SMALL_NET = {"backbone_kind": "resnet18", "num_classes": 90, "pretrained": False,
             "min_size": 128, "max_size": 192, "compute_dtype": "float32", "prior": 0.1,
             "freeze_bn": False}
SMALL_OPTIMIZER = {"class_name": "torch.optim.SGD",
                   "params": {"lr": 0.01, "weight_decay": 0.001, "momentum": 0.9}}
# 14b layers: live BN on each rank's rows of this global batch (layer3.0.bn1's
# shape at 800x1344, 8 rows a rank) against F.batch_norm in f64 over all of
# it. f32: every tensor within BN_RTOL of its largest |value| (the CPU
# test's bar). bf16: the output and input gradient within BN_BF16_TOL,
# the f32 gradients and statistics within BN_RTOL.
LAYER_BN_SHAPE = (16, 256, 100, 168)
BN_RTOL = 1e-6
BN_BF16_TOL = "1 bf16 ulp of the f64 value + BN_RTOL of the tensor's largest |value|"
# 14b full width: R50-FPN, live BN, batch 8 a rank, this many steps.
FULL_RANK_BATCH, FULL_STEPS = 8, 4
# 14c, where the merged records are not equal to 12d's: the JAX package's
# own multi-process bar (tools/multihost_smoke.py:23-25).
MERGED_OVERLAP, MERGED_AP_TOL = 0.97, 2e-3


def tool(name: str):
    """``tools/<name>.py`` imported as a module, with ``tools/`` on the path
    (the rank spawner's spawned ranks import its jobs by that name)."""
    tools = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    return importlib.import_module(name)


def synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def full_width_job(rank: int, world: int, params: dict) -> dict:
    """Each rank (14b, 16d), or one process (world 1): R50-FPN bf16 steps on
    seeded uint8 batches of ``params["batch"]`` rows a data shard, each
    data-parallel rank its rows, or with ``params["spatial"]`` every rank
    the whole batch through the height split; launches, the state digest,
    the peak memory and what was held before the fit (the model's weights,
    and in one process whatever earlier phases hold), step ms, and in a
    process group the collectives' ms."""
    import torch.distributed as dist

    mh = tool("torch_multihost_smoke")
    dev = torch.device(params["device"])
    from pytorch_retinanet_tpu_torch import ConfigDict, RetinaNetModel, Trainer
    from pytorch_retinanet_tpu_torch.kernels import KERNELS, reset_launch_counts
    from pytorch_retinanet_tpu_torch.parallel import make_train_mesh

    model = served_model(RetinaNetModel)(ConfigDict(params["hparams"]), device=params["device"])
    spatial = params.get("spatial", 1)
    shards = 1 if spatial > 1 else world
    batches = seeded_batches(params["steps"], params["batch"] * shards, params["h"], params["w"],
                             seed=14)
    model.loader = [mh.rows_of(b, rank % shards, shards) for b in batches]
    mesh = make_train_mesh(params["devices"], spatial=spatial) if spatial > 1 else None
    trainer = Trainer(devices=params["devices"], mesh=mesh, max_steps=params["steps"],
                      warmup_steps=500, log_every_n_steps=1, num_sanity_val_steps=0, logger=False)
    step_ms, train_step = [], trainer.train_step

    def timed(batch):
        synchronize(dev)
        t0 = time.perf_counter()
        out = train_step(batch)
        synchronize(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    trainer.train_step = timed
    base = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    reset_launch_counts()
    trainer.fit(model)
    synchronize(dev)
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else 0.0
    out = {"losses": list(trainer.logger_.meters["loss"].window),
           "digest": mh.state_digest(model.net.module),
           "launches": {k.name: k.wrapper.launches for k in KERNELS},
           "peak_gib": peak, "base_gib": base / 2**30, "step_ms": step_ms}
    if dist.is_initialized():
        out.update(gloo_collective_ms(model.net.module, dev))
    return out


def gloo_collective_ms(module, dev) -> dict:
    """The step's collectives alone, on this group: one all-reduce of as
    many f32 values as the module has parameters (DDP's gradient average,
    which DDP issues in buckets during the backward), and one of a live BN
    layer's f64 packet at 256 channels (each live BN layer issues three a
    step), each a median of the ranks' host-clock timings."""
    import torch.distributed as dist

    from pytorch_retinanet_tpu_torch.models.layers import BatchNorm2d

    def timed(t, reps):
        times = []
        for _ in range(reps):
            dist.barrier()
            synchronize(dev)
            t0 = time.perf_counter()
            dist.all_reduce(t)
            synchronize(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    n = sum(p.numel() for p in module.parameters())
    return {"grads_ms": timed(torch.zeros(n, device=dev), 3),
            "bn_packet_ms": timed(torch.zeros(2 * 256 + 1, dtype=torch.float64, device=dev), 30),
            "n_params": n,
            "n_live_bn": sum(isinstance(m, BatchNorm2d) and not m.frozen for m in module.modules())}


def join_ranks(what: str, run) -> list:
    """The ranks' results; a failed or timed-out rank fails the phase."""
    out = run.join()
    if out["timed_out"] or any(c != 0 for c in out["exitcodes"]):
        errors = [r.get("traceback") if r else None for r in out["results"]]
        raise SystemExit(f"[ddp] {what}: exit codes {out['exitcodes']}, timed out "
                         f"{out['timed_out']} (join timeout {run.timeout} s); {errors}")
    log(f"[ddp] {what}: {len(out['results'])} ranks joined in {out['seconds']:.1f} s")
    return out["results"]


def params_gap(got: dict, want: dict, before: dict) -> tuple:
    """(bit for bit, the largest max|got - want| over max|want - before|)."""
    exact = all(torch.equal(got[k].cpu(), want[k].cpu()) for k in want)
    worst = max(float((got[k].cpu() - want[k].cpu()).abs().max())
                / max(float((want[k].cpu() - before[k].cpu()).abs().max()), 1e-30) for k in want)
    return exact, worst


def nccl_world_one(dev, fitted7: dict) -> None:
    """14a: the DDP fit through NCCL at world size 1, at phase 7's shapes."""
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    from pytorch_retinanet_tpu_torch import ConfigDict, RetinaNetModel, Trainer, parallel
    from pytorch_retinanet_tpu_torch.engine.trainer import _NO_BUFFER_SYNC
    from pytorch_retinanet_tpu_torch.kernels import KERNELS, reset_launch_counts

    Model = served_model(RetinaNetModel)

    def fit7(**kw):
        model = Model(ConfigDict(HPARAMS))
        model.loader = seeded_batches(TRAIN_STEPS, TRAIN_BATCH, H, W, seed=7)
        trainer = Trainer(max_steps=TRAIN_STEPS, warmup_steps=500, gradient_clip_val=None,
                          log_every_n_steps=1, **kw)
        synchronize(dev)
        reset_launch_counts()
        trainer.fit(model)
        synchronize(dev)
        params = {k: p.detach() for k, p in model.net.module.named_parameters()}
        return model, trainer, params, {k.name: k.wrapper.launches for k in KERNELS}

    before = {k: p.detach() for k, p in
              Model(ConfigDict(HPARAMS), device="cpu").net.module.named_parameters()}
    plain, plain_t, plain_params, _ = fit7()
    plain_exact, plain_gap = params_gap(plain_params, fitted7, before)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    parallel.init_distributed(backend=backend)
    try:
        if dist.get_backend() != backend or parallel.get_world_size() != 1:
            raise SystemExit(f"[ddp] want a {backend} group of 1, got {dist.get_backend()} of "
                             f"{parallel.get_world_size()}")
        ddp, ddp_t, ddp_params, launches = fit7(devices=[dev.index or 0] if dev.type == "cuda"
                                                else ["cpu"])
        losses = ddp_t.logger_.meters["loss"].window
        if launches["match_targets"] != 5 * TRAIN_STEPS or ddp_t.global_step != TRAIN_STEPS \
                or not np.isfinite(losses).all():
            raise SystemExit(f"[ddp] NCCL fit: {ddp_t.global_step} steps, losses {losses}, "
                             f"launches {launches}")
        ddp_exact, ddp_gap = params_gap(ddp_params, fitted7, before)
        log(f"[ddp] 14a NCCL, world size 1: R50-FPN {TRAIN_STEPS} steps of {TRAIN_BATCH} x "
            f"800x1344 uint8 through DistributedDataParallel; launches {launches}; losses "
            f"{['%.5f' % v for v in losses]}; parameters against phase 7's plain fit: DDP "
            f"{'bit for bit' if ddp_exact else 'gap %.3e' % ddp_gap}, a second plain fit "
            f"{'bit for bit' if plain_exact else 'gap %.3e' % plain_gap} (largest |difference| "
            "of each tensor's update)")
        if (plain_exact and not ddp_exact) or ddp_gap > DDP_GAP_FACTOR * plain_gap:
            raise SystemExit(f"[ddp] the NCCL fit's parameters are {ddp_gap:.3e} from phase "
                             f"7's, the plain pair's {plain_gap:.3e} (factor {DDP_GAP_FACTOR})")
        obj = {"rank": parallel.get_rank(), "x": list(range(5))}
        gathered = parallel.all_gather_objects(obj)
        reduced = parallel.reduce_dict({"loss": torch.tensor([1.0, 3.0], device=dev)})
        if gathered != [obj] or reduced != {"loss": 2.0}:
            raise SystemExit(f"[ddp] NCCL collectives: gathered {gathered}, reduced {reduced}")
        log(f"[ddp] all_gather_objects and reduce_dict through NCCL: {gathered}, {reduced}")

        # The step on an uploaded batch, DDP against plain, in turns.
        batch = {k: torch.as_tensor(v).to(dev) for k, v in ddp.loader[0].items()}
        ddp_t._ddp = DistributedDataParallel(
            ddp.net.module, device_ids=[dev.index or 0] if dev.type == "cuda" else None,
            process_group=dist.group.WORLD, **_NO_BUFFER_SYNC)
        times = {"plain": [], "ddp": []}
        for arm in ("plain", "ddp", "ddp", "plain"):
            t = plain_t if arm == "plain" else ddp_t
            for _ in range(5):
                synchronize(dev)
                t0 = time.perf_counter()
                t.train_step(batch)
                synchronize(dev)
                times[arm].append((time.perf_counter() - t0) * 1e3)
        ddp_t._ddp = None
        med = {k: float(np.median(v)) for k, v in times.items()}
        log(f"[time] 14a train step R50-FPN batch {TRAIN_BATCH} 800x1344 on an uploaded batch, "
            f"turns plain, DDP, DDP, plain of 5 (host clock): DDP (NCCL, world size 1) median "
            f"{med['ddp']:.1f} ms against plain {med['plain']:.1f} ms "
            f"({(med['ddp'] / med['plain'] - 1) * 100:+.1f}%); DDP "
            f"{['%.1f' % v for v in times['ddp']]}, plain {['%.1f' % v for v in times['plain']]}")
    finally:
        dist.destroy_process_group()


def small_ranks_vs_one_process(dev, work: str, devices: list) -> None:
    """14b small: two gloo ranks of the f32 live-BN step against one process."""
    mh = tool("torch_multihost_smoke")
    state = mh.seeded_state(SMALL_NET, seed=3)
    rng = np.random.default_rng(8)
    batches = []
    for n_valid in ([5, 0, 3, 1], [2, 4, 0, 6]):
        boxes, labels, valid = seeded_gt(rng, n_valid, 128, 192)
        batches.append({"images": rng.random((4, 128, 192, 3), dtype=np.float32),
                        "boxes": boxes, "labels": labels, "valid": valid})
    os.makedirs(work, exist_ok=True)
    torch.save({"batches": batches, "state": state}, os.path.join(work, "small_data.pt"))
    run = {"model": SMALL_NET, "optimizer": SMALL_OPTIMIZER, "trainer": {"max_steps": 2},
           "save_last": True}
    ranks = join_ranks("14b small (f32 resnet18, live BN)", mh.RankRun(
        mh.job_train, {"data": os.path.join(work, "small_data.pt"), "runs": {"small": run},
                       "device": dev.type, "devices": devices},
        timeout=DDP_TIMEOUT, workdir=os.path.join(work, "small")))
    # One process over the batch of 4, the layer on its global-batch path
    # (its all-reduces the identity): the same arithmetic as the ranks'.
    # 14b layers holds that path to F.batch_norm.
    c = mh.train_against_one_process(os.path.join(work, "small"), "small", run, batches, state,
                                     ranks, dev.type, SMALL_LOSS_RTOL, SMALL_UPDATE_RTOL)
    log(f"[ddp] 14b small: 2 gloo ranks x 2 rows (one card) against one process x 4 rows, f32 "
        f"resnet18 128x192 live BN, 2 SGD steps: losses {c['losses']} vs {c['single']} (worst "
        f"{c['loss_rel_err']:.2e} rel, limit {SMALL_LOSS_RTOL}); first step's update gap "
        f"{c['update_gap_of_bound']:.3f} of the bound ({SMALL_UPDATE_RTOL} of the tensor's "
        f"largest update + 2 ulp) at {c['worst_tensor']}; running statistics after both steps "
        f"within {c['stats_rel_err']:.2e} rel (limit {SMALL_STATS_RTOL}); ranks bit for bit "
        f"{c['ranks_bit_for_bit']}")
    if not c["loss_ok"] or c["update_gap_of_bound"] > 1.0 \
            or c["stats_rel_err"] > SMALL_STATS_RTOL or not c["ranks_bit_for_bit"]:
        raise SystemExit("[ddp] 14b small: two ranks differ from one process or each other")


def layer_checks_job(rank: int, world: int, params: dict) -> dict:
    """14b layers, each rank: live BN on its rows against F.batch_norm in
    f64 over the global batch (the errors, see BN_RTOL), and the match_mesh
    loss at phase 7's shapes against the unsplit kernel's, with the match
    launches of the split call."""
    import torch.distributed as dist
    import torch.nn.functional as F

    from pytorch_retinanet_tpu_torch import parallel
    from pytorch_retinanet_tpu_torch.kernels import KERNELS, match_targets, reset_launch_counts
    from pytorch_retinanet_tpu_torch.models.layers import BatchNorm2d
    from pytorch_retinanet_tpu_torch.ops import generate_anchors_per_level, retinanet_loss_levels
    from pytorch_retinanet_tpu_torch.ops.losses import _split_over_ranks

    mh = tool("torch_multihost_smoke")
    dev = torch.device(params["device"], params["devices"][rank]) \
        if params["device"] == "cuda" else torch.device("cpu")
    shape = tuple(params["bn_shape"])
    b, c = shape[:2]
    rows = slice(rank * b // world, (rank + 1) * b // world)
    out = {"bn": {}}
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=dev).manual_seed(21)
        x = (torch.randn(shape, generator=g, device=dev) * 3.0 + 1.0).to(dtype)
        w_out = torch.randn(shape, generator=g, device=dev).to(dtype)
        state = {"weight": torch.rand(c, generator=g, device=dev) + 0.5,
                 "bias": torch.randn(c, generator=g, device=dev) * 0.5,
                 "running_mean": torch.randn(c, generator=g, device=dev) * 0.1,
                 "running_var": torch.rand(c, generator=g, device=dev) + 0.5}
        got = mh.live_bn_rows(x, w_out, state, rank, world)
        for k in ("weight_grad", "bias_grad"):  # DDP averages them: their sum is the batch's
            dist.all_reduce(got[k])
        x64 = x.double().requires_grad_(True)
        weight, bias = (state[k].double().requires_grad_(True) for k in ("weight", "bias"))
        y64 = F.batch_norm(x64, None, None, weight, bias, True, 0.0,
                           BatchNorm2d(c, frozen=False).eps)
        (y64 * w_out.double()).sum().backward()
        m = BatchNorm2d.momentum
        want = {"y": y64.detach()[rows], "x_grad": x64.grad[rows], "weight_grad": weight.grad,
                "bias_grad": bias.grad,
                "running_mean": m * state["running_mean"].double()
                + (1 - m) * x64.detach().mean((0, 2, 3)),
                "running_var": m * state["running_var"].double()
                + (1 - m) * x64.detach().var((0, 2, 3), correction=0)}
        errs = {}
        for k, w in want.items():
            diff = (got[k].double() - w).abs()
            top = float(w.abs().max())
            errs[k] = float(diff.max()) / top
            if dtype == torch.bfloat16 and k in ("y", "x_grad"):
                bound = bf16_ulp(w).double() + BN_RTOL * top
                errs[k + "_outside"] = int((diff > bound).sum())
        errs["num_batches_tracked"] = got["num_batches_tracked"]
        out["bn"][str(dtype).split(".")[-1]] = errs
        del x, w_out, got, x64, y64, want
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # match_mesh at phase 7's shapes: every rank holds the global batch.
    gt = seeded_batches(1, params["batch"], params["h"], params["w"], seed=7)[0]
    anchors = [torch.from_numpy(a).to(dev) for a in generate_anchors_per_level(
        (params["h"], params["w"]))]
    boxes = torch.from_numpy(gt["boxes"]).to(dev)
    labels = torch.from_numpy(gt["labels"]).to(dev, torch.int32)
    valid = torch.from_numpy(gt["valid"]).to(dev).bool()
    g = torch.Generator(device=dev).manual_seed(5)
    cls = [torch.randn((params["batch"], a.shape[0], 90), generator=g, device=dev)
           for a in anchors]
    box = [torch.randn((params["batch"], a.shape[0], 4), generator=g, device=dev) for a in anchors]
    plan = parallel.make_mesh(params["devices"])
    kw = dict(num_classes=90, reduction="none")
    synchronize(dev)
    reset_launch_counts()
    split = retinanet_loss_levels(cls, box, anchors, boxes, labels, valid, match_mesh=plan, **kw)
    synchronize(dev)
    launches = {k.name: k.wrapper.launches for k in KERNELS}
    unsplit = retinanet_loss_levels(cls, box, anchors, boxes, labels, valid, **kw)
    args = (0.5, 0.4, (1.0, 1.0, 1.0, 1.0))
    split_match = _split_over_ranks(match_targets, dist.group.WORLD)
    targets_equal = all(torch.equal(p, q)
                        for a in anchors
                        for p, q in zip(split_match(a, boxes, labels, valid, *args),
                                        match_targets(a, boxes, labels, valid, *args)))
    out["match"] = {"launches": launches, "targets_equal": targets_equal,
                    "losses_equal": all(torch.equal(split[k], unsplit[k]) for k in unsplit),
                    "finite": all(bool(torch.isfinite(v).all()) for v in split.values()),
                    "n_valid_gt": int(valid.sum())}
    return out


def layer_checks(dev, work: str, devices: list) -> None:
    """14b layers: the synced live BN layer and the match_mesh split on two
    gloo ranks on the card (:func:`layer_checks_job`)."""
    mh = tool("torch_multihost_smoke")
    out = join_ranks("14b layers (live BN rows, match_mesh)", mh.RankRun(
        layer_checks_job, {"device": dev.type, "devices": devices, "bn_shape": LAYER_BN_SHAPE,
                           "batch": TRAIN_BATCH, "h": H, "w": W},
        timeout=DDP_TIMEOUT, workdir=os.path.join(work, "layers")))
    bad = []
    for r, o in enumerate(out):
        for dtype, errs in o["bn"].items():
            log(f"[ddp] 14b layers rank {r}: live BN {dtype} on rows of {LAYER_BN_SHAPE} against "
                f"F.batch_norm f64 over the global batch, max |diff| of each tensor's largest: "
                + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()
                            if k.endswith(("_grad", "y", "_mean", "_var")))
                + (f"; bf16 outside {BN_BF16_TOL}: y {errs['y_outside']}, x_grad "
                   f"{errs['x_grad_outside']}" if "y_outside" in errs else ""))
            limited = [k for k in errs if k.endswith(("_grad", "y", "_mean", "_var"))
                       and not (dtype == "bfloat16" and k in ("y", "x_grad"))]
            if any(errs[k] > BN_RTOL for k in limited) or errs.get("y_outside", 0) \
                    or errs.get("x_grad_outside", 0) or errs["num_batches_tracked"] != 1:
                bad.append(f"rank {r} BN {dtype}")
        mm = o["match"]
        log(f"[ddp] 14b layers rank {r}: match_mesh loss at {TRAIN_BATCH} x {H}x{W}, 5 levels, "
            f"{mm['n_valid_gt']} valid GT rows: equal to the unsplit kernel's "
            f"{mm['losses_equal']}, targets equal {mm['targets_equal']}; launches of the split "
            f"call {mm['launches']}")
        if not (mm["losses_equal"] and mm["targets_equal"] and mm["finite"]) \
                or mm["launches"]["match_targets"] != 5:
            bad.append(f"rank {r} match_mesh")
    if bad:
        raise SystemExit(f"[ddp] 14b layers: {bad}")


def ddp_phases(dev, fitted7: dict, test_ref: tuple) -> None:
    """Phase 14: the DDP fit through NCCL at world size 1 (14a), two gloo
    ranks on the one card against one process and each other (14b), and
    the merged ``Trainer.test`` on two gloo ranks (14c)."""
    t_phase = time.perf_counter()
    mh = tool("torch_multihost_smoke")
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_ddp")
    import shutil

    shutil.rmtree(work, ignore_errors=True)
    nccl_world_one(dev, fitted7)
    torch.cuda.empty_cache()
    rank_devices = [dev.index or 0] * 2 if dev.type == "cuda" else ["cpu"] * 2

    layer_checks(dev, work, rank_devices)
    small_ranks_vs_one_process(dev, work, rank_devices)
    torch.cuda.empty_cache()

    live = merged_conf(HPARAMS, {"model": {"freeze_bn": False}})
    out = join_ranks("14b full width (R50-FPN bf16, live BN)", mh.RankRun(
        full_width_job, {"hparams": live, "device": dev.type, "devices": rank_devices,
                           "batch": FULL_RANK_BATCH, "steps": FULL_STEPS, "h": H, "w": W},
        timeout=DDP_TIMEOUT, workdir=os.path.join(work, "full")))
    for r, o in enumerate(out):
        log(f"[ddp] 14b full rank {r}: losses {['%.5f' % v for v in o['losses']]}; launches "
            f"{o['launches']}; peak memory {o['peak_gib']:.2f} GiB; step ms "
            f"{['%.1f' % v for v in o['step_ms']]}")
    if any(not np.isfinite(o["losses"]).all() or o["launches"]["match_targets"] != 5 * FULL_STEPS
           for o in out) or out[0]["digest"] != out[1]["digest"]:
        raise SystemExit("[ddp] 14b full width: non-finite losses, missing match launches, or "
                         "the ranks' parameters and running statistics differ")
    o = out[0]
    log(f"[time] 14b R50-FPN live BN, 2 gloo ranks x {FULL_RANK_BATCH} sharing one card "
        f"(not a scaling figure): step median {np.median([v for o in out for v in o['step_ms'][1:]]):.1f} "
        f"ms (steps 2-{FULL_STEPS}, both ranks); the ranks' state bit for bit; the collectives "
        f"alone (rank 0, host clock): gloo all-reduce of the {o['n_params']} f32 gradients "
        f"{o['grads_ms']:.1f} ms, one BN packet {o['bn_packet_ms']:.3f} ms x 3 x "
        f"{o['n_live_bn']} live BN layers = {3 * o['n_live_bn'] * o['bn_packet_ms']:.1f} ms a step")
    torch.cuda.empty_cache()

    hp, ap_ref, records_ref = test_ref
    hp = merged_conf(hp, {"dataloader": {"args": {"num_workers": 4}}})
    out = join_ranks("14c merged Trainer.test", mh.RankRun(
        mh.job_eval, {"conf": hp, "device": dev.type, "devices": rank_devices, "warm": True,
                      "validate": False},
        timeout=DDP_TIMEOUT, workdir=os.path.join(work, "test")))
    for r, o in enumerate(out):
        if o["launches"]["fused_stem"] != o["n_batches"] \
                or o["launches"]["nms_keep_mask"] != o["n_batches"] \
                or o["stem_dtype"] != "torch.float32":
            raise SystemExit(f"[ddp] 14c rank {r}: {o['n_batches']} batches launched "
                             f"{o['launches']}, the stem on {o['stem_dtype']}")
        log(f"[ddp] 14c rank {r}: {o['n_batches']} batches of {TEST_BATCH}, launches "
            f"{o['launches']}, Trainer.test {o['seconds']:.2f} s, AP {o['AP']:.6f}")
    r0, r1 = out
    if r0["AP"] != r1["AP"] or r0["records"] != r1["records"]:
        raise SystemExit("[ddp] 14c: the ranks' merged results differ")
    exact = sorted(r0["records"], key=record_key) == sorted(records_ref, key=record_key)
    overlap = mh.records_overlap(r0["records"], records_ref)
    log(f"[ddp] 14c merged Trainer.test on 2 gloo ranks against 12d's one process: "
        f"{len(r0['records'])} vs {len(records_ref)} records, "
        f"{'equal' if exact else 'overlap %.4f' % overlap}; AP {r0['AP']:.6f} vs {ap_ref:.6f} "
        f"(delta {abs(r0['AP'] - ap_ref):.2e})")
    if not exact and (overlap < MERGED_OVERLAP or abs(r0["AP"] - ap_ref) > MERGED_AP_TOL):
        raise SystemExit(f"[ddp] 14c: record overlap {overlap} (bar {MERGED_OVERLAP}), AP delta "
                         f"{abs(r0['AP'] - ap_ref)} (bar {MERGED_AP_TOL})")
    shutil.rmtree(work, ignore_errors=True)  # the saved states
    log(f"[ddp] phase 14 took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# Phase 15: the flat postprocess and the parity tools, at full width.
# ---------------------------------------------------------------------------
FLAT_IMAGES = 8  # phase 4's images whose head outputs 15a keeps, one a call
FLAT_TOP_K = 4096  # the parity report's flat row: every planted candidate
PARITY_IMAGES = 8  # 15b's val set, cut from the tool's 50 for time
LOSS_BATCH = 4  # 15c, the loss tool's configuration: 800x1344, batch 4, 90 classes


def flat_head_outputs(net, batch) -> tuple:
    """Phase 4's head outputs on its batch of 32, the first FLAT_IMAGES
    images' concatenated over the levels ([N, A, 90] logits and [N, A, 4]
    deltas in the head's bf16), kept on the host for phase 15a."""
    from pytorch_retinanet_tpu_torch.models.retinanet import apply_detector

    with torch.inference_mode():
        cls_levels, box_levels = apply_detector(net.module, batch, return_levels=True)
        return (torch.cat(cls_levels, 1)[:FLAT_IMAGES].cpu(),
                torch.cat(box_levels, 1)[:FLAT_IMAGES].cpu())


def flat_arm(dev, cls, box, anchors, sizes, kernel: bool) -> tuple:
    """15a: the flat postprocess on each image, one call an image, through
    the NMS kernel or its plain version; the detections, the launch counts
    of this arm alone, the ms of each call and the peak GiB."""
    from pytorch_retinanet_tpu_torch.kernels import reset_launch_counts
    from pytorch_retinanet_tpu_torch.ops import process_detections_batch

    synchronize(dev)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launch_counts()
    dets, ms = [], []
    for i in range(cls.shape[0]):
        synchronize(dev)
        t0 = time.perf_counter()
        with torch.inference_mode():
            dets.append(process_detections_batch(cls[i:i + 1], box[i:i + 1], anchors,
                                                 sizes[i:i + 1], pre_nms_top_k=FLAT_TOP_K,
                                                 use_kernel=kernel))
        synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    return dets, launches, ms, peak


def flat_path_phases(dev, heads) -> None:
    """Phase 15: the flat postprocess on phase 4's head outputs, kernel arm
    against plain arm (15a); the parity report at 800x1344 with 90 classes
    (15b); the loss parity at its full configuration (15c)."""
    from pytorch_retinanet_tpu_torch.ops import generate_anchors

    t_phase = time.perf_counter()
    cls, box = (t.to(dev) for t in heads)
    n = cls.shape[0]
    anchors = torch.from_numpy(generate_anchors((H, W))).to(dev)
    sizes = torch.tensor([[800.0, 1333.0]] * n, device=dev)
    arms = {k: flat_arm(dev, cls, box, anchors, sizes, k) for k in (True, False)}
    (got, launches, ms, peak), (ref, plain_launches, plain_ms, plain_peak) = arms[True], arms[False]
    want = {k: n if k == "nms_keep_mask" else 0 for k in launches}
    if launches != want or any(plain_launches.values()):
        raise SystemExit(f"[flat] {n} calls launched {launches} through the kernel arm and "
                         f"{plain_launches} through the plain arm; expected {want} and none")
    for i, (g, r) in enumerate(zip(got, ref)):
        if not all(torch.equal(a, b) for a, b in zip(g, r)):
            raise SystemExit(f"[flat] image {i}: the NMS kernel arm's detections differ from "
                             "the plain arm's")
    preds = [{"boxes": d.boxes[0][d.valid[0]].cpu().numpy(),
              "scores": d.scores[0][d.valid[0]].cpu().numpy(),
              "labels": d.labels[0][d.valid[0]].cpu().numpy()} for d in got]
    check_detections(preds)
    log(f"[flat] 15a flat postprocess (pre_nms_top_k {FLAT_TOP_K} of A*C = "
        f"{cls.shape[1] * cls.shape[2]:,}) on phase 4's first {n} images, one a call: the NMS "
        f"kernel arm equals the plain arm (labels, valid, boxes, scores); launches {launches}; "
        f"detections per image {[len(p['scores']) for p in preds]}")
    log(f"[time] flat postprocess, one 800x1344 image of R50 head outputs (bf16, 90 classes), "
        f"host clock around a synchronize: kernel arm median {np.median(ms):.2f} ms "
        f"({['%.2f' % v for v in ms]}), plain arm median {np.median(plain_ms):.2f} ms; peak "
        f"above the inputs {peak:.2f} / {plain_peak:.2f} GiB")
    del cls, box, got, ref
    torch.cuda.empty_cache()

    from pytorch_retinanet_tpu_torch.kernels import reset_launch_counts

    report, loss = tool("torch_parity_report"), tool("torch_loss_parity")
    t0 = time.perf_counter()
    reset_launch_counts()
    res = report.run(PARITY_IMAGES, 90, (H, W), dev)
    launches = read_launches()
    # Each of the two kernel rows: an untimed first call, then one call an image.
    want = {k: 2 * (PARITY_IMAGES + 1) if k == "nms_keep_mask" else 0 for k in launches}
    if launches != want:
        raise SystemExit(f"[parity] 15b launched {launches}, expected {want}")
    for r in res["rows"]:
        kernel_row = r["pipeline"].endswith("NMS kernel")
        want = PARITY_IMAGES if kernel_row else 0
        log(f"[parity] 15b {r['pipeline']}: AP {r['ap']:.4f}, delta {r['delta_ap']:+.4f}, "
            f"{r['seconds']:.3f} s, {r['nms_launches']} NMS launches, peak {r['peak_gib']}")
        if f"{r['delta_ap']:+.4f}" != "+0.0000" or r["nms_launches"] != want:
            raise SystemExit(f"[parity] 15b {r['pipeline']}: delta AP {r['delta_ap']:+.6f}, "
                             f"{r['nms_launches']} NMS launches (expected +0.0000, {want})")
    log(f"[parity] 15b {H}x{W}, 90 classes, {PARITY_IMAGES} images: every row delta AP +0.0000 "
        f"against the torch oracle ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    reset_launch_counts()
    res = loss.run(H, W, LOSS_BATCH, 90, MAX_GT, dev)
    launches = read_launches()
    want = {k: {"match_targets": 5, "focal_loss": 2 * 5}.get(k, 0) for k in launches}
    if launches != want:
        raise SystemExit(f"[parity] 15c launched {launches}, expected {want}")
    for name, d in res["rows"]:
        log(f"[parity] 15c {name}: classification {d['classification_loss']:.6f}, regression "
            f"{d['regression_loss']:.6f}, match launches {d.get('match_launches', '-')}")
    if not res["within_bar"] or res["port_kernel"]["match_launches"] != 5 \
            or res["port_plain"]["match_launches"] != 0:
        raise SystemExit(f"[parity] 15c: max |delta| {res['max_abs_delta']:.3e} (bar "
                         f"{res['bar']}), match launches {res['port_kernel']['match_launches']} / "
                         f"{res['port_plain']['match_launches']} (expected 5 / 0)")
    log(f"[parity] 15c loss at {H}x{W}, batch {LOSS_BATCH}, 90 classes: within JAX's bar "
        f"({res['bar']}), max |delta| {res['max_abs_delta']:.3e}; the match-kernel arm bit for "
        f"bit equal to the plain arm: {res['kernel_bitwise_equal_plain']} "
        f"({time.perf_counter() - t0:.1f} s)")
    log(f"[flat] phase 15 took {time.perf_counter() - t_phase:.1f} s")



# ---------------------------------------------------------------------------
# Phase 16: the spatial and tensor-parallel meshes (parallel/sharding.py), on
# two gloo ranks sharing the card, as phase 14b runs them. No figure of this
# phase is a multi-GPU scaling figure.
# ---------------------------------------------------------------------------
SPLIT_NET = {"backbone_kind": "resnet50", "num_classes": 90, "pretrained": False, "prior": 0.5,
             "seed": 16}
SPLIT_BATCH = 2  # 16a, 16c; 16b's global batch is twice it, SPLIT_BATCH rows a rank
# 16a and 16c in f32 (TF32 off) against the unsplit forward: JAX's bar for
# its sharded forwards (tests/test_sharding.py), absolute and relative.
SPLIT_F32_TOL = 1e-4
# 16a in bf16: the detections of the split forward against the unsplit
# forward's (both through the module's stem, the postprocess's NMS kernel),
# matched one to one: 14c's overlap bar, at bf16 tolerances (the shards'
# convolutions run other cuDNN algorithms, and bf16 logits one ulp apart
# move a score near 0.5 by ~1e-3).
SPLIT_BF16_BOX_TOL, SPLIT_BF16_SCORE_TOL = 2.0, 1e-2
# 16d: f32 resnet18 at 128x192 with frozen BN (14b's small run), and
# R50-FPN bf16 at batch 2, this many steps.
SPATIAL_STEPS = 3


def level_errors(got, want, tol: float) -> tuple:
    """(largest |got - want|, elements outside tol + tol * |want|) over every level."""
    worst, outside = 0.0, 0
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        diff = (g.float() - w.float()).abs()
        worst = max(worst, float(diff.max()))
        outside += int((diff > tol + tol * w.float().abs()).sum())
    return worst, outside


def detection_records(det) -> list:
    boxes, scores, labels, valid = (t.cpu().numpy() for t in det)
    return [{"image_id": i, "category_id": int(labels[i, j]),
             "bbox": [float(v) for v in boxes[i, j]], "score": float(scores[i, j])}
            for i in range(len(valid)) for j in np.flatnonzero(valid[i])]


def timed_ms(fn, dev, reps: int = 5) -> float:
    """Median host-clock ms of `fn` over `reps` calls after one, each ended
    by a synchronize (the ranks run theirs at the same time)."""
    fn()
    times = []
    for _ in range(reps):
        synchronize(dev)
        t0 = time.perf_counter()
        fn()
        synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def split_forward_job(rank: int, world: int, params: dict) -> dict:
    """16a-c, each rank: the split forward (spatial 2) in f32 and bf16, the
    stem sharded over the batch (data 2, uint8), tensor parallel (model 2,
    f32), each against the unsplit forward in this process."""
    from pytorch_retinanet_tpu_torch import Retinanet
    from pytorch_retinanet_tpu_torch.kernels import KERNELS, reset_launch_counts
    from pytorch_retinanet_tpu_torch.models.retinanet import apply_detector
    from pytorch_retinanet_tpu_torch.parallel.sharding import (
        build_sharded_forward, make_inference_mesh, make_split_forward,
    )

    devices = params["devices"]
    dev = torch.device("cuda", devices[rank]) if params["device"] == "cuda" else torch.device("cpu")
    h, w, b = params["h"], params["w"], SPLIT_BATCH
    rng = np.random.default_rng(16)
    batch8 = torch.from_numpy(rng.integers(0, 256, (2 * b, h, w, 3), dtype=np.uint8)).to(dev)
    sizes = torch.tensor([[float(h), float(w)]] * b, device=dev)

    def launches():
        synchronize(dev)
        return {k.name: k.wrapper.launches for k in KERNELS}

    out = {}
    net = Retinanet(compute_dtype="float32", device=dev, **params["net"])
    images = batch8[:b].float() / 255.0
    with torch.inference_mode():
        want = net.module(images, True)
    # Between gloo ranks tensor parallel gathers every split conv's output
    # through the host, seconds a forward: its time is the checked call's.
    for case, mesh, reps in (("16a f32 spatial 2", {"spatial": 2}, 2),
                             ("16c f32 model 2", {"model": 2}, 0)):
        forward, place = build_sharded_forward(net.module, make_inference_mesh(devices, **mesh))
        synchronize(dev)
        t0 = time.perf_counter()
        got = forward(place(images))
        synchronize(dev)
        out[case] = dict(zip(("max_abs", "outside"), level_errors(got, want, SPLIT_F32_TOL)))
        out[case]["ms"] = (timed_ms(lambda: forward(images), dev, reps) if reps
                           else (time.perf_counter() - t0) * 1e3)
    with torch.inference_mode():
        out["16a f32 unsplit ms"] = timed_ms(lambda: net.module(images, True), dev, reps=2)
    del net, want, got, images
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    net = Retinanet(device=dev, **params["net"])
    split = make_split_forward(net.module, make_inference_mesh(devices, spatial=2))
    unsplit = lambda x, return_levels: net.module(x, return_levels)  # noqa: E731
    images = batch8[:b]
    reset_launch_counts()
    got = net._predict_impl(images, sizes, forward=split)
    out["16a bf16 launches"] = launches()
    want = net._predict_impl(images, sizes, forward=unsplit)
    out["16a bf16 records"] = detection_records(got)
    out["16a bf16 records unsplit"] = detection_records(want)
    with torch.inference_mode(), net._mode(False):
        out["16a bf16 ms"] = timed_ms(lambda: split(images, True), dev)
        out["16a bf16 unsplit ms"] = timed_ms(lambda: unsplit(images, True), dev)

    forward, place = build_sharded_forward(net.module, make_inference_mesh(devices, data=2))
    rows = place(batch8)
    reset_launch_counts()
    got = forward(rows)
    out["16b launches"] = launches()
    with torch.inference_mode(), net._mode(False):
        want = apply_detector(net.module, rows, return_levels=True)
    out["16b bit for bit"] = all(torch.equal(g, v) for g, v in zip(got[0] + got[1],
                                                                    want[0] + want[1]))
    out["16b rows"] = list(rows.shape)
    return out


def spatial_job(rank: int, world: int, params: dict) -> dict:
    """Phase 16, each rank: :func:`split_forward_job`, then 16d's runs:
    the small f32 run (``job_train`` on the spatial mesh; rank 0 saves its
    first step's state) and R50-FPN bf16 (:func:`full_width_job`)."""
    mh = tool("torch_multihost_smoke")
    out = {"forward": split_forward_job(rank, world, params)}
    if params["device"] == "cuda":
        torch.cuda.empty_cache()
    out["small"] = mh.job_train(rank, world, params["small"])
    out["full"] = full_width_job(rank, world, params["full"])
    return out


def spatial_phases(dev) -> None:
    """Phase 16: two gloo ranks sharing the card run the split forward, the
    stem sharded over the batch, tensor parallel (16a-c) and spatial
    training (16d), each against one process."""
    import shutil

    t_phase = time.perf_counter()
    mh = tool("torch_multihost_smoke")
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_spatial")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.join(work, "small"))
    devices = [dev.index or 0] * 2 if dev.type == "cuda" else ["cpu"] * 2
    state = mh.seeded_state(SMALL_NET, seed=3)
    rng = np.random.default_rng(8)
    batches = []
    for n_valid in ([5, 0, 3, 1], [2, 4, 0, 6]):
        boxes, labels, valid = seeded_gt(rng, n_valid, 128, 192)
        batches.append({"images": rng.random((4, 128, 192, 3), dtype=np.float32),
                        "boxes": boxes, "labels": labels, "valid": valid})
    torch.save({"batches": batches, "state": state}, os.path.join(work, "small_data.pt"))
    small_run = {"model": {**SMALL_NET, "freeze_bn": True}, "optimizer": SMALL_OPTIMIZER,
                 "trainer": {"max_steps": 2}, "spatial": 2}
    full = {"hparams": HPARAMS, "device": dev.type, "devices": devices, "batch": SPLIT_BATCH,
            "steps": SPATIAL_STEPS, "h": H, "w": W, "spatial": 2}
    out = join_ranks("16 (two gloo ranks, spatial and tensor-parallel meshes)", mh.RankRun(
        spatial_job, {"device": dev.type, "devices": devices, "net": SPLIT_NET, "h": H, "w": W,
                      "small": {"data": os.path.join(work, "small_data.pt"),
                                "runs": {"spatial": small_run}, "device": dev.type,
                                "devices": devices, "workdir": os.path.join(work, "small")},
                      "full": full},
        timeout=DDP_TIMEOUT, workdir=work))

    bad = []
    for r, o in enumerate(out):
        f = o["forward"]
        for case in ("16a f32 spatial 2", "16c f32 model 2"):
            log(f"[spatial] {case} rank {r}: R50-FPN 90 classes, {SPLIT_BATCH} x {H}x{W} f32 (TF32 "
                f"off) against the unsplit forward: max |diff| {f[case]['max_abs']:.3g}, "
                f"{f[case]['outside']} values outside {SPLIT_F32_TOL} + {SPLIT_F32_TOL} x |value|")
            if f[case]["outside"]:
                bad.append(f"rank {r} {case}")
        recs, ref = f["16a bf16 records"], f["16a bf16 records unsplit"]
        overlap = mh.records_overlap(recs, ref, SPLIT_BF16_BOX_TOL, SPLIT_BF16_SCORE_TOL)
        strict = mh.records_overlap(recs, ref)
        log(f"[spatial] 16a bf16 rank {r}: predict's detections through the split forward against "
            f"the unsplit forward's: {len(recs)} vs {len(ref)} records, overlap {overlap:.4f} at "
            f"box {SPLIT_BF16_BOX_TOL} px / score {SPLIT_BF16_SCORE_TOL} (bar {MERGED_OVERLAP}; "
            f"{strict:.4f} at 1e-3 px / 1e-5); launches {f['16a bf16 launches']}")
        if overlap < MERGED_OVERLAP or len(recs) != len(ref) \
                or f["16a bf16 launches"]["nms_keep_mask"] != 1:
            bad.append(f"rank {r} 16a bf16")
        log(f"[spatial] 16b rank {r}: build_sharded_forward(data=2) on its rows {f['16b rows']} of "
            f"a uint8 batch of {2 * SPLIT_BATCH}: launches {f['16b launches']}; equal to "
            f"apply_detector on those rows bit for bit: {f['16b bit for bit']}")
        if f["16b launches"]["fused_stem"] != 1 or not f["16b bit for bit"]:
            bad.append(f"rank {r} 16b")
        log(f"[time] 16a-c rank {r} (2 gloo ranks on one card; host clock): split forward bf16 "
            f"{f['16a bf16 ms']:.1f} ms against unsplit {f['16a bf16 unsplit ms']:.1f} ms (medians "
            f"of 5); f32 split {f['16a f32 spatial 2']['ms']:.1f} ms against unsplit "
            f"{f['16a f32 unsplit ms']:.1f} ms (medians of 2); model 2 "
            f"{f['16c f32 model 2']['ms']:.1f} ms (its one checked call)")

    c = mh.train_against_one_process(os.path.join(work, "small"), "spatial", small_run, batches,
                                     state, [o["small"] for o in out], dev.type, SMALL_LOSS_RTOL,
                                     SMALL_UPDATE_RTOL)
    log(f"[spatial] 16d small: spatial 2 (2 gloo ranks, one card, each its rows of the trunk) "
        f"against one process, f32 resnet18 128x192 frozen BN, 2 SGD steps: losses "
        f"{c['losses']} vs {c['single']} (worst {c['loss_rel_err']:.2e} rel, limit "
        f"{SMALL_LOSS_RTOL}); first step's update gap {c['update_gap_of_bound']:.3f} of the bound "
        f"({SMALL_UPDATE_RTOL} of the tensor's largest update + 2 ulp) at {c['worst_tensor']}; "
        f"ranks bit for bit {c['ranks_bit_for_bit']}")
    if not c["loss_ok"] or c["update_gap_of_bound"] > 1.0 or not c["ranks_bit_for_bit"]:
        bad.append("16d small")

    torch.cuda.empty_cache()
    one = full_width_job(0, 1, {**full, "spatial": 1, "devices": devices[:1]})
    for r, o in enumerate(out):
        f = o["full"]
        log(f"[spatial] 16d full rank {r}: R50-FPN bf16 frozen BN, batch {SPLIT_BATCH} at {H}x{W}, "
            f"spatial 2: losses {['%.5f' % v for v in f['losses']]}; launches {f['launches']}; "
            f"peak {f['peak_gib'] - f['base_gib']:.2f} GiB above the weights (one process "
            f"{one['peak_gib'] - one['base_gib']:.2f}); step ms "
            f"{['%.1f' % v for v in f['step_ms']]} (one process "
            f"{['%.1f' % v for v in one['step_ms']]})")
        if not np.isfinite(f["losses"]).all() \
                or f["launches"]["match_targets"] != 5 * SPATIAL_STEPS:
            bad.append(f"rank {r} 16d full")
    if out[0]["full"]["digest"] != out[1]["full"]["digest"]:
        bad.append("16d full: the ranks' parameters differ")
    o = out[0]["full"]
    log(f"[time] 16d R50-FPN bf16 batch {SPLIT_BATCH}, spatial 2 on 2 gloo ranks sharing one card "
        f"(not a scaling figure): step median {np.median([v for x in out for v in x['full']['step_ms'][1:]]):.1f} "
        f"ms (steps 2-{SPATIAL_STEPS}, both ranks) against one process "
        f"{np.median(one['step_ms'][1:]):.1f} ms; gloo all-reduce of the {o['n_params']} f32 "
        f"gradients alone {o['grads_ms']:.1f} ms")
    if bad:
        raise SystemExit(f"[spatial] phase 16: {bad}")
    shutil.rmtree(work, ignore_errors=True)
    log(f"[spatial] phase 16 took {time.perf_counter() - t_phase:.1f} s")


def record_key(r: dict) -> tuple:
    return (r["image_id"], -r["score"], r["category_id"], tuple(r["bbox"]))


def merged_conf(base: dict, update: dict) -> dict:
    """`base` with `update` merged in, as plain dicts (they travel to the ranks)."""
    from pytorch_retinanet_tpu_torch import ConfigDict

    return ConfigDict(base).merge(update).to_dict()



# --------------------------------------------------------------------------- #
# Phase 17: the frozen-BN kernel pair at R-50's 53 frozen BNs
# --------------------------------------------------------------------------- #
FROZEN_BN_EPS = 1e-5
# The kernel's per-channel sums against the plain version's (another order
# of addition), as a share of the sum of the terms' magnitudes.
FROZEN_BN_SUM_TOL = 2.0**-14
# (n, c, h, w, dtype, channels-last, ReLU, storage offset in elements): the
# kernels' other paths, beside the main path's channels-last bf16 vectors.
FROZEN_BN_CASES = (
    (2, 3, 9, 11, torch.float32, True, True, 0),  # C not a vector: an element a thread
    (2, 24, 7, 5, torch.bfloat16, True, False, 0),  # 3 vectors a row
    (4, 2048, 5, 7, torch.float32, True, True, 0),  # 512 vectors a row: a row a block
    (1, 4096, 3, 3, torch.bfloat16, True, False, 0),
    (2, 256, 6, 10, torch.bfloat16, True, True, 3),  # unaligned: an element a thread
    (3, 64, 13, 17, torch.bfloat16, False, True, 0),  # NCHW, planes not a vector
    (2, 64, 16, 24, torch.bfloat16, False, False, 0),  # NCHW, vectors
    (2, 128, 10, 12, torch.float32, False, True, 0),
)


def r50_frozen_bn_shapes(batch: int, h: int, w: int) -> list:
    """(n, c, h, w, relu) of R-50's 53 frozen BNs in a forward at h x w, in
    order: the stem's; per block bn1 (at the block's input size), bn2, bn3,
    and the first block's downsample. bn1, bn2 and the stem's fuse their ReLU."""
    shapes = [(batch, 64, h // 2, w // 2, True)]
    hh, ww = h // 4, w // 4
    for stage, (depth, width) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
        for i in range(depth):
            stride = 2 if i == 0 and stage > 0 else 1
            shapes.append((batch, width, hh, ww, True))
            hh, ww = hh // stride, ww // stride
            shapes += [(batch, width, hh, ww, True), (batch, 4 * width, hh, ww, False)]
            if i == 0:
                shapes.append((batch, 4 * width, hh, ww, False))
    return shapes


def frozen_bn_case(shape, dtype, channels_last: bool, offset: int, gen, dev) -> tuple:
    """Seeded x and dy of `shape` in `dtype` and layout (their storage
    starting `offset` elements in), and [C] f32 weight, bias, mean, var."""
    n, c, h, w = shape

    def activation():
        flat = torch.randn(n * c * h * w + offset, generator=gen, device=dev).to(dtype)[offset:]
        if channels_last:
            return flat.view(n, h, w, c).permute(0, 3, 1, 2)
        return flat.view(n, c, h, w)

    x, dy = activation(), activation()
    weight = 0.5 + torch.rand(c, generator=gen, device=dev)
    bias = 0.3 * torch.randn(c, generator=gen, device=dev)
    mean = 0.3 * torch.randn(c, generator=gen, device=dev)
    var = 0.2 + torch.rand(c, generator=gen, device=dev)
    return x, dy, (weight, bias, mean, var)


def check_frozen_bn(fb, x, dy, params, relu: bool) -> tuple:
    """The kernels against the plain version: y and dx bit for bit, in x's
    strides; dweight and dbias within ``FROZEN_BN_SUM_TOL``; the backward
    twice, bit for bit. Returns (max |dweight, dbias gap| / its limit,
    max |dweight, dbias gap|)."""
    what = f"{tuple(x.shape)} {x.dtype} strides {x.stride()} relu {relu}"
    y = fb._launch_forward(x, *params, FROZEN_BN_EPS, relu)
    y_ref = fb.frozen_bn_plain(x, *params, FROZEN_BN_EPS, relu)
    if y.stride() != x.stride() or not torch.equal(y, y_ref):
        raise SystemExit(f"frozen_bn forward differs from its plain version at {what}: "
                         f"{int((y != y_ref).sum())} elements, strides {y.stride()}")
    dx, dw, db = fb._launch_backward(dy, x, *params, FROZEN_BN_EPS, relu)
    again = fb._launch_backward(dy, x, *params, FROZEN_BN_EPS, relu)
    dx_ref, dw_ref, db_ref = fb.frozen_bn_backward_plain(dy, x, *params, FROZEN_BN_EPS, relu)
    if dx.stride() != x.stride() or not torch.equal(dx, dx_ref):
        raise SystemExit(f"frozen_bn dx differs from its plain version at {what}: "
                         f"{int((dx != dx_ref).sum())} elements, strides {dx.stride()}")
    if not all(torch.equal(a, b) for a, b in zip((dx, dw, db), again)):
        raise SystemExit(f"frozen_bn backward is not deterministic at {what}")
    weight, _, mean, var = params
    g = dy.float()
    if relu:
        g = torch.where(y_ref <= 0, torch.zeros((), device=g.device), g)
    xmu = (x.float() - mean[None, :, None, None]).abs()
    limit_w = FROZEN_BN_SUM_TOL * (g.abs() * xmu).sum((0, 2, 3)) / torch.sqrt(var + FROZEN_BN_EPS)
    limit_b = FROZEN_BN_SUM_TOL * g.abs().sum((0, 2, 3))
    gaps = torch.cat([(dw - dw_ref).abs(), (db - db_ref).abs()])
    share = float((gaps / (torch.cat([limit_w, limit_b]) + 1e-30)).max())
    if share > 1.0:
        raise SystemExit(f"frozen_bn dweight / dbias outside {FROZEN_BN_SUM_TOL} of the sums of "
                         f"|terms| at {what}: worst {share:.3f} of the limit")
    return share, float(gaps.max())


def complete_device_ms(fn, launches: int, events_ms: float):
    """Device ms of one call of `fn`, from a ``torch.profiler`` window that
    recorded all of its `launches` kernels and whose kernels add up to 80%
    or more of `events_ms`, the call's CUDA-event time (its launches run
    back to back: the host enqueues them in a fraction of their device
    time). The card's tracer now and then drops or misreads events late in
    a long run; such a window is run again, up to ``PROFILER_WINDOWS`` in
    all. None (not measured) if none was whole."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for window in range(PROFILER_WINDOWS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        if len(kernels) == launches and ms >= 0.8 * events_ms:
            return ms
        log(f"[trace] profiler window {window + 1} of {PROFILER_WINDOWS} recorded {len(kernels)} "
            f"of {launches} kernels, {ms:.3f} ms against the events' {events_ms:.3f}")
    return None


def frozen_bn_phases(dev, results) -> None:
    """Phase 17: the frozen-BN forward and backward kernels against their
    plain version at the other paths' shapes and at R-50's 53 frozen BNs
    (batch 16, 800x1344, bf16 channels-last); through autograd; then their
    times a step beside their byte bounds, the plain version and ATen's
    eval-mode ``F.batch_norm`` (+ ``relu_``) forward and backward."""
    fb = importlib.import_module("pytorch_retinanet_tpu_torch.kernels.frozen_bn")
    fb_wrapper = fb.frozen_batch_norm

    t_phase = time.perf_counter()
    log_build_report("frozen_bn", ("forward_nhwc", "backward_nhwc", "forward_nchw",
                                   "backward_nchw", "finalize"))
    gen = torch.Generator(device=dev).manual_seed(17)
    worst = (0.0, 0.0)
    for n, c, h, w, dtype, cl, relu, offset in FROZEN_BN_CASES:
        x, dy, params = frozen_bn_case((n, c, h, w), dtype, cl, offset, gen, dev)
        worst = max(worst, check_frozen_bn(fb, x, dy, params, relu))
    log(f"[frozen_bn] kernels vs plain at {len(FROZEN_BN_CASES)} other-path shapes: y and dx "
        f"bit for bit in x's strides, backward deterministic, sums at worst {worst[0]:.3g} of "
        f"their limit")

    # Through autograd: the Function's gradients are the kernels'.
    x, dy, params = frozen_bn_case((2, 256, 12, 20), torch.bfloat16, True, 0, gen, dev)
    xr, wr, br = x.clone().requires_grad_(), params[0].clone().requires_grad_(), \
        params[1].clone().requires_grad_()
    before = fb_wrapper.launches
    fb_wrapper(xr, wr, br, params[2], params[3], FROZEN_BN_EPS, True).backward(dy)
    dx, dw, db = fb._launch_backward(dy, x, *params, FROZEN_BN_EPS, True)
    if fb_wrapper.launches - before != 3 or not (
            torch.equal(xr.grad, dx) and torch.equal(wr.grad, dw) and torch.equal(br.grad, db)):
        raise SystemExit("frozen_bn through autograd differs from its kernels' launches")
    log("[frozen_bn] through autograd: x, weight and bias gradients equal the kernels' bit for bit")

    shapes = r50_frozen_bn_shapes(TRAIN_BATCH, H, W)
    elems = sum(n * c * h * w for n, c, h, w, _ in shapes)
    cases = []
    for n, c, h, w, relu in shapes:
        x, dy, params = frozen_bn_case((n, c, h, w), torch.bfloat16, True, 0, gen, dev)
        cases.append((x, dy, params, relu))
    worst = max(check_frozen_bn(fb, x, dy, p, relu) for x, dy, p, relu in cases)
    torch.cuda.empty_cache()
    log(f"[frozen_bn] kernels vs plain at R-50's {len(shapes)} frozen BNs ({elems / 1e9:.3f} G "
        f"elements, {sum(s[4] for s in shapes)} with ReLU): y and dx bit for bit, sums at worst "
        f"{worst[0]:.3g} of their limit (largest gap {worst[1]:.3g})")
    r = results["frozen_bn"]
    r["max_abs_err"] = worst[1]

    def forward():
        return [fb._launch_forward(x, *p, FROZEN_BN_EPS, relu) for x, _, p, relu in cases]

    def backward():
        return [fb._launch_backward(dy, x, *p, FROZEN_BN_EPS, relu) for x, dy, p, relu in cases]

    def plain():
        for x, dy, p, relu in cases:
            fb.frozen_bn_plain(x, *p, FROZEN_BN_EPS, relu)
            fb.frozen_bn_backward_plain(dy, x, *p, FROZEN_BN_EPS, relu)

    def through_autograd(fn, backward_too: bool):
        """The 53 layers' forwards under autograd, then (one engine call, as
        a step's backward) their backwards."""
        def step():
            ys = [fn(x.detach().requires_grad_(), w.detach().requires_grad_(),
                     b.detach().requires_grad_(), m, v, relu)
                  for x, _, (w, b, m, v), relu in cases]
            if backward_too:
                torch.autograd.backward(ys, [dy for _, dy, _, _ in cases])
        return step

    def aten(x, w, b, m, v, relu):
        y = F.batch_norm(x, m, v, w, b, False, 0.0, FROZEN_BN_EPS)
        return torch.relu_(y) if relu else y

    def port(x, w, b, m, v, relu):
        return fb_wrapper(x, w, b, m, v, FROZEN_BN_EPS, relu)

    r["forward_ms"] = time_ms(forward, 5)
    r["backward_ms"] = time_ms(backward, 5)
    # A launch a forward; the backward's pass and its finalize.
    fwd_device = complete_device_ms(forward, len(cases), r["forward_ms"])
    bwd_device = complete_device_ms(backward, 2 * len(cases), r["backward_ms"])
    r["forward_bound_ms"] = elems * 4 / HBM_BYTES_PER_S * 1e3  # bf16 x in, y out
    r["backward_bound_ms"] = elems * 6 / HBM_BYTES_PER_S * 1e3  # bf16 x, dy in, dx out
    r["ms"] = r["forward_ms"] + r["backward_ms"]
    if fwd_device is not None and bwd_device is not None:
        r["forward_device_ms"], r["backward_device_ms"] = fwd_device, bwd_device
        r["device_ms"] = fwd_device + bwd_device

    def device(ms, bound):
        return "not measured" if ms is None else f"{ms:.3f}, {ms / bound:.2f}x the bound"
    r["bound_ms"], r["bound_by"] = r["forward_bound_ms"] + r["backward_bound_ms"], "bytes"
    r["plain_ms"] = time_ms(plain, 2, warmup=1)
    library = {"forward": time_ms(through_autograd(aten, False), 3),
               "forward+backward": time_ms(through_autograd(aten, True), 3)}
    ours = {"forward": time_ms(through_autograd(port, False), 3),
            "forward+backward": time_ms(through_autograd(port, True), 3)}
    r["library_ms"] = library["forward+backward"]
    r["library_forward_ms"] = library["forward"]
    r["library_backward_ms"] = library["forward+backward"] - library["forward"]
    r["autograd_forward_ms"] = ours["forward"]
    r["autograd_backward_ms"] = ours["forward+backward"] - ours["forward"]
    log(f"[time] frozen_bn a R-50 step (batch {TRAIN_BATCH}, {H}x{W}, bf16): forward "
        f"{r['forward_ms']:.3f} ms (bound {r['forward_bound_ms']:.3f} by bytes; device "
        f"{device(fwd_device, r['forward_bound_ms'])}), backward {r['backward_ms']:.3f} ms "
        f"(bound {r['backward_bound_ms']:.3f}; device {device(bwd_device, r['backward_bound_ms'])}); "
        f"plain forward+backward {r['plain_ms']:.3f} ms; through autograd forward "
        f"{r['autograd_forward_ms']:.3f}, backward {r['autograd_backward_ms']:.3f} ms against "
        f"ATen's eval F.batch_norm (+relu_) {r['library_forward_ms']:.3f} / "
        f"{r['library_backward_ms']:.3f} ms (timed only; the port does not call it here)")
    log_kernel_time(r)
    del cases
    torch.cuda.empty_cache()
    log(f"[frozen_bn] phase 17 took {time.perf_counter() - t_phase:.1f} s")


# The focal pair beyond R-50's levels: (B, A, C, dtype, storage offset):
# fewer classes than a vector, heads and tails around each image's run,
# unaligned storage (one element a thread), f32.
FOCAL_CASES = ((2, 37, 3, torch.bfloat16, 0), (3, 50, 7, torch.float32, 0),
               (4, 1000, 20, torch.bfloat16, 0), (2, 693, 90, torch.bfloat16, 1),
               (3, 101, 5, torch.float32, 3), (2, 693, 90, torch.float32, 0))
FOCAL_LEVELS = (151200, 37800, 9450, 2457, 693)  # R-50's anchors a level at 800x1344
FOCAL_SUM_TOL = 1e-6
FOCAL_ALPHA, FOCAL_GAMMA = 0.25, 2.0


def focal_case(b: int, a: int, c: int, dtype, offset: int, gen, dev) -> tuple:
    """Seeded logits of [b, a, c] in `dtype` (storage `offset` elements in)
    around the head's prior (-4.6), labels, matches (1% foreground, 2%
    ignored, the rest background) and an upstream gradient [b]."""
    flat = (torch.randn(b * a * c + offset, generator=gen, device=dev) * 2 - 4.6).to(dtype)
    x = flat[offset:].view(b, a, c)
    u = torch.rand(b, a, generator=gen, device=dev)
    matches = torch.where(u < 0.01, 0, torch.where(u < 0.03, -2, -1)).to(torch.int32)
    labels = torch.where(u < 0.01, torch.randint(1, c + 1, (b, a), generator=gen, device=dev),
                         0).to(torch.int32)
    grad = torch.rand(b, generator=gen, device=dev) + 0.5
    return x, labels, matches, grad


def check_focal(fl, x, labels, matches, grad) -> float:
    """The kernels against the plain version: the sums within
    ``FOCAL_SUM_TOL`` of the sums of their terms' magnitudes, dx within 1
    bf16 ulp of the larger value (bf16) or ``FOCAL_SUM_TOL`` of the largest
    |dx| (f32); each twice, bit for bit. Returns (the sum gap as a share of
    its limit, the largest sum gap)."""
    what = f"{tuple(x.shape)} {x.dtype} at offset {x.storage_offset()}"
    out = fl._launch_forward(x, labels, matches, FOCAL_ALPHA, FOCAL_GAMMA)
    again = fl._launch_forward(x, labels, matches, FOCAL_ALPHA, FOCAL_GAMMA)
    ref = fl.focal_loss_sums_plain(x, labels, matches, FOCAL_ALPHA, FOCAL_GAMMA)
    xf = x.float()
    terms = ((torch.clamp(xf, min=0) + torch.log1p(torch.exp(-xf.abs()))).sum(-1)
             * (matches >= -1)).sum(1)
    del xf
    share = float(((out - ref).abs() / (FOCAL_SUM_TOL * terms)).max())
    if not torch.equal(out, again) or share > 1.0:
        raise SystemExit(f"focal forward at {what}: sums {out.tolist()[:4]} against the plain "
                         f"{ref.tolist()[:4]} ({share:.3g} of the limit), twice equal "
                         f"{torch.equal(out, again)}")
    dx = fl._launch_backward(grad, x, labels, matches, FOCAL_ALPHA, FOCAL_GAMMA)
    dx_again = fl._launch_backward(grad, x, labels, matches, FOCAL_ALPHA, FOCAL_GAMMA)
    dx_ref = fl.focal_loss_backward_plain(grad, x, labels, matches, FOCAL_ALPHA, FOCAL_GAMMA)
    diff = (dx.float() - dx_ref.float()).abs()
    if x.dtype == torch.bfloat16:
        bad = int((diff > bf16_ulp(torch.maximum(dx.float().abs(), dx_ref.float().abs()))).sum())
    else:
        bad = int((diff > FOCAL_SUM_TOL * float(dx_ref.abs().max())).sum())
    if bad or not torch.equal(dx, dx_again) or dx.dtype != x.dtype:
        raise SystemExit(f"focal backward at {what}: {bad} elements outside the tolerance, "
                         f"twice equal {torch.equal(dx, dx_again)}")
    log(f"[focal] {what}: sums at {share:.3g} of their limit, dx {int((diff == 0).sum())} of "
        f"{diff.numel()} equal to the plain version's, the rest within the tolerance")
    return share, float((out - ref).abs().max())


def focal_phases(dev, results) -> None:
    """Phase 18: the focal forward and backward kernels against their
    plain version at the other paths' shapes and at R-50's five levels
    (batch 16, 800x1344, 90 classes, bf16); through autograd; then their
    times a step beside their byte bounds, the plain version and ATen's
    composition under autograd."""
    fl = importlib.import_module("pytorch_retinanet_tpu_torch.kernels.focal")
    from pytorch_retinanet_tpu_torch.ops import sigmoid_focal_loss

    wrapper = fl.focal_loss_sums
    t_phase = time.perf_counter()
    log_build_report("focal", ("focal_kernel", "finalize"))
    gen = torch.Generator(device=dev).manual_seed(18)
    worst = max(check_focal(fl, *focal_case(*case, gen, dev)) for case in FOCAL_CASES)
    log(f"[focal] kernels vs plain at {len(FOCAL_CASES)} other-path shapes: sums at worst "
        f"{worst[0]:.3g} of their limit, dx within its tolerance, each twice bit for bit")

    # Through autograd: the Function's sums and gradient are the kernels'.
    x, labels, matches, grad = focal_case(2, 693, 90, torch.bfloat16, 0, gen, dev)
    xr = x.clone().requires_grad_()
    before = wrapper.launches
    out = wrapper(xr, labels, matches, FOCAL_ALPHA, FOCAL_GAMMA)
    out.backward(grad)
    if wrapper.launches - before != 2 or not (
            torch.equal(out.detach(), fl._launch_forward(x, labels, matches, FOCAL_ALPHA,
                                                         FOCAL_GAMMA))
            and torch.equal(xr.grad, fl._launch_backward(grad, x, labels, matches, FOCAL_ALPHA,
                                                         FOCAL_GAMMA))):
        raise SystemExit("focal through autograd differs from its kernels' launches")
    log("[focal] through autograd: the sums and the logits' gradient equal the kernels' bit for bit")

    cases = [focal_case(TRAIN_BATCH, a, 90, torch.bfloat16, 0, gen, dev) for a in FOCAL_LEVELS]
    worst = max(check_focal(fl, *case) for case in cases)
    torch.cuda.empty_cache()
    elems = sum(x.numel() for x, *_ in cases)
    side = sum(2 * 4 * l.numel() for _, l, _, _ in cases)  # labels and matches, int32
    log(f"[focal] kernels vs plain at R-50's 5 levels ({elems / 1e6:.1f} M logits): sums at worst "
        f"{worst[0]:.3g} of their limit (largest gap {worst[1]:.3g})")
    r = results["focal_loss"]

    def forward():
        return [fl._launch_forward(x, l, m, FOCAL_ALPHA, FOCAL_GAMMA) for x, l, m, _ in cases]

    def backward():
        return [fl._launch_backward(g, x, l, m, FOCAL_ALPHA, FOCAL_GAMMA) for x, l, m, g in cases]

    def plain():
        for x, l, m, g in cases:
            fl.focal_loss_sums_plain(x, l, m, FOCAL_ALPHA, FOCAL_GAMMA)
            fl.focal_loss_backward_plain(g, x, l, m, FOCAL_ALPHA, FOCAL_GAMMA)

    def through_autograd(fn, backward_too: bool):
        """The 5 levels' sums under autograd, then (one engine call, as a
        step's backward) their backwards."""
        def step():
            outs = [fn(x.detach().requires_grad_(), l, m) for x, l, m, _ in cases]
            if backward_too:
                torch.autograd.backward(outs, [g for *_, g in cases])
        return step

    def aten(x, labels, matches):
        """The loss's classification term before the pair."""
        onehot = (labels[..., None] == torch.arange(1, x.shape[-1] + 1, dtype=labels.dtype,
                                                   device=x.device)).float()
        elem = sigmoid_focal_loss(x.float(), onehot, FOCAL_ALPHA, FOCAL_GAMMA)
        return (elem.sum(-1) * (matches >= -1).float()).sum(1)

    def port(x, labels, matches):
        return wrapper(x, labels, matches, FOCAL_ALPHA, FOCAL_GAMMA)

    r["forward_ms"] = time_ms(forward, 10)
    r["backward_ms"] = time_ms(backward, 10)
    # The forward's pass and its finalize a level; the backward's pass.
    fwd_device = complete_device_ms(forward, 2 * len(cases), r["forward_ms"])
    bwd_device = complete_device_ms(backward, len(cases), r["backward_ms"])
    r["forward_bound_ms"] = (elems * 2 + side) / HBM_BYTES_PER_S * 1e3  # bf16 logits in
    r["backward_bound_ms"] = (elems * 4 + side) / HBM_BYTES_PER_S * 1e3  # logits in, dx out
    r["ms"] = r["forward_ms"] + r["backward_ms"]
    if fwd_device is not None and bwd_device is not None:
        r["forward_device_ms"], r["backward_device_ms"] = fwd_device, bwd_device
        r["device_ms"] = fwd_device + bwd_device

    def device(ms, bound):
        return "not measured" if ms is None else f"{ms:.3f}, {ms / bound:.2f}x the bound"
    r["bound_ms"], r["bound_by"] = r["forward_bound_ms"] + r["backward_bound_ms"], "bytes"
    r["max_abs_err"] = worst[1]
    r["plain_ms"] = time_ms(plain, 2, warmup=1)
    torch.cuda.empty_cache()
    library = {"forward": time_ms(through_autograd(aten, False), 3),
               "forward+backward": time_ms(through_autograd(aten, True), 3)}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    through_autograd(aten, True)()
    torch.cuda.synchronize()
    library_peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    through_autograd(port, True)()
    torch.cuda.synchronize()
    port_peak = torch.cuda.max_memory_allocated() - base
    ours = {"forward": time_ms(through_autograd(port, False), 3),
            "forward+backward": time_ms(through_autograd(port, True), 3)}
    r["library_ms"] = library["forward+backward"]
    r["library_forward_ms"] = library["forward"]
    r["library_backward_ms"] = library["forward+backward"] - library["forward"]
    r["autograd_forward_ms"] = ours["forward"]
    r["autograd_backward_ms"] = ours["forward+backward"] - ours["forward"]
    log(f"[time] focal_loss a R-50 step (batch {TRAIN_BATCH}, {H}x{W}, 90 classes, bf16): forward "
        f"{r['forward_ms']:.3f} ms (bound {r['forward_bound_ms']:.3f} by bytes; device "
        f"{device(fwd_device, r['forward_bound_ms'])}), backward {r['backward_ms']:.3f} ms "
        f"(bound {r['backward_bound_ms']:.3f}; device {device(bwd_device, r['backward_bound_ms'])}); "
        f"plain forward+backward {r['plain_ms']:.3f} ms; through autograd forward "
        f"{r['autograd_forward_ms']:.3f}, backward {r['autograd_backward_ms']:.3f} ms against "
        f"ATen's composition (f32 cast, one-hot, sigmoid_focal_loss) {r['library_forward_ms']:.3f} / "
        f"{r['library_backward_ms']:.3f} ms; peak memory above the inputs through forward and "
        f"backward {port_peak / 2**30:.3f} GiB against the composition's "
        f"{library_peak / 2**30:.3f} GiB")
    log_kernel_time(r)
    del cases
    torch.cuda.empty_cache()
    log(f"[focal] phase 18 took {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card only",
              file=sys.stderr)
        return 2
    # The data slice decodes and resizes with cv2 and reads CSVs with pandas.
    missing = [name for name in ("cv2", "pandas") if importlib.util.find_spec(name) is None]
    if missing:
        print(f"chip_smoke: missing Python package(s) {missing}: the port's data layer needs "
              "cv2 and pandas", file=sys.stderr)
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
    libs = build(["stem", "nms", "match", "bottleneck", "top2", "frozen_bn", "focal"])
    log(f"[build] {len(libs)} kernels built in {time.time() - t0:.1f} s")
    for name, path in libs.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    results = {k.name: {"name": k.name, "route": k.route, "source": k.source,
                        "replaces": k.replaces} for k in KERNELS}
    # 17 and 18 run first: late in a long run the card's profiler drops kernel events.
    frozen_bn_phases(dev, results)
    torch.cuda.empty_cache()
    focal_phases(dev, results)
    torch.cuda.empty_cache()
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
            stem_times = device_times(lambda: stem_forward(x, mean, std, w, scale, bias), 20)
            st["device_ms"] = device_ms(stem_times, ("stem_kernel",))
            log_device_times(f"fused_stem at {tuple(x.shape)} uint8 (the wrapper packs the "
                             "weights on each call)", stem_times)
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
    flat_heads = flat_head_outputs(net, batch)
    del gpu_net, cpu_net, x, stem_in
    torch.cuda.empty_cache()

    fused_trunk_phases(dev, results, net, batch, sizes)
    del net, batch
    torch.cuda.empty_cache()

    step_ms, fitted7 = training_phases(dev, results)
    torch.cuda.empty_cache()

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_engine")
    engine_main_path(dev, results, images, work)
    live_bn_phases(dev)
    torch.cuda.empty_cache()
    test_ref = data_eval_phases(dev, step_ms)
    torch.cuda.empty_cache()
    export_serve_phases(dev)
    torch.cuda.empty_cache()
    ddp_phases(dev, fitted7, test_ref)
    torch.cuda.empty_cache()
    flat_path_phases(dev, flat_heads)
    torch.cuda.empty_cache()
    spatial_phases(dev)

    log(json.dumps({"kernels": [results[k.name] for k in KERNELS]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
