"""One row per hand-written kernel of the port: its time on the card beside its bound.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/torch_kernel_table.py [NAME ...] [--json PATH]

Every kernel of ``kernels.KERNELS`` has a case here, keyed by its name: the
main path's inputs it is timed on, its plain version and a library
yardstick. The tool raises for a registry entry without a case, so a new
kernel adds its case here (and its checks as parameters of
``tests/test_torch_cuda.py``). With no NAME it times every kernel, each in
profiler windows of its own. A row holds:

- ``ms``: CUDA events around the wrapper, per call, after a warm-up;
- ``device_ms``: the hand-written kernels' own device time per call, from a
  ``torch.profiler`` window (``launches_per_call``: their launches the
  window recorded in one call of the case, not a count of the main path's;
  the card tests assert those);
- ``bound_ms``: the larger of the bytes the call needs at 3.35 TB/s and its
  operations at 989 TFLOP/s (bf16 tensor cores) or 67 TFLOP/s (f32);
- ``plain_ms`` and ``library_ms``: the plain version and the yardstick.

The cases take their shapes and seeded inputs from
``tools/torch_main_path.py``, as ``tests/test_torch_cuda.py`` does:
``fused_stem`` at [32, 800, 1344, 3] from uint8 (from f32 beside it); ``nms_keep_mask`` on the candidates of R50-FPN predict (prior
0.5, seed 0) on 32 seeded 800x1333 images; ``match_targets`` over the five
levels of the 800x1344 bucket at batch 16 with 100 padded GT rows (per level
too, with the share of pairs the block cull stages); ``fused_bottleneck``
at the three R50 stages at batch 32, summed over the 10 blocks of a forward
(per stage too: launch configuration, registers, weight packing and the
kernel's phase trace); ``top2_classes`` at [32 x 151200, 90] bf16;
``frozen_bn`` at R-50's 53 frozen BNs and ``focal_loss`` at R-50's five
levels, batch 16, bf16, forward and backward, each beside ATen's
composition under autograd. The last lines are the table as one JSON line
(``{"kernels": [...]}``) and the card's name and power limit. Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import re
import subprocess
import sys
import time
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_main_path import (  # noqa: E402
    BATCH, BOTTLENECK_STAGES, H, LEVEL_ANCHORS, MAX_GT, TRAIN_BATCH, W, bottleneck_inputs,
    focal_inputs, frozen_bn_inputs, main_path_batch, main_path_net, match_inputs,
    r50_frozen_bn_shapes,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_TENSOR_FLOPS = 989e12  # H100 SXM dense bf16
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
FOCAL_ALPHA, FOCAL_GAMMA = 0.25, 2.0
FROZEN_BN_EPS = 1e-5
PROFILER_WINDOWS = 3


def time_ms(fn: Callable, iters: int, warmup: int = 2) -> float:
    """CUDA-event ms per call of ``fn`` over `iters` calls after `warmup`."""
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


def profile(fn: Callable, iters: int = 10) -> Dict[str, tuple]:
    """CUDA kernel name -> (device us per call, launches per call), from one
    ``torch.profiler`` window of `iters` calls after a warm-up. A window that
    recorded no kernel (the tracer now and then returns an empty one) is run
    again, up to ``PROFILER_WINDOWS`` in all; then the device time is not
    measured and this raises. Where the tracer dropped an event, the mean
    launch times the whole number of launches a call stands for the call."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as window

    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILER_WINDOWS):
        with window(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels: Dict[str, tuple] = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                m = re.search(r"(\w+_kernel)\b", e.name)
                name = m.group(1) if m else e.name[:60]
                us, n = kernels.get(name, (0.0, 0))
                kernels[name] = (us + e.time_range.elapsed_us(), n + 1)
        if kernels:
            per_call = {k: max(round(n / iters), 1) for k, (_, n) in kernels.items()}
            return {k: (us / n * per_call[k], per_call[k]) for k, (us, n) in kernels.items()}
        print(f"[trace] profiler window {attempt + 1} of {PROFILER_WINDOWS} recorded no CUDA "
              "kernel", flush=True)
    raise SystemExit("the profiler recorded no CUDA kernel: device time not measured")


def profile_line(what: str, kernels: Dict[str, tuple]) -> str:
    return (f"[trace] {what}: device {sum(us for us, _ in kernels.values()):.1f} us per call ("
            + ", ".join(f"{k} {us:.1f} us x{n:g}" for k, (us, n) in kernels.items()) + ")")


def timed(fn: Callable, iters: int, names: Optional[tuple] = None) -> dict:
    """``ms`` by CUDA events; ``device_ms`` and ``launches_per_call`` of the
    profiled kernels named in `names` (all of them without)."""
    kernels = profile(fn, iters)
    mine = {k: v for k, v in kernels.items() if names is None or k in names}
    if not mine:
        raise SystemExit(f"the profiler recorded none of {names} in {sorted(kernels)}: device "
                         "time not measured")
    return {"ms": time_ms(fn, iters), "device_ms": sum(us for us, _ in mine.values()) / 1e3,
            "launches_per_call": sum(n for _, n in mine.values())}


def bound(nbytes: float, ops: float, ops_per_s: float) -> dict:
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops
            else "operations"}


def build_report(name: str, functions) -> str:
    """Each kernel function's registers and spills, from the ``-Xptxas -v``
    log that the build keeps beside the library."""
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
    return f"[build] {name}.cu: " + "; ".join(
        f"{fn} {regs} registers, {st} B spill stores, {ld} B spill loads"
        for fn, (regs, st, ld) in report.items())


# --------------------------------------------------------------------------- #
# The cases, one a kernel of the registry
# --------------------------------------------------------------------------- #
def stem_case(dev) -> dict:
    from pytorch_retinanet_tpu_torch.config import MEAN, STD
    from pytorch_retinanet_tpu_torch.kernels import stem_forward, stem_plain

    gen = torch.Generator().manual_seed(0)
    w = (torch.randn((64, 3, 7, 7), generator=gen) * (2.0 / (64 * 49)) ** 0.5).to(dev)
    scale = (0.5 + torch.rand(64, generator=gen)).to(dev)
    bias = (torch.randn(64, generator=gen) * 0.3).to(dev)
    raw = torch.randint(0, 256, (BATCH, H, W, 3), generator=gen, dtype=torch.uint8).to(dev)
    wcl = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    flops = 2.0 * BATCH * (H // 2) * (W // 2) * 64 * 147
    rows = {}
    for x, mean, std in ((raw.float() / 255.0, MEAN, STD),
                         (raw, tuple(m * 255.0 for m in MEAN), tuple(s * 255.0 for s in STD))):
        mean_t, std_t = (torch.tensor(c, dtype=torch.float32, device=dev) for c in (mean, std))

        def cudnn_stem(x=x, mean_t=mean_t, std_t=std_t):
            xb = ((x.float() - mean_t) / std_t).to(torch.bfloat16).permute(0, 3, 1, 2)
            y = torch.relu(F.conv2d(xb, wcl, stride=2, padding=3) * scale[:, None, None].bfloat16()
                           + bias[:, None, None].bfloat16())
            return F.max_pool2d(y, 3, 2, 1)

        r = timed(lambda: stem_forward(x, mean, std, w, scale, bias), 20, ("stem_kernel",))
        nbytes = x.numel() * x.element_size() + BATCH * (H // 4) * (W // 4) * 64 * 2 \
            + w.numel() * 4 + 2 * 64 * 4 + 6 * 4
        r.update(bound(nbytes, flops, BF16_TENSOR_FLOPS),
                 plain_ms=time_ms(lambda: stem_plain(x, mean, std, w, scale, bias), 5),
                 library_ms=time_ms(cudnn_stem, 20))
        rows[x.dtype] = r
    print("[fused_stem] from f32 (not the table's row): " + row_text(rows[torch.float32]))
    return rows[torch.uint8]


def predict_candidates(net, batch, sizes) -> tuple:
    """The class-offset boxes and valid flags that ``predict`` hands the NMS
    kernel for `batch`."""
    from pytorch_retinanet_tpu_torch.models import apply_detector
    from pytorch_retinanet_tpu_torch.ops import merge_candidates, multilevel_candidates

    with torch.inference_mode():
        cls_l, box_l = apply_detector(net.module, batch, return_levels=True)
        cand = multilevel_candidates(cls_l, box_l, net._anchors_for(tuple(batch.shape[1:3])))
        cboxes, _, cidx, valid = merge_candidates(*cand, sizes)
    return cboxes + (cidx.float() * 4097.0)[..., None], valid


def nms_case(dev) -> dict:
    from pytorch_retinanet_tpu_torch.kernels import nms_keep_mask, nms_keep_mask_plain

    _, batch, sizes = main_path_batch(dev)
    boxes, valid = predict_candidates(main_path_net(), batch, sizes)
    r = timed(lambda: nms_keep_mask(boxes, valid, 0.5), 50)
    nv = valid.sum(dim=1).double()
    pairs = float((nv * (nv - 1) / 2).sum())  # the IoU pairs these candidates need
    r.update(bound(boxes.numel() * 4 + 2 * valid.numel(), pairs * 12, F32_FLOPS),
             plain_ms=time_ms(lambda: nms_keep_mask_plain(boxes, valid, 0.5), 3), library_ms=None)
    print(f"[nms_keep_mask] predict's candidates {list(valid.shape)}, {int(valid.sum())} valid; "
          + build_report("nms", ("nms_mask_kernel", "nms_scan_kernel")))
    return r


def match_cull_counts(anchors, gt_boxes, gt_valid, block: int = 256) -> tuple:
    """What the match kernel's block cull leaves to compute (``csrc/match.cu``,
    step 2): the (anchor, valid GT row) pairs it stages, per block of 256
    anchors the valid rows that overlap the block's bounding box; and its
    (block, valid GT row) overlap tests."""
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


def match_levels(dev) -> tuple:
    """The five levels' anchors of the 800x1344 bucket and the training
    shapes' GT, with a line a level: its device time and the share of valid
    (anchor, GT row) pairs the block cull stages."""
    from pytorch_retinanet_tpu_torch.kernels import match_targets
    from pytorch_retinanet_tpu_torch.ops import generate_anchors_per_level

    levels = [torch.from_numpy(a).to(dev) for a in generate_anchors_per_level((H, W))]
    gt = match_inputs(levels, dev)
    for i, a in enumerate(levels):
        staged, _ = match_cull_counts(a, gt[0], gt[2])
        share = staged / max(float(gt[2].sum()) * a.shape[0], 1.0)
        print(profile_line(f"match_targets level {i} [{TRAIN_BATCH}, {a.shape[0]}], {share:.2%} of "
                           "the valid (anchor, GT row) pairs staged",
                           profile(lambda: match_targets(a, *gt), 20)))
    return levels, gt


def match_case(dev) -> dict:
    from pytorch_retinanet_tpu_torch.kernels import match_targets, match_targets_plain

    levels, gt = match_levels(dev)
    r = timed(lambda: [match_targets(a, *gt) for a in levels], 20)
    n_anchors = sum(a.shape[0] for a in levels)
    staged, tested = (sum(c) for c in zip(*(match_cull_counts(a, gt[0], gt[2]) for a in levels)))
    nbytes = n_anchors * 16 + TRAIN_BATCH * MAX_GT * (16 + 4 + 1) + TRAIN_BATCH * n_anchors * 24
    # What these inputs need after the cull: 12 flop a staged IoU pair, 4
    # compares a (block, valid row) test, 4 min / max an anchor for the boxes.
    r.update(bound(nbytes, staged * 12 + tested * 4 + n_anchors * 4, F32_FLOPS),
             plain_ms=time_ms(lambda: [match_targets_plain(a, *gt) for a in levels], 3),
             library_ms=None)  # no single PyTorch call computes the match and its targets
    print(build_report("match", ("match_kernel",)))
    return r


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


def phase_trace_line(args) -> str:
    """Where a CTA's time goes, from the kernel's phase trace: mean us per
    CTA in conv1, conv2's wgmma and epilogue and conv3 (epilogues apart),
    the share of cycles waiting for weight slots, CTAs at once."""
    from pytorch_retinanet_tpu_torch.kernels import BOTTLENECK_TRACE_FIELDS, bottleneck_phase_trace

    bottleneck_phase_trace(*args)  # warm
    tr = bottleneck_phase_trace(*args).double()
    f = {k: tr[:, i] for i, k in enumerate(BOTTLENECK_TRACE_FIELDS)}
    us = {"CTA": (f["end_ns"] - f["start_ns"]) / 1e3,
          "conv1": (f["conv1_done_ns"] - f["start_ns"]) / 1e3,
          "conv1 epilogues": f["conv1_epilogue_ns"] / 1e3,
          "conv2 wgmma": (f["conv2_wgmma_done_ns"] - f["conv1_done_ns"]) / 1e3,
          "conv2 epilogue": (f["y2_written_ns"] - f["conv2_wgmma_done_ns"]) / 1e3,
          "conv3": (f["end_ns"] - f["y2_written_ns"]) / 1e3,
          "conv3 epilogues": f["conv3_epilogue_ns"] / 1e3}
    span = (f["end_ns"].max() - f["start_ns"].min()) / 1e6
    busy = (f["end_ns"] - f["start_ns"]).sum() / 1e6
    cycles = f["cycles"].sum()
    return (f"{len(tr)} CTAs on {int(f['sm'].unique().numel())} SMs over {span:.4f} ms, "
            f"{busy / span:.1f} at once; mean us per CTA: "
            + ", ".join(f"{k} {v.mean():.2f}" for k, v in us.items())
            + f"; waiting for weight slots {f['full_wait_cycles'].sum() / cycles:.3f} of a CTA's "
            f"cycles ({f['conv1_full_wait_cycles'].sum() / cycles:.3f} in conv1)")


def bottleneck_case(dev) -> dict:
    from pytorch_retinanet_tpu_torch.kernels import (
        bottleneck_launch_config, bottleneck_plain, fused_bottleneck, pack_bottleneck_weights,
    )

    print(build_report("bottleneck", [f"bottleneck_kernelILi{m}E" for m in (128, 256, 512)]))
    tot = dict.fromkeys(("ms", "device_ms", "launches_per_call", "plain_ms", "library_ms",
                         "bytes_ms", "ops_ms"), 0.0)
    for i, (h, w, mid, blocks) in enumerate(BOTTLENECK_STAGES):
        args = bottleneck_inputs(dev, BATCH, h, w, mid, seed=10 + i)
        c, block = 4 * mid, cudnn_block(args, dev)
        x_nchw = args[0].permute(0, 3, 1, 2)
        with torch.inference_mode():
            t = timed(lambda: fused_bottleneck(*args), 10, ("bottleneck_kernel",))
            t["plain_ms"] = time_ms(lambda: bottleneck_plain(*args), 3)
            t["library_ms"] = time_ms(lambda: block(x_nchw), 10)
            pack_ms = time_ms(lambda: pack_bottleneck_weights(args[1], args[4], args[7]), 10)
        weights = (2 * c * mid + 9 * mid * mid) * 2 + (2 * mid + 2 * mid + 2 * c) * 4
        flops = 2.0 * BATCH * h * w * (2 * c * mid + 9 * mid * mid)
        t["bytes_ms"] = (2 * args[0].numel() * 2 + weights) / HBM_BYTES_PER_S * 1e3
        t["ops_ms"] = flops / BF16_TENSOR_FLOPS * 1e3
        cfg = bottleneck_launch_config(mid, h, w, BATCH)
        print(f"[fused_bottleneck] [{BATCH}, {h}, {w}, {c}] mid {mid}, {blocks} a forward: "
              f"kernel {t['ms']:.4f} ms, device {t['device_ms']:.4f} ms "
              f"({flops / t['device_ms'] / 1e9:.1f} TFLOP/s of useful work), plain "
              f"{t['plain_ms']:.4f}, cuDNN Bottleneck module {t['library_ms']:.4f}, bound "
              f"{max(t['bytes_ms'], t['ops_ms']):.4f} ms (bytes {t['bytes_ms']:.4f}, operations "
              f"{t['ops_ms']:.4f}); weight packing alone {pack_ms:.4f} ms; tile {cfg['tile_h']}x"
              f"{cfg['tile_w']}, cluster {cfg['cluster']}, {cfg['ctas']} CTAs of {cfg['threads']} "
              f"threads, {cfg['smem_bytes']} B dynamic shared memory ({cfg['slots']} ring slots of "
              f"{cfg['slot_bytes']} B), {cfg['ctas_per_sm']} CTA(s) per SM, "
              f"{cfg['ctas'] * 34 * mid * mid / 1e9:.2f} GB of weights through L2; "
              + phase_trace_line(args))
        for k in tot:
            tot[k] += blocks * t[k]
        del args, block, x_nchw
    print(fused_trunk_line(dev, tot["ms"], tot["library_ms"]))
    return {**{k: tot[k] for k in ("ms", "device_ms", "plain_ms", "library_ms")},
            "launches_per_call": int(tot["launches_per_call"]),
            "bound_ms": max(tot["bytes_ms"], tot["ops_ms"]),
            "bound_by": "operations" if tot["ops_ms"] >= tot["bytes_ms"] else "bytes"}


def fused_trunk_line(dev, kernel_ms: float, module_blocks_ms: float) -> str:
    """The R50 trunk of predict's batch through the fused trunk against the
    module's, in turns (module, fused, fused, module), and where the fused
    trunk's time goes: the 10 kernel launches (`kernel_ms`, from the stage
    times), their arguments (BN fold, bf16 GEMM-layout weights), the 6
    blocks left to cuDNN against their module blocks."""
    from pytorch_retinanet_tpu_torch.kernels import bottleneck_args, stem_forward
    from pytorch_retinanet_tpu_torch.models import apply_trunk_fused, stem_constants

    _, batch, _ = main_path_batch(dev)
    module = main_path_net().module
    resnet = module.backbone.backbone
    fused_blocks = [blk for stage, depth in ((2, 4), (3, 6), (4, 3))
                    for blk in list(getattr(resnet, f"layer{stage}"))[1:depth]]
    with torch.inference_mode():
        scale, shift = resnet.bn1.folded()
        stem = stem_forward(batch, *stem_constants(module, batch.dtype), resnet.conv1.weight,
                            scale, shift)
        arms = (lambda: resnet(None, stem.permute(0, 3, 1, 2)),
                lambda: apply_trunk_fused(resnet, stem, module.backbone_kind))
        d1, f1, f2, d2 = (time_ms(arms[i], 5) for i in (0, 1, 1, 0))
        prep = time_ms(lambda: [bottleneck_args(blk) for blk in fused_blocks], 5)
    d, f = (d1 + d2) / 2, (f1 + f2) / 2
    return (f"[fused_bottleneck] the R50 trunk at batch {BATCH}, {H}x{W}: module {d:.3f} ms "
            f"({d1:.3f}, {d2:.3f}), fused {f:.3f} ms ({f1:.3f}, {f2:.3f}): the 10 kernel launches "
            f"{kernel_ms:.3f} ms, their arguments {prep:.3f} ms, the 6 blocks left to cuDNN "
            f"{f - kernel_ms - prep:.3f} ms (their module blocks {d - module_blocks_ms:.3f} ms)")


def top2_case(dev) -> dict:
    from pytorch_retinanet_tpu_torch.kernels import top2_classes, top2_classes_plain

    a = BATCH * LEVEL_ANCHORS[0]
    g = torch.Generator(device=dev).manual_seed(30)
    logits = (torch.randn((a, 90), generator=g, device=dev) * 2 - 4).to(torch.bfloat16)
    r = timed(lambda: top2_classes(logits), 20, ("top2_kernel",))
    # Two compare scans of the row.
    r.update(bound(logits.numel() * 2 + a * 16, 2.0 * logits.numel(), F32_FLOPS),
             plain_ms=time_ms(lambda: top2_classes_plain(logits), 3),
             library_ms=time_ms(lambda: torch.topk(logits, 2, dim=1), 10))
    return r


def pair_row(name, forward, backward, n_launches, bytes_fwd, bytes_bwd, plain, aten,
             port) -> dict:
    """A kernel pair's row: its forward and backward timed apart, beside
    their byte bounds; the plain version (forward and backward); ATen's
    composition and the pair through autograd (``aten``, ``port``:
    ``fn(backward_too)`` returning a step). Raises where a window recorded
    other than ``n_launches`` (forward, backward) launches a call: then its
    device time is not the call's."""
    r = {"launches_per_call": 0}
    for part, fn, launches, nbytes in (("forward", forward, n_launches[0], bytes_fwd),
                                       ("backward", backward, n_launches[1], bytes_bwd)):
        t = timed(fn, 5)
        if t["launches_per_call"] != launches:
            raise SystemExit(f"{name}: the {part}'s window recorded {t['launches_per_call']} "
                             f"launches a call, not {launches}: device time not measured")
        r["launches_per_call"] += t["launches_per_call"]
        r.update({f"{part}_ms": t["ms"], f"{part}_device_ms": t["device_ms"],
                  f"{part}_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3})
    r.update(ms=r["forward_ms"] + r["backward_ms"],
             device_ms=r["forward_device_ms"] + r["backward_device_ms"],
             bound_ms=r["forward_bound_ms"] + r["backward_bound_ms"],
             bound_by="bytes", plain_ms=time_ms(plain, 2, warmup=1))
    torch.cuda.empty_cache()
    for arm, fn in (("library", aten), ("autograd", port)):
        fwd, both = time_ms(fn(False), 3), time_ms(fn(True), 3)
        r.update({f"{arm}_forward_ms": fwd, f"{arm}_backward_ms": both - fwd})
    r["library_ms"] = r["library_forward_ms"] + r["library_backward_ms"]
    print(f"[{name}] through autograd forward {r['autograd_forward_ms']:.3f}, backward "
          f"{r['autograd_backward_ms']:.3f} ms against ATen's {r['library_forward_ms']:.3f} / "
          f"{r['library_backward_ms']:.3f} ms")
    return r


def frozen_bn_case(dev) -> dict:
    fb = importlib.import_module("pytorch_retinanet_tpu_torch.kernels.frozen_bn")
    cases = [(*frozen_bn_inputs(dev, n, c, h, w, torch.bfloat16, True, 0, seed=c + h), relu)
             for n, c, h, w, relu in r50_frozen_bn_shapes(TRAIN_BATCH, H, W)]
    elems = sum(x.numel() for x, *_ in cases)

    def through_autograd(fn):
        def arm(backward_too: bool):
            def step():
                ys = [fn(x.detach().requires_grad_(), w.detach().requires_grad_(),
                         b.detach().requires_grad_(), m, v, relu)
                      for x, _, (w, b, m, v), relu in cases]
                if backward_too:
                    torch.autograd.backward(ys, [dy for _, dy, _, _ in cases])
            return step
        return arm

    def aten(x, w, b, m, v, relu):
        y = F.batch_norm(x, m, v, w, b, False, 0.0, FROZEN_BN_EPS)
        return torch.relu_(y) if relu else y

    def plain():
        for x, dy, p, relu in cases:
            fb.frozen_bn_plain(x, *p, FROZEN_BN_EPS, relu)
            fb.frozen_bn_backward_plain(dy, x, *p, FROZEN_BN_EPS, relu)

    print(build_report("frozen_bn", ("forward_nhwc", "backward_nhwc", "forward_nchw",
                                     "backward_nchw", "finalize")))
    # bf16 x in and y out a forward; x and dy in, dx out a backward (a pass
    # and its finalize).
    return pair_row(
        "frozen_bn", lambda: [fb._launch_forward(x, *p, FROZEN_BN_EPS, r) for x, _, p, r in cases],
        lambda: [fb._launch_backward(dy, x, *p, FROZEN_BN_EPS, r) for x, dy, p, r in cases],
        (len(cases), 2 * len(cases)), elems * 4, elems * 6, plain, through_autograd(aten),
        through_autograd(lambda x, w, b, m, v, r: fb.frozen_batch_norm(x, w, b, m, v,
                                                                       FROZEN_BN_EPS, r)))


def focal_case(dev) -> dict:
    fl = importlib.import_module("pytorch_retinanet_tpu_torch.kernels.focal")
    from pytorch_retinanet_tpu_torch.ops import sigmoid_focal_loss

    cases = [focal_inputs(dev, TRAIN_BATCH, a, 90, torch.bfloat16, 0, seed=a) for a in LEVEL_ANCHORS]
    elems = sum(x.numel() for x, *_ in cases)
    side = sum(2 * 4 * l.numel() for _, l, _, _ in cases)  # labels and matches, int32

    def through_autograd(fn):
        def arm(backward_too: bool):
            def step():
                outs = [fn(x.detach().requires_grad_(), l, m) for x, l, m, _ in cases]
                if backward_too:
                    torch.autograd.backward(outs, [g for *_, g in cases])
            return step
        return arm

    def aten(x, labels, matches):
        """The loss's classification term before the pair."""
        onehot = (labels[..., None] == torch.arange(1, x.shape[-1] + 1, dtype=labels.dtype,
                                                   device=x.device)).float()
        elem = sigmoid_focal_loss(x.float(), onehot, FOCAL_ALPHA, FOCAL_GAMMA)
        return (elem.sum(-1) * (matches >= -1).float()).sum(1)

    def port(x, labels, matches):
        return fl.focal_loss_sums(x, labels, matches, FOCAL_ALPHA, FOCAL_GAMMA)

    def plain():
        for x, l, m, g in cases:
            fl.focal_loss_sums_plain(x, l, m, FOCAL_ALPHA, FOCAL_GAMMA)
            fl.focal_loss_backward_plain(g, x, l, m, FOCAL_ALPHA, FOCAL_GAMMA)

    print(build_report("focal", ("focal_kernel", "finalize")))
    # bf16 logits in a forward; in and dx out a backward; a forward's pass
    # and its finalize a level, a backward's pass.
    r = pair_row(
        "focal_loss", lambda: [fl._launch_forward(x, l, m, FOCAL_ALPHA, FOCAL_GAMMA) for x, l, m, _ in cases],
        lambda: [fl._launch_backward(g, x, l, m, FOCAL_ALPHA, FOCAL_GAMMA) for x, l, m, g in cases],
        (2 * len(cases), len(cases)), elems * 2 + side, elems * 4 + side, plain,
        through_autograd(aten), through_autograd(port))
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    for name, arm in (("library", aten), ("autograd", port)):
        torch.cuda.reset_peak_memory_stats()
        through_autograd(arm)(True)()
        torch.cuda.synchronize()
        r[f"{name}_peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
    print(f"[focal_loss] peak memory above the inputs through forward and backward: the pair "
          f"{r['autograd_peak_gib']:.3f} GiB, ATen's composition {r['library_peak_gib']:.3f} GiB")
    return r


CASES: Dict[str, Callable] = {
    "fused_stem": stem_case,
    "nms_keep_mask": nms_case,
    "match_targets": match_case,
    "fused_bottleneck": bottleneck_case,
    "top2_classes": top2_case,
    "frozen_bn": frozen_bn_case,
    "focal_loss": focal_case,
}


def cases_for(names) -> list:
    """The registry's kernels named in `names` (all without), each with its
    case; raises for a registry entry without a case or an unknown name."""
    from pytorch_retinanet_tpu_torch.kernels import KERNELS

    missing = [k.name for k in KERNELS if k.name not in CASES]
    if missing:
        raise KeyError(f"kernels without a case in tools/torch_kernel_table.py: {missing}")
    unknown = sorted(set(names) - {k.name for k in KERNELS})
    if unknown:
        raise KeyError(f"not in kernels.KERNELS: {unknown}")
    return [(k, CASES[k.name]) for k in KERNELS if not names or k.name in names]


def row_text(r: dict) -> str:
    def ms(v):
        return "none" if v is None else f"{v:.4f}"
    parts = ""
    if "forward_ms" in r:
        parts = (f" (forward {r['forward_ms']:.4f} / device {r['forward_device_ms']:.4f}, backward "
                 f"{r['backward_ms']:.4f} / device {r['backward_device_ms']:.4f})")
    return (f"{r['ms']:.4f} ms, device {r['device_ms']:.4f} ms{parts}, "
            f"{r['launches_per_call']} launches a call; "
            f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}; plain {ms(r['plain_ms'])} ms; "
            f"library {ms(r['library_ms'])} ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", help="kernels to time (default: every one)")
    ap.add_argument("--json", help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    todo = cases_for(args.names)
    if not torch.cuda.is_available():
        print("torch_kernel_table: needs a CUDA card", file=sys.stderr)
        return 2
    from pytorch_retinanet_tpu_torch.kernels.build import build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    build(sorted({os.path.basename(k.source)[:-3] for k, _ in todo}))
    print(f"[build] {len(todo)} kernels in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    rows = []
    for kernel, case in todo:
        row = {"name": kernel.name, "route": kernel.route, "source": kernel.source,
               "replaces": kernel.replaces, **case(dev)}
        print(f"[{kernel.name}] {row_text(row)}", flush=True)
        rows.append(row)
        torch.cuda.empty_cache()
    line = json.dumps({"kernels": rows, "card": smi})
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
