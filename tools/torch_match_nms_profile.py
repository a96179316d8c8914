"""Device time of the port's match and NMS kernels, and the host time around them.

Run from the root of a checkout on a machine with the card:
``python3 tools/torch_match_nms_profile.py [--root DIR]``. ``--root`` runs
another checkout's package and kernels (a ``git archive`` of an earlier
commit, say) with this checkout's measurement, so that two versions can be
compared in one call, in turns; an earlier ``chip_smoke.py`` may not print
the device time. It builds ``match`` and ``nms`` from that checkout's
``csrc`` and reports, from one ``torch.profiler`` window per case (device
time per kernel) and CUDA events around the same calls:

1. the match kernel per level and summed over the five levels, at
   ``chip_smoke.py`` phase 6's training shapes (batch 16, the 800x1344
   bucket, 100 padded GT rows, the same seeded GT), with the share of
   (anchor, valid GT row) pairs that the block cull stages; then the match
   wrapper's host time at P3, its output allocations and its C call alone;
2. the NMS kernel on the main path's candidates (phase 4's R50-FPN, prior
   0.5, seed 0, 32 seeded images), then that detector's forward and predict
   composition (``_predict_impl``) on the same batch with CUDA events, the
   postprocess alone (its launches, device and host time), and phase 5's
   end-to-end ``predict`` of the 32 images (median of 5, host clock).

The helpers (the profiler window, the seeded inputs) are this checkout's
``chip_smoke.py``. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def host_us(fn, iters: int = 200) -> float:
    """Host us per call of ``fn``, enqueued back to back (no synchronize)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / iters
    torch.cuda.synchronize()
    return us


def match_host_breakdown(anchors, gt) -> dict:
    """Where the match wrapper's host time goes: the whole call, its output
    allocations, and the ctypes call of the kernel alone."""
    from pytorch_retinanet_tpu_torch.kernels import match_targets
    from pytorch_retinanet_tpu_torch.kernels.build import load

    boxes, labels, valid = gt
    b, a = labels.shape[0], anchors.shape[0]
    m = torch.empty((b, a), dtype=torch.int32, device=anchors.device)
    f = torch.empty_like(m)
    r = torch.empty((b, a, 4), dtype=torch.float32, device=anchors.device)
    match_targets(anchors, *gt)  # the wrapper sets the C function's argument types
    fn = load("match").match_targets
    ptrs = [t.data_ptr() for t in (anchors, boxes, labels, valid, m, f, r)]
    stream = torch.cuda.current_stream().cuda_stream

    def alloc():
        return (torch.empty((b, a), dtype=torch.int32, device=anchors.device),
                torch.empty((b, a), dtype=torch.int32, device=anchors.device),
                torch.empty((b, a, 4), dtype=torch.float32, device=anchors.device))

    return {"wrapper": host_us(lambda: match_targets(anchors, *gt)), "allocations": host_us(alloc),
            "c_call": host_us(lambda: fn(*ptrs, b, a, labels.shape[1], 0.5, 0.4, 1.0, 1.0, 1.0, 1.0,
                                          stream))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=ROOT, help="checkout whose package and kernels to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_match_nms_profile: needs a CUDA card", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    from pytorch_retinanet_tpu_torch.kernels import match_targets, nms_keep_mask
    from pytorch_retinanet_tpu_torch.kernels.build import build
    from pytorch_retinanet_tpu_torch.models.retinanet import Retinanet, apply_detector
    from pytorch_retinanet_tpu_torch.ops import (
        generate_anchors_per_level, process_detections_multilevel_batch,
    )

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    build(["match", "nms"])
    smoke.log(f"[profile] checkout {root}; card {smi}")

    anchors_levels = [torch.from_numpy(a).to(dev) for a in generate_anchors_per_level((smoke.H, smoke.W))]
    gt = smoke.match_inputs(anchors_levels, dev)
    smoke.trace_match(match_targets, anchors_levels, gt)
    host = match_host_breakdown(anchors_levels[0], gt)
    smoke.log(f"[host] match wrapper at level 0: {host['wrapper']:.1f} us per call; its three "
              f"output allocations {host['allocations']:.1f} us; the C call alone {host['c_call']:.1f} us")

    _, images, batch, sizes = smoke.main_path_batch(dev)
    net = Retinanet(backbone_kind="resnet50", num_classes=90, pretrained=False, prior=0.5, seed=0)
    cboxes, cvalid = smoke.nms_candidates(net, batch, sizes)
    t = smoke.device_times(lambda: nms_keep_mask(cboxes, cvalid, 0.5), iters=50)
    smoke.log_device_times(f"nms on the main path's candidates [32, {cvalid.shape[1]}], "
                           f"{int(cvalid.sum())} valid", t)
    with torch.inference_mode():
        forward = smoke.time_ms(lambda: apply_detector(net.module, batch, return_levels=True), 5)
        composition = smoke.time_ms(lambda: net._predict_impl(batch, sizes), 5)
        cls_l, box_l = apply_detector(net.module, batch, return_levels=True)
        anchors = net._anchors_for(tuple(batch.shape[1:3]))
        post = smoke.device_times(lambda: process_detections_multilevel_batch(
            cls_l, box_l, anchors, sizes, score_thres=net.score_thres, nms_thres=net.nms_thres,
            max_detections=net.max_detections), iters=10)
    smoke.log(f"[predict] composition (forward + postprocess, CUDA events) {composition:.3f} ms, "
              f"{smoke.BATCH / composition * 1e3:.1f} img/s; forward {forward:.3f} ms; postprocess "
              f"{composition - forward:.3f} ms")
    net.predict(images[:2])  # warm-up, as phase 4
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        net.predict(images)
        times.append(time.perf_counter() - t0)
    per_batch = sorted(times)[2]
    smoke.log(f"[e2e] predict batch {smoke.BATCH}: median {per_batch * 1e3:.1f} ms over 5 -> "
              f"{smoke.BATCH / per_batch:.1f} img/s (host clock, chip_smoke.py phase 5's measure)")
    top = sorted(post["kernels"].items(), key=lambda kv: -kv[1][0])[:12]
    smoke.log(f"[postprocess] alone: device {smoke.device_ms(post) * 1e3:.1f} us per call in "
              f"{sum(n for _, n in post['kernels'].values()):g} launches; CUDA events "
              f"{post['event_ms'] * 1e3:.1f} us; host enqueue {post['host_us']:.1f} us; top: "
              + "; ".join(f"{k} {us:.1f} us x{n:g}" for k, (us, n) in top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
