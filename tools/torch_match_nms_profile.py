"""Device time of the port's match and NMS kernels, and the host time around them.

Run from the root of a checkout on a machine with the card:
``python3 tools/torch_match_nms_profile.py [--root DIR]``. ``--root`` runs
another checkout's package and kernels (a ``git archive`` of an earlier
commit, say) with this checkout's measurement, so that two versions can be
compared in one call, in turns. It builds ``match`` and ``nms`` from that
checkout's ``csrc`` and reports, from one ``torch.profiler`` window per case
(device time per kernel) and CUDA events around the same calls:

1. the match kernel per level and summed over the five levels, at the
   training shapes of ``tools/torch_kernel_table.py`` (batch 16, the
   800x1344 bucket, 100 padded GT rows), with the share of (anchor, GT row)
   pairs that the block cull stages; then the match wrapper's host time at
   P3, its output allocations and its C call alone;
2. the NMS kernel on predict's candidates (R50-FPN, prior 0.5, seed 0, 32
   seeded images), then that detector's forward and predict composition
   (``_predict_impl``) on the same batch with CUDA events, the postprocess
   alone (its launches, device and host time), and the end-to-end
   ``predict`` of the 32 images (median of 5, host clock).

The inputs and the profiler window are ``tools/torch_kernel_table.py``'s.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
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
    import torch_kernel_table as table  # this checkout's; it imports the package lazily

    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    from pytorch_retinanet_tpu_torch.kernels import match_targets, nms_keep_mask
    from pytorch_retinanet_tpu_torch.kernels.build import build
    from pytorch_retinanet_tpu_torch.models.retinanet import apply_detector
    from pytorch_retinanet_tpu_torch.ops import process_detections_multilevel_batch

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    build(["match", "nms"])
    print(f"[profile] checkout {root}; card {smi}", flush=True)

    levels, gt = table.match_levels(dev)
    print(table.profile_line("match_targets, the five levels of one step",
                             table.profile(lambda: [match_targets(a, *gt) for a in levels], 20)))
    host = match_host_breakdown(levels[0], gt)
    print(f"[host] match wrapper at level 0: {host['wrapper']:.1f} us per call; its three output "
          f"allocations {host['allocations']:.1f} us; the C call alone {host['c_call']:.1f} us")

    images, batch, sizes = table.main_path_batch(dev)
    net = table.main_path_net()
    cboxes, cvalid = table.predict_candidates(net, batch, sizes)
    print(table.profile_line(f"nms on predict's candidates [32, {cvalid.shape[1]}], "
                             f"{int(cvalid.sum())} valid",
                             table.profile(lambda: nms_keep_mask(cboxes, cvalid, 0.5), 50)))
    with torch.inference_mode():
        forward = table.time_ms(lambda: apply_detector(net.module, batch, return_levels=True), 5)
        composition = table.time_ms(lambda: net._predict_impl(batch, sizes), 5)
        cls_l, box_l = apply_detector(net.module, batch, return_levels=True)

        def post():
            return process_detections_multilevel_batch(
                cls_l, box_l, net._anchors_for(tuple(batch.shape[1:3])), sizes,
                score_thres=net.score_thres, nms_thres=net.nms_thres,
                max_detections=net.max_detections)

        kernels = table.profile(post, 10)
        post_ms, post_host = table.time_ms(post, 10), host_us(post, 10)
    print(f"[predict] composition (forward + postprocess, CUDA events) {composition:.3f} ms, "
          f"{table.BATCH / composition * 1e3:.1f} img/s; forward {forward:.3f} ms; postprocess "
          f"{composition - forward:.3f} ms")
    net.predict(images[:2])  # warm-up
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        net.predict(images)
        times.append(time.perf_counter() - t0)
    per_batch = sorted(times)[2]
    print(f"[e2e] predict batch {table.BATCH}: median {per_batch * 1e3:.1f} ms over 5 -> "
          f"{table.BATCH / per_batch:.1f} img/s (host clock)")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    print(f"[postprocess] alone: device {sum(us for us, _ in kernels.values()):.1f} us per call in "
          f"{sum(n for _, n in kernels.values()):g} launches; CUDA events {post_ms * 1e3:.1f} us; "
          f"host enqueue {post_host:.1f} us; top: "
          + "; ".join(f"{k} {us:.1f} us x{n:g}" for k, (us, n) in top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
