"""Drive the PyTorch port on one CUDA card and hold each kernel to its plain version.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
NVIDIA Hopper card, ``nvcc`` and PyTorch built for CUDA; it never imports JAX
or the JAX package. Phases, each of which fails the run on any fault:

1. build both kernels from ``pytorch_retinanet_tpu_torch/csrc`` (one ``nvcc``
   per source, in parallel) and print the card's name and power limit;
2. fused stem kernel against ``stem_plain`` at [32, 800, 1344, 3];
3. NMS kernel against ``nms_keep_mask_plain`` on dense synthetic clusters;
4. the main path: R50-FPN ``Retinanet.predict`` on 32 seeded 800x1333 images
   (the 800x1344 bucket), both launch counts read around that run alone,
   then the NMS kernel against its plain version on that run's candidates,
   and ``predict`` on the card against ``predict`` on the CPU at a small size;
5. times (CUDA events after warm-up): each kernel beside its bound, its
   plain version and a PyTorch yardstick, and predict img/s at batch 32.

The last lines are the ``kernels`` JSON, the ``nvidia-smi`` name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pytorch_retinanet_tpu_torch import KERNELS
    from pytorch_retinanet_tpu_torch.kernels import (
        nms_keep_mask, nms_keep_mask_plain, reset_launch_counts, stem_forward, stem_plain,
    )
    from pytorch_retinanet_tpu_torch.kernels.build import build
    from pytorch_retinanet_tpu_torch.models.retinanet import Retinanet, apply_detector
    from pytorch_retinanet_tpu_torch.ops import merge_candidates, multilevel_candidates

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
    libs = build(["stem", "nms"])
    log(f"[build] both kernels built in {time.time() - t0:.1f} s")
    for name, path in libs.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "smem" in line:
                log(f"[build] {name}: {line.strip()}")

    results = {k.name: {"name": k.name, "route": k.route, "source": k.source,
                        "replaces": k.replaces} for k in KERNELS}
    gen = torch.Generator().manual_seed(0)

    # 2. Stem kernel against its plain version at the main-path shape.
    x = (torch.randn((BATCH, H, W, 3), generator=gen) * 1.5).to(dev)
    w = (torch.randn((64, 3, 7, 7), generator=gen) * (2.0 / (64 * 49)) ** 0.5).to(dev)
    scale = (0.5 + torch.rand(64, generator=gen)).to(dev)
    bias = (torch.randn(64, generator=gen) * 0.3).to(dev)
    out = stem_forward(x, w, scale, bias)
    ref = stem_plain(x, w, scale, bias)
    torch.cuda.synchronize()
    err, n_bad = stem_error(out, ref)
    log(f"[stem] kernel vs plain at {tuple(x.shape)}: max |diff| {err:.3g}, "
        f"{n_bad} of {out.numel()} outside {STEM_TOL}")
    if out.shape != (BATCH, H // 4, W // 4, 64) or out.dtype != torch.bfloat16 or n_bad:
        raise SystemExit("stem kernel disagrees with its plain version")
    results["fused_stem"]["max_abs_err"] = err

    # 3. NMS kernel against its plain version on dense clusters.
    boxes, valid = dense_clusters(gen, BATCH, 1000, dev)
    keep = nms_keep_mask(boxes, valid, 0.5)
    keep_ref = nms_keep_mask_plain(boxes, valid, 0.5)
    if not torch.equal(keep, keep_ref):
        raise SystemExit(f"nms kernel differs from plain on clusters at "
                         f"{int((keep != keep_ref).sum())} of {keep.numel()} candidates")
    log(f"[nms] clusters [32, 1000]: equal; kept {int(keep.sum())} of {int(valid.sum())} valid")

    # 4. Main path.
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (800, 1333, 3), dtype=np.uint8) for _ in range(BATCH)]
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
    for name, n in launches.items():
        if n < 1:
            raise SystemExit(f"main path never launched {name}")
        results[name]["launches"] = n
    for p in preds:
        b, s, lab = p["boxes"], p["scores"], p["labels"]
        if not (b.ndim == 2 and b.shape[1] == 4 and len(b) == len(s) == len(lab) > 0):
            raise SystemExit(f"bad detection shapes {b.shape} {s.shape} {lab.shape}")
        if not (np.isfinite(b).all() and np.isfinite(s).all()):
            raise SystemExit("non-finite detections")
        if not ((lab >= 1) & (lab <= 90)).all() or not ((s > 0.05) & (s <= 1)).all():
            raise SystemExit("labels or scores out of range")
        if (b < -1e-3).any() or (b[:, [0, 2]] > 1333 + 1e-2).any() or (b[:, [1, 3]] > 800 + 1e-2).any():
            raise SystemExit("boxes outside the image")
    log(f"[predict] detections per image: {[len(p['scores']) for p in preds[:8]]} ...")

    # The same batch's NMS input, rebuilt outside the counted run.
    batch = torch.zeros((BATCH, H, W, 3), device=dev)
    batch[:, :800, :1333] = torch.from_numpy(np.stack(images)).to(dev).float() / 255.0
    sizes = torch.tensor([[800.0, 1333.0]] * BATCH, device=dev)
    with torch.inference_mode():
        cls_l, box_l = apply_detector(net.module, batch, return_levels=True)
        cand = multilevel_candidates(cls_l, box_l, net._anchors_for((H, W)))
        cboxes, cscores, cidx, cvalid = merge_candidates(*cand, sizes)
        offset_boxes = cboxes + (cidx.float() * 4097.0)[..., None]
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

    # 5. Times.
    st = results["fused_stem"]
    st["ms"] = time_ms(lambda: stem_forward(x, w, scale, bias), 20)
    st["plain_ms"] = time_ms(lambda: stem_plain(x, w, scale, bias), 5)
    wcl = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)

    def cudnn_stem():
        xb = x.to(torch.bfloat16).permute(0, 3, 1, 2)
        y = torch.relu(F.conv2d(xb, wcl, stride=2, padding=3) * scale[:, None, None].bfloat16()
                       + bias[:, None, None].bfloat16())
        return F.max_pool2d(y, 3, 2, 1)

    st["library_ms"] = time_ms(cudnn_stem, 20)
    stem_bytes = x.numel() * 4 + out.numel() * 2 + w.numel() * 4 + 2 * 64 * 4
    stem_flops = 2.0 * BATCH * (H // 2) * (W // 2) * 64 * 147
    st["bound_ms"], st["bound_by"] = max(
        (stem_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
        (stem_flops / BF16_TENSOR_FLOPS * 1e3, "operations"),
    )
    nm = results["nms_keep_mask"]
    nm["ms"] = time_ms(lambda: nms_keep_mask(offset_boxes, cvalid, 0.5), 50)
    nm["plain_ms"] = time_ms(lambda: nms_keep_mask_plain(offset_boxes, cvalid, 0.5), 3)
    nm["library_ms"] = None  # no single PyTorch call computes greedy NMS
    nv = cvalid.sum(dim=1).double()
    pairs = float((nv * (nv - 1) / 2).sum())  # IoU pairs this run's valid candidates need
    nms_bytes = offset_boxes.numel() * 4 + 2 * cvalid.numel()
    nm["bound_ms"], nm["bound_by"] = max(
        (nms_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
        (pairs * 12 / F32_FLOPS * 1e3, "operations"),
    )
    for r in results.values():
        log(f"[time] {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library "
            f"{r['library_ms']}, bound {r['bound_ms']:.4f} ms by {r['bound_by']})")

    with torch.inference_mode():
        t_norm = time_ms(lambda: net.module.normalize(batch), 5)
        t_net = time_ms(lambda: apply_detector(net.module, batch, return_levels=True), 5)
        t_post = time_ms(lambda: net._predict_impl(batch, sizes), 5) - t_net
    times = []
    for _ in range(5):
        t0 = time.time()
        net.predict(images)
        times.append(time.time() - t0)
    per_batch = float(np.median(times))
    log(f"[e2e] predict batch 32: median {per_batch * 1e3:.1f} ms over 5 -> "
        f"{BATCH / per_batch:.1f} img/s; forward (normalize+stem+trunk+FPN+head) "
        f"{t_net:.2f} ms, of which normalize {t_norm:.2f} ms; postprocess {t_post:.2f} ms; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    log(json.dumps({"kernels": [results[k.name] for k in KERNELS]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
