"""Where the time of the PyTorch port's predict goes on one CUDA card.

Run from the root of a checkout on a machine with the card:
``python3 tools/torch_profile_predict.py``. It builds the main-path detector
(R50-FPN, 90 classes, prior 0.5, seed 0) and the same 32 seeded 800x1333
images as ``chip_smoke.py``, then reports:

1. stage times with CUDA events on the padded 800x1344 uint8 batch (what
   ``predict`` builds): fused stem (normalize inside), ResNet trunk, FPN,
   head, postprocess;
2. one ``torch.profiler`` trace of the device part of predict: device time
   by kernel family, the top kernels, and the device's busy share of the
   traced wall time;
3. the forward with ``torch.backends.cudnn.benchmark`` off and on.

The summary is printed; ``--json PATH`` also writes it as JSON. Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from pytorch_retinanet_tpu_torch.models.retinanet import (  # noqa: E402
    Retinanet,
    apply_detector,
    stem_constants,
)
from pytorch_retinanet_tpu_torch.kernels.stem import stem_forward  # noqa: E402

BATCH, H, W = 32, 800, 1344


def cuda_ms(fn, iters=5, warmup=2):
    for _ in range(warmup):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def family(name: str) -> str:
    n = name.lower()
    if "stem_kernel" in n:
        return "fused stem kernel"
    if "nms_" in n:
        return "nms kernel"
    if any(s in n for s in ("conv", "xmma", "gemm", "cudnn", "sm90", "implicit", "winograd", "cutlass")):
        return "convolution (cuDNN)"
    if any(s in n for s in ("sort", "radix", "topk", "scan")):
        return "sort / select"
    if any(s in n for s in ("gather", "index", "scatter")):
        return "gather / index"
    if any(s in n for s in ("elementwise", "vectorized", "reduce", "copy", "fill", "cat")):
        return "elementwise / copy / reduce"
    return "other"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", help="also write the summary to this JSON file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (800, 1333, 3), dtype=np.uint8) for _ in range(BATCH)]
    net = Retinanet(backbone_kind="resnet50", num_classes=90, pretrained=False, prior=0.5, seed=0)
    dev = net.device
    batch = torch.zeros((BATCH, H, W, 3), dtype=torch.uint8, device=dev)
    batch[:, :800, :1333] = torch.from_numpy(np.stack(images)).to(dev)
    sizes = torch.tensor([[800.0, 1333.0]] * BATCH, device=dev)
    m = net.module
    resnet = m.backbone.backbone
    out = {"card": smi}

    with torch.inference_mode():
        consts = stem_constants(m, batch.dtype)
        sc, sh = resnet.bn1.folded()
        stem = stem_forward(batch, *consts, resnet.conv1.weight, sc, sh).permute(0, 3, 1, 2)
        feats = resnet(None, stem)
        pyr = m.fpn(feats)
        levels = m.retinanet_head(pyr, True)
        stages = {
            "fused stem kernel": cuda_ms(lambda: stem_forward(batch, *consts, resnet.conv1.weight,
                                                              sc, sh)),
            "trunk (layer1-4)": cuda_ms(lambda: resnet(None, stem)),
            "fpn": cuda_ms(lambda: m.fpn(feats)),
            "head": cuda_ms(lambda: m.retinanet_head(pyr, True)),
            "forward (apply_detector)": cuda_ms(lambda: apply_detector(m, batch, return_levels=True)),
            "predict device part (_predict_impl)": cuda_ms(lambda: net._predict_impl(batch, sizes)),
        }
        stages["postprocess"] = stages["predict device part (_predict_impl)"] - stages["forward (apply_detector)"]
        del levels
    out["stage_ms"] = stages
    for k, v in stages.items():
        print(f"[stage] {k}: {v:.3f} ms")

    t0 = time.time()
    net.predict(images)
    out["predict_s_cold_batch"] = time.time() - t0

    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        net._predict_impl(batch, sizes)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            w0 = time.perf_counter()
            net._predict_impl(batch, sizes)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - w0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print("the profiler recorded no device events", file=sys.stderr)
        return 1
    by_family = defaultdict(float)
    by_name = defaultdict(float)
    spans = []
    for e in kernels:
        dur = e.time_range.elapsed_us()
        by_family[family(e.name)] += dur
        by_name[e.name[:90]] += dur
        spans.append((e.time_range.start, e.time_range.end))
    spans.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    total = sum(by_family.values())
    out["trace"] = {
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy / 1e3,
        "idle_share": 1.0 - busy / wall_us,
        "kernel_ms_by_family": {k: v / 1e3 for k, v in sorted(by_family.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms": {k: v / 1e3 for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]},
        "n_kernels": len(kernels),
    }
    print(f"[trace] wall {wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms, "
          f"idle share {1 - busy / wall_us:.3f}, {len(kernels)} kernels, {total / 1e3:.2f} ms kernel time")
    for k, v in out["trace"]["kernel_ms_by_family"].items():
        print(f"[trace] {k}: {v:.2f} ms ({v * 1e3 / total:.1%})")
    for k, v in out["trace"]["top_kernels_ms"].items():
        print(f"[trace]   {v:8.2f} ms  {k}")

    with torch.inference_mode():
        fwd = lambda: apply_detector(m, batch, return_levels=True)  # noqa: E731
        torch.backends.cudnn.benchmark = False
        off = cuda_ms(fwd)
        torch.backends.cudnn.benchmark = True
        on = cuda_ms(fwd, warmup=3)
        torch.backends.cudnn.benchmark = False
        off2 = cuda_ms(fwd)
    out["forward_ms_cudnn_benchmark"] = {"off": off, "on": on, "off_again": off2}
    print(f"[cudnn.benchmark] forward off {off:.2f} ms, on {on:.2f} ms, off again {off2:.2f} ms")
    print(f"card: {smi}")

    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
