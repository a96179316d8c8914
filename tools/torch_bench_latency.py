"""Serving latency of the PyTorch port on the card, at small batches.

Counterpart of ``tools/bench_latency.py``, run through two programs: the
eager ``Retinanet._predict_impl`` and a loaded ``torch.export`` artifact of
the same detector (``export.load_exported``), each on the uint8 wire (the
serving format) with the batch already on the card. R50-FPN, 90 classes,
seeded random weights with prior 0.5 so that NMS sees full candidate
lists, the 800x1344 bucket.

    python tools/torch_bench_latency.py [--batches 1,2,4,8] [--iters 30] \\
        [--out build/torch_latency.json]

Per (program, batch) one JSON line, with the JAX tool's keys:
  p50_ms / p90_ms   host clock per request: the call, then its 4 outputs
                    copied to the host
  p50_packed_ms     the same, fetching one packed [B, D, 6] buffer
                    (``ops.pack_detections``)
  p50_pipelined_ms  packed requests at depth 2: request i+1 is enqueued
                    before request i's buffer is read; request i's copy
                    into page-locked memory is enqueued right after it,
                    so reading it waits for request i alone (wall / calls)
  compute_ms        CUDA events around calls back to back, per call: the
                    card's timeline, idle gaps included where the host's
                    enqueue is the slower side
  dispatch_ms       host clock for the call to return (enqueue only),
                    median of 10
  fetch4_ms / fetch1_ms
                    host clock to copy an already finished result to the
                    host: the 4 outputs, or the one packed buffer; median
                    of 10
  host_transfer_f32_ms / host_transfer_u8_ms
                    CUDA events around the upload of the batch's images
                    from page-locked memory, f32 and uint8
  img_per_sec       batch / p50_pipelined_ms
Card only: it exits where CUDA is absent. It writes ``--out`` when given,
and no other file.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch


def _p(lat: List[float], q: float) -> float:
    lat = sorted(lat)
    return lat[min(int(len(lat) * q), len(lat) - 1)]


def _events():
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


def transfer_ms(batch: int, h: int, w: int, dtype: torch.dtype, iters: int = 10,
                pinned: bool = True) -> float:
    """Median CUDA-event ms to upload [batch, h, w, 3] of `dtype` from
    page-locked (or, with ``pinned=False``, pageable) memory."""
    host = torch.zeros((batch, h, w, 3), dtype=dtype, pin_memory=pinned)
    host.to("cuda", non_blocking=pinned)  # warm the allocator
    times = []
    for _ in range(iters):
        start, end = _events()
        start.record()
        host.to("cuda", non_blocking=pinned)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def latency_row(call: Callable, images: torch.Tensor, sizes: torch.Tensor, iters: int) -> Dict:
    """The row's request metrics for ``call(images, sizes) -> (boxes,
    scores, labels, valid)`` on device tensors."""
    from pytorch_retinanet_tpu_torch.ops import Detections, pack_detections

    def packed():
        return pack_detections(Detections(*call(images, sizes)))

    def request() -> float:
        t0 = time.perf_counter()
        [t.cpu() for t in call(images, sizes)]
        return (time.perf_counter() - t0) * 1e3

    def request_packed() -> float:
        t0 = time.perf_counter()
        packed().cpu()
        return (time.perf_counter() - t0) * 1e3

    request()
    request_packed()
    lat = [request() for _ in range(iters)]
    lat_packed = [request_packed() for _ in range(iters)]

    # Depth 2: enqueue request i+1, then read request i.
    first = packed()
    bufs = [torch.empty(first.shape, dtype=first.dtype, pin_memory=True) for _ in range(2)]
    done = [torch.cuda.Event(), torch.cuda.Event()]

    def enqueue(i: int) -> None:
        bufs[i % 2].copy_(packed(), non_blocking=True)
        done[i % 2].record()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enqueue(0)
    for i in range(1, iters + 1):
        enqueue(i)
        done[(i - 1) % 2].synchronize()
        bufs[(i - 1) % 2].numpy().sum()
    done[iters % 2].synchronize()
    pipelined_ms = (time.perf_counter() - t0) / (iters + 1) * 1e3

    torch.cuda.synchronize()
    start, end = _events()
    start.record()
    for _ in range(iters):
        call(images, sizes)
    end.record()
    end.synchronize()
    compute_ms = start.elapsed_time(end) / iters

    dispatch, fetch4, fetch1 = [], [], []
    for _ in range(min(iters, 10)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det = call(images, sizes)
        dispatch.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        [t.cpu() for t in det]
        fetch4.append((time.perf_counter() - t0) * 1e3)
        one = packed()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one.cpu()
        fetch1.append((time.perf_counter() - t0) * 1e3)
    b = images.shape[0]
    return {
        "batch": b,
        "p50_ms": _p(lat, 0.5),
        "p90_ms": _p(lat, 0.9),
        "p50_packed_ms": _p(lat_packed, 0.5),
        "p50_pipelined_ms": pipelined_ms,
        "compute_ms": compute_ms,
        "dispatch_ms": _p(dispatch, 0.5),
        "fetch4_ms": _p(fetch4, 0.5),
        "fetch1_ms": _p(fetch1, 0.5),
        "img_per_sec": b / (pipelined_ms / 1e3),
    }


def bench(net, batches, iters: int, artifacts=None) -> List[Dict]:
    """Rows for every (program, batch) on seeded uint8 images in the
    landscape bucket. ``artifacts`` maps a batch size to an already loaded
    artifact of `net` on the uint8 wire; the others are exported here."""
    from pytorch_retinanet_tpu_torch.export import export_inference, load_exported
    from pytorch_retinanet_tpu_torch.models.retinanet import resolution_buckets

    h, w = resolution_buckets(net.min_size, net.max_size)[0]
    artifacts = dict(artifacts or {})
    rng = np.random.default_rng(0)
    rows = []
    for b in batches:
        images = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)).to(net.device)
        sizes = torch.tensor([[net.min_size, net.max_size]] * b, dtype=torch.float32,
                             device=net.device)
        for program in ("eager", "artifact"):
            if program == "eager":
                call = net._predict_impl
            else:
                if b not in artifacts:
                    artifacts[b] = load_exported(export_inference(net, b, (h, w), "uint8"))
                call = artifacts[b].dispatch
            gc.collect()  # an export just before leaves garbage to collect outside the timing
            row = {"program": program, "wire": "uint8", **latency_row(call, images, sizes, iters),
                   "host_transfer_f32_ms": transfer_ms(b, h, w, torch.float32),
                   "host_transfer_u8_ms": transfer_ms(b, h, w, torch.uint8)}
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="1,2,4,8")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--out", default=None, help="write the rows here as one JSON object")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_bench_latency: CUDA is not available; it measures the card only")

    from pytorch_retinanet_tpu_torch.models import Retinanet

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    net = Retinanet(backbone_kind="resnet50", num_classes=90, pretrained=False, prior=0.5,
                    seed=0)
    rows = bench(net, [int(b) for b in args.batches.split(",")], args.iters)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"metric": "serving_latency_resnet50_800x1344_uint8", "card": card,
                       "unit": "ms/request", "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
