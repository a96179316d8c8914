"""The predict driver: one caller of ``Retinanet.predict`` on lists of raw
uint8 images, on the schedule its traffic file gives.

Traffic parameters (``benchmark/traffic/<name>.json``, ``"driver": "predict"``):

- ``batch``: images per call; ``pool``: images made in set-up (a whole
  number of calls; the calls cycle through them);
- ``sizes``: [[h, w], ...] original sizes; each call holds them in the same
  proportions (row r of a call has ``sizes[r % len(sizes)]``), in an order
  drawn from the seed, so every seed does the same work;
- ``arrivals``: ``{"kind": "closed"}`` (a request is due when the previous
  one returns) or ``{"kind": "open", "rate": r, "burst": b}`` (bursts of b
  requests due together, r requests a second on average);
- ``head_prior``: the class predictor's prior in the seeded weights;
  ``class_head_std``: the class subnet's weight scale (0.01 where absent,
  the paper's init, whose untrained logits lie within bf16's rounding of
  each other at the top; He's scale spreads them as a trained head's are);
- ``check_calls``: calls of the window whose detections the reference checks.

Latency of a request is the time from when it was due to when its
detections reached the host.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from . import compare, tracing, weights
from . import reference as R

TRACE_CALLS = 3
STAGE_REPS = 3


def make_pool(traffic: Dict, seed: int, device) -> List[List[np.ndarray]]:
    """The calls' image lists: uint8 HWC noise images made on the device."""
    batch, pool = int(traffic["batch"]), int(traffic["pool"])
    if pool % batch:
        raise ValueError("the pool must hold a whole number of calls")
    rng = np.random.default_rng([int(seed), 1])
    sizes = [tuple(s) for s in traffic["sizes"]]
    calls = []
    for _ in range(pool // batch):
        rows = [sizes[r % len(sizes)] for r in range(batch)]
        calls.append([rows[i] for i in rng.permutation(batch)])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    total = sum(h * w * 3 for call in calls for h, w in call)
    flat = torch.randint(0, 256, (total,), generator=gen, device=device, dtype=torch.uint8).cpu().numpy()
    out, start = [], 0
    for call in calls:
        images = []
        for h, w in call:
            # An allocation of its own, as a decoded image is: views into one
            # buffer would start at offsets that depend on the order of sizes,
            # and the upload's speed on their alignment.
            images.append(flat[start:start + h * w * 3].reshape(h, w, 3).copy())
            start += h * w * 3
        out.append(images)
    return out


def due_offsets(arrivals: Dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """Seconds after the window's start at which each of `n` open-loop
    requests is due: bursts of ``burst`` with exponential gaps of mean
    ``burst / rate``."""
    burst = int(arrivals.get("burst", 1))
    gaps = rng.exponential(burst / float(arrivals["rate"]), size=-(-n // burst))
    starts = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return np.repeat(starts, burst)[:n]


def state_dict(cfg: Dict, traffic: Dict, seed: int, device, fam) -> Dict[str, torch.Tensor]:
    return weights.make_state_dict(fam, cfg["model"], traffic["head_prior"], seed, device,
                                   traffic.get("class_head_std"))


def build(cfg: Dict, traffic: Dict, seed: int, device, fam):
    """The program's detector with the seeded weights of the trunk family
    `fam`; the configuration's ``program`` object, where it has one, goes
    to ``Retinanet`` whole."""
    from pytorch_retinanet_tpu_torch import Retinanet

    m = cfg["model"]
    sd = state_dict(cfg, traffic, seed, device, fam)
    net = Retinanet(backbone_kind=m["backbone_kind"], num_classes=m["num_classes"],
                    prior=traffic["head_prior"], pretrained=False, min_size=m["min_size"],
                    max_size=m["max_size"], compute_dtype=m["compute_dtype"],
                    freeze_bn=m["freeze_bn"], score_thres=m["score_thres"],
                    nms_thres=m["nms_thres"], max_detections_per_images=m["max_detections"],
                    device=device, **cfg.get("program", {}))
    net.load_torch_state_dict(sd)
    return net, sd


def stage_spans(net, images, sync) -> Dict:
    """The layers of calls of ``net.predict`` on `images`: its host front
    (from the call to its ``_predict_impl``, after a synchronize, on the
    host clock), then the forward and the postprocess of the batch the
    front made (CUDA events); and the NMS kernel's valid candidates (a
    counter read at the kernel's wrapper)."""
    from pytorch_retinanet_tpu_torch.kernels import nms as kernel_nms
    from pytorch_retinanet_tpu_torch.models.retinanet import apply_detector
    from pytorch_retinanet_tpu_torch.ops import process_detections_multilevel_batch

    real_impl = net._predict_impl
    entered = []

    def timed_impl(batch, sizes, *args, **kwargs):
        sync()
        entered.append((time.perf_counter(), batch, sizes))
        return real_impl(batch, sizes, *args, **kwargs)

    front = []
    net._predict_impl = timed_impl
    try:
        for _ in range(STAGE_REPS):
            sync()
            t0 = time.perf_counter()
            net.predict(images)
            front.append((entered[-1][0] - t0) * 1e3)
    finally:
        del net._predict_impl
    spans = {"predict.preprocess": front}
    _, batch, sizes = entered[-1]
    with torch.inference_mode():
        net.module.eval()
        levels = apply_detector(net.module, batch, return_levels=True)
        spans["predict.forward"] = tracing.cuda_ms(
            lambda: apply_detector(net.module, batch, return_levels=True), STAGE_REPS)
        anchors = net._anchors_for(tuple(batch.shape[1:3]))

        def post():
            return process_detections_multilevel_batch(
                *levels, anchors, sizes, score_thres=net.score_thres, nms_thres=net.nms_thres,
                max_detections=net.max_detections)

        spans["predict.postprocess"] = tracing.cuda_ms(post, STAGE_REPS)
        counted = []
        real = kernel_nms.nms_keep_mask

        def counting(boxes, valid, thr):
            counted.append((valid.sum(-1).tolist(), valid.shape[1]))
            return real(boxes, valid, thr)

        # The kernel's launch counter is read from the module's name at launch.
        counting.launches = real.launches
        kernel_nms.nms_keep_mask = counting
        try:
            post()
        finally:
            real.launches = counting.launches
            kernel_nms.nms_keep_mask = real
    counters = {}
    if counted:
        counters["nms.valid_per_image"] = counted[0][0]
        counters["nms.k"] = counted[0][1]
    return {"spans": spans, "counters": counters}


def run(ctx) -> Dict:
    cfg, traffic, seed, device = ctx.cfg, ctx.traffic, ctx.seed, ctx.device
    sync = ctx.sync
    fam = ctx.family
    net, sd = build(cfg, traffic, seed, device, fam)
    calls = make_pool(traffic, seed, device)
    batch = int(traffic["batch"])
    for images in calls:  # every shape of the window, and the kernels built
        net.predict(images)
    sync()
    arrivals = traffic["arrivals"]
    rng = np.random.default_rng([int(seed), 2])
    results, latencies = [], []
    t0 = time.perf_counter()
    setup_s = time.time() - ctx.t_start
    deadline = t0 + ctx.seconds
    offsets = None
    if arrivals["kind"] == "open":
        offsets = due_offsets(arrivals, int(arrivals["rate"] * ctx.seconds * 2) + 16, rng)
    elif arrivals["kind"] != "closed":
        raise ValueError(f"unknown arrivals kind {arrivals['kind']!r}")
    done = t0
    i = 0
    while True:
        if offsets is None:
            due = done
            if due >= deadline:
                break
        else:
            if i >= len(offsets) or t0 + offsets[i] >= deadline:
                break
            due = t0 + offsets[i]
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
        out = net.predict(calls[i % len(calls)])
        done = time.perf_counter()
        results.append(out)
        latencies.append((done - due) * 1e3)
        i += 1
    window = max(done, deadline if offsets is not None else done) - t0
    e2e = {"predict_img_s": len(results) * batch / window,
           "predict_p95_ms": compare.percentile(latencies, 95), "setup_s": setup_s}
    extra = {"trace": {}, "spans": {}, "counters": {}}
    if ctx.trace:
        extra["trace"] = tracing.Profiled().run(lambda: net.predict(calls[0]), TRACE_CALLS, sync)
        extra.update(stage_spans(net, calls[0], sync))
    peak = ctx.memory_peak()
    # The reference checks calls drawn from the seed, from different lists.
    order = rng.permutation(len(results))
    picked, lists = [], set()
    for c in order:
        if c % len(calls) not in lists:
            picked.append(int(c))
            lists.add(c % len(calls))
        if len(picked) == int(traffic["check_calls"]):
            break
    images = [im for c in picked for im in calls[c % len(calls)]]
    dets = [d for c in picked for d in results[c]]
    m = cfg["model"]
    del net, results
    gc.collect()
    ctx.free()
    detail = []
    checks = compare.predict_checks(images, dets, sd, fam, m, device, detail)
    bucket = R.resize_plan(*traffic["sizes"][0], m["min_size"], m["max_size"])[1]
    return {"e2e": e2e, "detail": detail, "attempted": len(latencies), "failed": 0,
            "memory_peak_bytes": peak, "checks": checks, **extra, "batch": batch, "bucket": bucket}
