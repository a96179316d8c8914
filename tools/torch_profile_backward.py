"""Per-stage forward and backward of the port's training step -> BACKWARD_PROFILE_TORCH.jsonl.

The port's counterpart of ``tools/profile_backward.py``. JAX cuts the
program at nested prefixes and differences their gradients; here one
``Trainer`` step's own backward is timed at its stage boundaries. R50-FPN,
90 classes, batch 16 at 800x1344, ``configs/hparams.yaml``'s SGD, frozen BN
and then live BN (``freeze_bn=False``, the module in training mode, as the
Trainer runs it).

How the boundaries are read: autograd runs the ready node with the highest
sequence number first, so the backward walks the stages in reverse forward
order, each stage whole before the next: loss, head, FPN, layer4 ... layer1,
stem. A tensor hook on a stage's input runs when the engine starts that
input's producer, i.e. as the next stage begins; it records a CUDA event
(the first hook of a boundary's tensors counts). The forward's boundaries
are module hooks. Events before ``backward()`` and after it close the first
and last stage; the stem's backward is its weight gradient (the images need
none).

Check: the stages sum to the backward of separate, unhooked iterations
(events around ``backward()`` alone) within ``SUM_TOL``; on the card the
tool exits 1 otherwise (on the CPU the host clock times both, and the
record keeps the ratio). Each stage's conv GFLOP (2 x MACs; the backward's dX + dW at
twice the forward's, the stem's dW at once) gives its TFLOP/s. On the card
one ``torch.profiler`` window around a backward gives its kernels by device
time (``backward_kernels``): what each BN mode spends its backward on.

    python tools/torch_profile_backward.py                         # on the card
    python tools/torch_profile_backward.py --device cpu --backbone resnet18 \
        --size 64x96 --batch 2 --iters 1 --compute-dtype float32 --out /tmp/b.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pytorch_retinanet_tpu_torch.models.retinanet import resolve_device  # noqa: E402
from pytorch_retinanet_tpu_torch.ops import retinanet_loss_levels  # noqa: E402
from pytorch_retinanet_tpu_torch.utils.flops import (  # noqa: E402
    fpn_flops,
    head_flops,
    resnet_stage_flops,
    supported_trunks,
)
from torch_bench_train import HPARAMS, make_trainer, seeded_batch, step_times  # noqa: E402
from torch_parity_report import device_label, synchronize  # noqa: E402

STAGES = ("stem", "layer1", "layer2", "layer3", "layer4", "fpn", "head", "loss")
SUM_TOL = 0.05


class Clock:
    """Marks on the card's stream (CUDA events) or, on the CPU, the host clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def stage_gflop(kind: str, h: int, w: int, batch: int, num_classes: int) -> Dict[str, float]:
    """Forward conv GFLOP per stage (2 x MACs, convs only) for the batch; None
    for a trunk ``utils/flops.py`` does not tabulate (the basic ResNets)."""
    if kind not in supported_trunks():
        return dict.fromkeys(STAGES)
    out = {**resnet_stage_flops(h, w, kind), "fpn": fpn_flops(h, w),
           "head": head_flops(h, w, num_classes=num_classes), "loss": 0}
    return {k: v * batch / 1e9 for k, v in out.items()}


class StageMarks:
    """Forward and backward stage boundaries of one RetinaNetModule call."""

    def __init__(self, module, clock: Clock):
        self.clock = clock
        self.fwd: Dict[str, object] = {}
        self.bwd: Dict[str, object] = {}
        resnet = module.backbone.backbone
        self._handles = [
            resnet.layer1.register_forward_pre_hook(self._pre("stem")),
            *(getattr(resnet, f"layer{i}").register_forward_hook(self._post(f"layer{i}"))
              for i in range(1, 5)),
            module.fpn.register_forward_hook(self._post("fpn")),
            module.retinanet_head.register_forward_hook(self._post("head")),
        ]

    def close(self) -> None:
        for h in self._handles:
            h.remove()

    def _mark_backward(self, name: str, tensors) -> None:
        """At the first of `tensors`' gradients to be consumed, the backward
        of the stage after `name` is over and `name`'s begins."""
        for t in tensors:
            if t.requires_grad:
                t.register_hook(lambda g, name=name: self._first(self.bwd, name))

    def _first(self, marks: dict, name: str) -> None:
        if name not in marks:
            marks[name] = self.clock.mark()

    def _pre(self, name):
        def hook(mod, args):
            self._first(self.fwd, name)
            self._mark_backward(name, args[:1])
        return hook

    def _post(self, name):
        def hook(mod, args, out):
            self._first(self.fwd, name)
            flat = out if name != "head" else [t for level in out for t in level]
            self._mark_backward(name, flat if isinstance(flat, (list, tuple)) else [flat])
        return hook


def one_step(module, anchors, batch, num_classes: int, clock: Clock, hooked: bool):
    """Forward, loss and backward of `batch` (the module in training mode);
    returns the forward and backward stage ms (or their totals)."""
    marks = StageMarks(module, clock) if hooked else None
    images, boxes, labels, valid = (batch[k] for k in ("images", "boxes", "labels", "valid"))
    t0 = clock.mark()
    cls_levels, box_levels = module(images, return_levels=True)
    losses = retinanet_loss_levels(cls_levels, box_levels, anchors, boxes, labels, valid,
                                   num_classes=num_classes)
    loss = losses["classification_loss"] + losses["regression_loss"]
    t1 = clock.mark()
    loss.backward()
    t2 = clock.mark()
    module.zero_grad(set_to_none=True)
    synchronize(images.device)
    totals = {"forward_total": clock.ms(t0, t1), "backward_total": clock.ms(t1, t2)}
    if marks is None:
        return totals
    marks.close()
    fwd_edges = [t0] + [marks.fwd[s] for s in STAGES[:-1]] + [t1]
    bwd_edges = [t1] + [marks.bwd[s] for s in reversed(STAGES[:-1])] + [t2]
    fwd = {s: clock.ms(a, b) for s, a, b in zip(STAGES, fwd_edges, fwd_edges[1:])}
    bwd = {s: clock.ms(a, b) for s, a, b in zip(reversed(STAGES), bwd_edges, bwd_edges[1:])}
    return {"forward": fwd, "backward": bwd, **totals}


def backward_kernels(module, anchors, batch, num_classes: int, top: int = 15, windows: int = 3):
    """The backward's CUDA kernels by device time, from one ``torch.profiler``
    window around ``backward()`` alone: the `top` names, ms and launches a
    step. None on the CPU, or where no window recorded a kernel (the card's
    tracer now and then returns an empty one)."""
    from torch.profiler import ProfilerActivity, profile

    if batch["images"].device.type != "cuda":
        return None
    images, boxes, labels, valid = (batch[k] for k in ("images", "boxes", "labels", "valid"))
    for _ in range(windows):
        cls_levels, box_levels = module(images, return_levels=True)
        losses = retinanet_loss_levels(cls_levels, box_levels, anchors, boxes, labels, valid,
                                       num_classes=num_classes)
        loss = losses["classification_loss"] + losses["regression_loss"]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            loss.backward()
            torch.cuda.synchronize()
        module.zero_grad(set_to_none=True)
        kernels: Dict[str, list] = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                k = kernels.setdefault(e.name.removeprefix("void ")[:240], [0.0, 0])
                k[0] += e.time_range.elapsed_us() / 1e3
                k[1] += 1
        if kernels:
            total = sum(ms for ms, _ in kernels.values())
            rows = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]
            return {"device_ms": total,
                    "top": [{"kernel": k, "ms": ms, "launches": n} for k, (ms, n) in rows]}
    return None


def profile_mode(conf: dict, size, batch_size: int, iters: int, device: torch.device) -> dict:
    """One BN mode: the step, the unhooked forward and backward, the stages."""
    num_classes = HPARAMS["model"]["num_classes"]
    data = seeded_batch(batch_size, *size, num_classes)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    model, trainer, batch = make_trainer(conf, data, device)
    module = model.net.module
    anchors = model.net._anchors_for(tuple(size))
    step = step_times(trainer, batch, device, iters)
    module.train()
    clock = Clock(device)
    one_step(module, anchors, batch, num_classes, clock, hooked=True)  # warm-up
    plain, staged = [], []
    for _ in range(iters):  # in turns
        plain.append(one_step(module, anchors, batch, num_classes, clock, False))
        staged.append(one_step(module, anchors, batch, num_classes, clock, True))
    med = lambda xs: float(np.median(xs))  # noqa: E731
    fwd_ms = med([p["forward_total"] for p in plain])
    bwd_ms = med([p["backward_total"] for p in plain])
    gflop = stage_gflop(conf["backbone_kind"], *size, batch_size, num_classes)
    rows = []
    for s in STAGES:
        b = med([st["backward"][s] for st in staged])
        bwd_gflop = None if gflop[s] is None else gflop[s] * (1.0 if s == "stem" else 2.0)
        rows.append({"stage": s, "fwd_ms": med([st["forward"][s] for st in staged]), "bwd_ms": b,
                     "fwd_gflop": gflop[s], "bwd_gflop": bwd_gflop,
                     "bwd_tflops": None if bwd_gflop is None else bwd_gflop / b})
    stage_sum = sum(r["bwd_ms"] for r in rows)
    kernels = backward_kernels(module, anchors, batch, num_classes)
    out = {"step_ms": med(step), "forward_loss_ms": fwd_ms, "backward_ms": bwd_ms,
           "optimizer_and_rest_ms": med(step) - fwd_ms - bwd_ms,
           "hooked_backward_ms": med([st["backward_total"] for st in staged]),
           "stage_sum_bwd_ms": stage_sum, "stage_sum_over_backward": stage_sum / bwd_ms,
           "stage_sum_fwd_ms": sum(r["fwd_ms"] for r in rows), "rows": rows,
           "backward_kernels": kernels}
    if device.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    del model, trainer, batch, module
    return out


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backbone", default="resnet50")
    ap.add_argument("--size", default="800x1344", help="HxW of the padded batch")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--compute-dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--out", default=os.path.join(REPO, "BACKWARD_PROFILE_TORCH.jsonl"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    size = tuple(int(v) for v in args.size.split("x"))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    record = {"batch": args.batch, "hw": list(size), "backbone": args.backbone,
              "compute_dtype": args.compute_dtype, "device": device_label(device),
              "torch": torch.__version__, "iters": args.iters,
              "timing": "CUDA events (host clock on the CPU), medians of iters; step ms host "
                        "clock around a synchronize, batch on the device", "bn": {}}
    for bn, freeze in (("frozen", True), ("live", False)):
        conf = {"backbone_kind": args.backbone, "freeze_bn": freeze,
                "compute_dtype": args.compute_dtype}
        record["bn"][bn] = profile_mode(conf, size, args.batch, args.iters, device)
        r = record["bn"][bn]
        print(f"[{bn} BN] step {r['step_ms']:.2f} ms; forward+loss {r['forward_loss_ms']:.2f}; "
              f"backward {r['backward_ms']:.2f} (stages sum {r['stage_sum_bwd_ms']:.2f})", flush=True)
        for row in r["rows"]:
            print(f"  {row['stage']:7s} fwd {row['fwd_ms']:8.2f} ms  bwd {row['bwd_ms']:8.2f} ms",
                  flush=True)
        for k in (r["backward_kernels"] or {}).get("top", []):
            print(f"  {k['ms']:8.2f} ms x{k['launches']:4d}  {k['kernel']}", flush=True)
    with open(args.out, "a") as f:
        f.write(json.dumps(record) + "\n")
    print(json.dumps({bn: {k: r[k] for k in ("step_ms", "backward_ms", "stage_sum_bwd_ms")}
                      for bn, r in record["bn"].items()}))
    off = {bn: r["stage_sum_over_backward"] for bn, r in record["bn"].items()
           if abs(r["stage_sum_over_backward"] - 1) > SUM_TOL}
    if off and device.type == "cuda":  # on the CPU the host clock times both, noisily
        raise SystemExit(f"stages sum to {off} of the measured backward (limit {SUM_TOL})")
    return record


if __name__ == "__main__":
    main()
