"""Training-step sweep of the PyTorch port -> TRAIN_BENCH_TORCH.json.

The port's counterpart of ``tools/bench_train.py --sweep``: ``Trainer.train_step``
(forward in training mode, the per-level loss through the match kernel,
backward, ``configs/hparams.yaml``'s SGD) of R50-FPN, 90 classes, at the
800x1344 bucket, on seeded uint8 batches already on the device, at batches
8, 16 and 32, each with and without remat. Per point: the step's median ms
(host clock around a synchronize), img/s and the peak memory of the fit's
first step and the timed steps; a point that runs out of memory is recorded
as such. The knee is the smallest batch within ``KNEE_SHARE`` of the best
img/s of its remat setting.

    python tools/torch_bench_train.py                        # the sweep on the card
    python tools/torch_bench_train.py --device cpu --backbone resnet18 \
        --size 64x96 --batches 2 --iters 1 --out /tmp/t.json

``make_trainer`` and ``seeded_batch`` are shared with
``tools/torch_profile_backward.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pytorch_retinanet_tpu_torch import ConfigDict, RetinaNetModel, Trainer  # noqa: E402
from pytorch_retinanet_tpu_torch.models.retinanet import resolve_device  # noqa: E402
from torch_parity_report import device_label, synchronize  # noqa: E402

MAX_GT = 100
# configs/hparams.yaml's model and optimizer, written out (PyYAML is optional).
HPARAMS = {
    "model": {"backbone_kind": "resnet50", "num_classes": 90, "freeze_bn": True,
              "min_size": 800, "max_size": 1333, "pretrained": False},
    "optimizer": {"class_name": "torch.optim.SGD",
                  "params": {"lr": 0.001, "weight_decay": 0.001, "momentum": 0.9}},
}
KNEE_SHARE = 0.95


def seeded_batch(batch: int, h: int, w: int, num_classes: int, seed: int = 7) -> Dict[str, Any]:
    """uint8 images and padded GT (1-100 boxes of 16-400 px an image), from a seed."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (batch, h, w, 3), dtype=np.uint8)
    n_valid = rng.integers(1, MAX_GT + 1, batch)
    ctr = rng.uniform([0, 0], [w, h], (batch, MAX_GT, 2))
    wh = rng.uniform(16, 400, (batch, MAX_GT, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).clip(0, [w, h, w, h])
    valid = np.arange(MAX_GT)[None] < n_valid[:, None]
    boxes = np.where(valid[..., None], boxes, 0.0).astype(np.float32)
    labels = np.where(valid, rng.integers(1, num_classes + 1, (batch, MAX_GT)), 0)
    return {"images": images, "boxes": boxes, "labels": labels.astype(np.int32), "valid": valid}


class _Served(RetinaNetModel):
    """The task model on a list of batches (no dataset on disk)."""

    loader: List[Dict[str, Any]] = []

    def prepare_data(self):
        pass

    def train_dataloader(self, shard=0, num_shards=1):
        return self.loader

    def val_dataloader(self, shard=0, num_shards=1):
        return None


def make_trainer(model_conf: Dict[str, Any], batch: Dict[str, Any], device: torch.device):
    """A model of ``HPARAMS`` updated by `model_conf` on `device`, and its
    Trainer after one ``fit`` step on `batch` (the optimizer built, cuDNN's
    plans made); the batch itself goes back on the device."""
    model = _Served(ConfigDict(HPARAMS).merge({"model": model_conf}), device=device)
    model.loader = [batch]
    trainer = Trainer(max_steps=1, warmup_steps=0, log_every_n_steps=1, num_sanity_val_steps=0,
                      logger=False)
    trainer.fit(model)
    on_device = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    return model, trainer, on_device


def step_times(trainer, batch, device: torch.device, iters: int) -> List[float]:
    """ms of each of `iters` ``train_step`` calls, host clock around a synchronize."""
    out = []
    for _ in range(iters):
        synchronize(device)
        t0 = time.perf_counter()
        trainer.train_step(batch)
        synchronize(device)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def measure(backbone: str, size, batch: int, remat: bool, iters: int, device: torch.device,
            compute_dtype: str = "bfloat16") -> Dict[str, Any]:
    point: Dict[str, Any] = {"batch": batch, "remat": remat}
    data = seeded_batch(batch, *size, HPARAMS["model"]["num_classes"])
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    try:
        model, trainer, on_device = make_trainer(
            {"backbone_kind": backbone, "remat": remat, "compute_dtype": compute_dtype},
            data, device)
        times = step_times(trainer, on_device, device, iters)
    except torch.cuda.OutOfMemoryError as e:  # a batch that does not fit is a data point
        point["error"] = f"out of memory: {str(e)[:160]}"
        return point
    ms = float(np.median(times))
    point.update({"step_ms": ms, "img_per_sec": batch * 1e3 / ms, "step_ms_all": times})
    if device.type == "cuda":
        point["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    del model, trainer, on_device
    return point


def knees(points: List[Dict[str, Any]]) -> Dict[str, Optional[int]]:
    """Per remat setting, the smallest batch within KNEE_SHARE of its best img/s."""
    out = {}
    for remat in (False, True):
        ok = [p for p in points if p["remat"] == remat and "img_per_sec" in p]
        if not ok:
            out[f"remat={remat}"] = None
            continue
        best = max(p["img_per_sec"] for p in ok)
        out[f"remat={remat}"] = min(p["batch"] for p in ok if p["img_per_sec"] >= KNEE_SHARE * best)
    return out


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backbone", default="resnet50")
    ap.add_argument("--size", default="800x1344", help="HxW of the padded batch")
    ap.add_argument("--batches", default="8,16,32")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--compute-dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--out", default=os.path.join(REPO, "TRAIN_BENCH_TORCH.json"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    size = tuple(int(v) for v in args.size.split("x"))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    points = []
    for remat in (False, True):
        for batch in (int(b) for b in args.batches.split(",")):
            p = measure(args.backbone, size, batch, remat, args.iters, device, args.compute_dtype)
            points.append(p)
            print(json.dumps({k: v for k, v in p.items() if k != "step_ms_all"}), flush=True)
    ok = [p for p in points if "img_per_sec" in p]
    best = max(ok, key=lambda p: p["img_per_sec"]) if ok else None
    result = {
        "metric": f"train_step_{args.backbone}_{size[0]}x{size[1]}",
        "device": device_label(device), "torch": torch.__version__,
        "model": {**HPARAMS["model"], "backbone_kind": args.backbone,
                  "compute_dtype": args.compute_dtype},
        "optimizer": HPARAMS["optimizer"], "iters": args.iters,
        "timing": "median step ms, host clock around a synchronize, batch on the device",
        "best": None if best is None else {k: best[k] for k in ("batch", "remat", "img_per_sec")},
        "knee": knees(points), "knee_rule": f"smallest batch within {KNEE_SHARE} of the best img/s",
        "sweep": points,
    }
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
        f.write("\n")
    print(json.dumps({k: result[k] for k in ("metric", "device", "best", "knee")}))
    return result


if __name__ == "__main__":
    main()
