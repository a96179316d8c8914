"""Detection parity of the PyTorch port's postprocess against the torch oracle.

The port's counterpart of ``tools/parity_report.py``. A synthetic COCO-style
val set (planted GT boxes, head outputs derived from them: matched anchors
spiked to a confidence in U(0.55, 0.95) with regression targets plus noise,
150 distractors a image) feeds identical per-image head outputs to:

  1. the torch oracle        ``tools/reference_oracle.py::process_detections_torch``,
                             the reference's dynamic per-class loop, on the CPU
  2. flat full-candidates    ``ops.process_detections_batch`` with
                             ``pre_nms_top_k=4096`` (every above-0.05
                             candidate the generator plants), plain NMS
  3. the same                through the NMS kernel (the wrapper; on the CPU
                             it runs the plain version)
  4. exact top-1000/level    ``ops.process_detections_multilevel_batch``,
                             the path ``Retinanet.predict`` runs, plain NMS
  5. the same                through the NMS kernel

Each row is scored by the port's COCO evaluator (AP@[.5:.95]). JAX's
"approx top-1000/level" row has no counterpart: ``approx_max_k`` is a TPU
primitive, and the port's exact mode is its production path.

The val set is made on the CPU in numpy and the port's CPU ops, so it is the
same on every device and equal to ``tools/parity_report.py::make_val_set``'s
(tested bit for bit). Head outputs are regenerated per image (50 images of
[201600, 90] f32 would take 3.6 GB at 800x1344).

Writes (or, with ``--append``, appends) a section of ``PARITY_TORCH.md``,
prints one JSON line, and exits 1 if a row's ΔAP is not +0.0000:

    python tools/torch_parity_report.py --size 800x1344 --classes 90 --images 50
    python tools/torch_parity_report.py --device cpu --out /tmp/p.md   # 256x256, 8 classes
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pytorch_retinanet_tpu_torch.data.coco import COCOIndex  # noqa: E402
from pytorch_retinanet_tpu_torch.eval import CocoEvaluator  # noqa: E402
from pytorch_retinanet_tpu_torch.kernels import nms_keep_mask  # noqa: E402
from pytorch_retinanet_tpu_torch.models.retinanet import resolve_device  # noqa: E402
from pytorch_retinanet_tpu_torch.ops import (  # noqa: E402
    generate_anchors,
    generate_anchors_per_level,
    match_anchors,
    process_detections_batch,
    process_detections_multilevel_batch,
)
from reference_oracle import encode_boxes_torch, process_detections_torch  # noqa: E402

ORACLE = "torch oracle (reference)"
# (row, flat path, NMS kernel)
ROWS = (
    ("port flat full-candidates, plain NMS", True, False),
    ("port flat full-candidates, NMS kernel", True, True),
    ("port exact top-1000/level, plain NMS", False, False),
    ("port exact top-1000/level, NMS kernel", False, True),
)
FLAT_TOP_K = 4096
# The JAX tool's oracle AP on the same seeded sets (PARITY_REPORT.md, run on a
# TPU), by (height, width, classes, images).
JAX_ORACLE_AP = {(256, 256, 8, 50): 0.6833, (800, 1344, 90, 50): 0.6064}
HEADER = [
    "# Detection parity of the PyTorch port (measured)",
    "",
    "Written by `tools/torch_parity_report.py` (postprocess rows) and",
    "`tools/torch_loss_parity.py` (loss path). The JAX package's own record is",
    "`PARITY_REPORT.md`. Synthetic COCO-style val sets with planted noisy",
    "detections; the oracle and the port both invert the reference's",
    "training-time encoder (the reference's `activ_2_bbox` slicing bug is not",
    "reproduced, as in the JAX package). JAX's \"approx top-1000/level\" row has",
    "no port row: `approx_max_k` is a TPU primitive, and the port's exact",
    "mode is its production path.",
    "",
]


def make_val_set(n_images: int, n_classes: int, image_size, seed: int = 0):
    """Synthetic GT and a per-image head-output generator.

    The same draws as ``tools/parity_report.py::make_val_set``: anchors
    matched to a GT get its class logit spiked to a confidence drawn from
    U(0.55, 0.95) and regression targets encoded with sigma 0.05 noise; 150
    distractor anchors get mid scores. Returns ``(anchors, gt_index, gen)``
    with ``gen(img_id) -> (cls [A, C], reg [A, 4])`` f32 numpy, regenerated
    deterministically.
    """
    h, w = image_size
    anchors = generate_anchors(image_size)
    num_anchors = anchors.shape[0]

    rng = np.random.default_rng(seed)
    images, annotations = [], []
    gt_by_image = {}
    ann_id = 1
    for img_id in range(1, n_images + 1):
        images.append({"id": img_id, "height": h, "width": w})
        n_gt = int(rng.integers(1, 7))
        gts, labels = [], []
        for _ in range(n_gt):
            cx, cy = rng.uniform(40, w - 40), rng.uniform(40, h - 40)
            bw, bh = rng.uniform(20, min(220, w // 3)), rng.uniform(20, min(220, h // 3))
            box = [
                max(0.0, cx - bw / 2), max(0.0, cy - bh / 2),
                min(float(w), cx + bw / 2), min(float(h), cy + bh / 2),
            ]
            cat = int(rng.integers(1, n_classes + 1))
            gts.append(box)
            labels.append(cat)
            annotations.append({
                "id": ann_id, "image_id": img_id, "category_id": cat,
                "bbox": [box[0], box[1], box[2] - box[0], box[3] - box[1]],
                "area": (box[2] - box[0]) * (box[3] - box[1]), "iscrowd": 0,
            })
            ann_id += 1
        gt_by_image[img_id] = (np.asarray(gts, np.float32), labels)

    anchors_t = torch.from_numpy(anchors)

    def gen(img_id):
        g = np.random.default_rng([seed, img_id])
        gts_np, labels = gt_by_image[img_id]
        cls = g.normal(-8.0, 0.3, size=(num_anchors, n_classes)).astype(np.float32)
        reg = g.normal(0.0, 0.05, size=(num_anchors, 4)).astype(np.float32)
        m = match_anchors(anchors_t, torch.from_numpy(gts_np),
                          torch.ones(len(gts_np), dtype=torch.bool)).matches.numpy()
        matched = np.nonzero(m >= 0)[0]
        if len(matched):
            tgt = encode_boxes_torch(
                torch.from_numpy(gts_np[m[matched]]), torch.from_numpy(anchors[matched]),
            ).numpy()
            reg[matched] = tgt + g.normal(0, 0.05, tgt.shape).astype(np.float32)
            conf = g.uniform(0.55, 0.95, len(matched))
            for a_i, c in zip(matched, conf):
                cat = labels[m[a_i]]
                cls[a_i, cat - 1] = np.log(c / (1 - c))
        d_idx = g.choice(num_anchors, 150, replace=False)
        cls[d_idx, g.integers(0, n_classes, 150)] = g.uniform(-3.0, 0.5, 150)
        return cls, reg

    gt_index = COCOIndex({
        "images": images,
        "annotations": annotations,
        "categories": [{"id": c, "name": str(c)} for c in range(1, n_classes + 1)],
    })
    return anchors, gt_index, gen


def eval_ap(gt_index, preds) -> float:
    ev = CocoEvaluator(gt_index, ["bbox"])
    ev.update(preds)
    ev.accumulate()
    return float(ev.summarize(verbose=False)["bbox"][0])


def unpack_first(det) -> Dict[str, np.ndarray]:
    """Row 0 of batched detections, its valid slots (they come first)."""
    n = int(det.valid[0].sum())
    return {"boxes": det.boxes[0, :n].cpu().numpy(), "scores": det.scores[0, :n].cpu().numpy(),
            "labels": det.labels[0, :n].cpu().numpy()}


def card_label() -> str:
    """``nvidia-smi``'s name and power limit of the card, as its CSV gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def device_label(device: torch.device) -> str:
    return card_label() if device.type == "cuda" else "CPU"


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def write_section(out: str, lines: List[str], append: bool) -> str:
    """`lines` appended to `out`, or `out` started anew with the header."""
    out = os.path.abspath(out)
    if append and os.path.exists(out):
        with open(out, "a") as f:
            f.write("\n" + "\n".join(lines) + "\n")
    else:
        with open(out, "w") as f:
            f.write("\n".join(HEADER + lines) + "\n")
    return out


def run(images: int, classes: int, image_size, device: torch.device, seed: int = 0) -> dict:
    """Every row's AP, ΔAP against the oracle, seconds, NMS launches and peak memory."""
    anchors, gt_index, gen = make_val_set(images, classes, image_size, seed)
    per_level = [torch.from_numpy(a).to(device) for a in generate_anchors_per_level(image_size)]
    splits = [len(a) for a in per_level]
    anchors_d = torch.from_numpy(anchors).to(device)
    size_d = torch.tensor([image_size], dtype=torch.float32, device=device)

    def port(cls, reg, flat, kernel):
        if flat:
            return process_detections_batch(cls[None], reg[None], anchors_d, size_d,
                                            pre_nms_top_k=FLAT_TOP_K, use_kernel=kernel)
        return process_detections_multilevel_batch(
            [c[None] for c in cls.split(splits)], [r[None] for r in reg.split(splits)],
            per_level, size_d, use_kernel=kernel)

    names = [ORACLE] + [r[0] for r in ROWS]
    preds: Dict[str, dict] = {n: {} for n in names}
    seconds = dict.fromkeys(names, 0.0)
    launches = dict.fromkeys(names, 0)
    peak_gib: Dict[str, float] = {}
    for img_id in range(1, images + 1):
        cls, reg = gen(img_id)
        t0 = time.perf_counter()
        det = process_detections_torch(torch.from_numpy(cls), torch.from_numpy(reg),
                                       torch.from_numpy(anchors), image_size)
        preds[ORACLE][img_id] = {k: v.numpy() for k, v in det.items()}
        seconds[ORACLE] += time.perf_counter() - t0
        cls_d, reg_d = torch.from_numpy(cls).to(device), torch.from_numpy(reg).to(device)
        for name, flat, kernel in ROWS:
            if img_id == 1:  # untimed: the kernel's build and first launch
                with torch.inference_mode():
                    port(cls_d, reg_d, flat, kernel)
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            before = nms_keep_mask.launches
            synchronize(device)
            t0 = time.perf_counter()
            with torch.inference_mode():
                preds[name][img_id] = unpack_first(port(cls_d, reg_d, flat, kernel))
            seconds[name] += time.perf_counter() - t0
            launches[name] += nms_keep_mask.launches - before
            if device.type == "cuda":
                peak_gib[name] = max(peak_gib.get(name, 0.0),
                                     torch.cuda.max_memory_allocated(device) / 2**30)
        if img_id % 10 == 0:
            print(f"  image {img_id}/{images}", flush=True)

    ap = {n: eval_ap(gt_index, preds[n]) for n in names}
    rows = [{"pipeline": n, "ap": ap[n], "delta_ap": ap[n] - ap[ORACLE],
             "seconds": seconds[n], "nms_launches": launches[n],
             "peak_gib": peak_gib.get(n)} for n in names]
    return {"size": list(image_size), "classes": classes, "images": images,
            "anchors": int(anchors.shape[0]), "device": device_label(device), "rows": rows}


def report_lines(result: dict) -> List[str]:
    h, w = result["size"]
    lines = [
        f"## {h}x{w}, {result['classes']} classes, {result['images']} images "
        f"(A={result['anchors']:,}; {result['device']})",
        "",
        "Identical per-image head outputs; differences isolate the postprocess. The",
        "oracle runs on the CPU; the port's rows on the device named, one image a call.",
        "Seconds are the host clock around each row's calls, summed over the images",
        "(after an untimed call on the first image; the val set's generation excluded);",
        "peak GiB the largest peak of one call.",
        "",
        "| pipeline | AP@[.5:.95] | ΔAP vs oracle | s | NMS kernel launches | peak GiB |",
        "|---|---|---|---|---|---|",
    ]
    for r in result["rows"]:
        peak = "" if r["peak_gib"] is None else f"{r['peak_gib']:.3f}"
        lines.append(f"| {r['pipeline']} | {r['ap']:.4f} | {r['delta_ap']:+.4f} | "
                     f"{r['seconds']:.3f} | {r['nms_launches']} | {peak} |")
    jax_ap = JAX_ORACLE_AP.get((h, w, result["classes"], result["images"]))
    if jax_ap is not None:
        oracle = result["rows"][0]["ap"]
        lines += ["", f"The oracle's AP here, {oracle:.4f} ({oracle!r}), against JAX's oracle on "
                  f"the same seeded set, {jax_ap:.4f} (`PARITY_REPORT.md`, on a TPU): "
                  f"{'equal' if f'{oracle:.4f}' == f'{jax_ap:.4f}' else 'different'} to 4 "
                  "decimals."]
    return lines + [""]


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", type=int, default=50)
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--size", default="256x256", help="HxW, e.g. 800x1344")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--append", action="store_true",
                    help="append a section instead of starting the report anew")
    ap.add_argument("--out", default=os.path.join(REPO, "PARITY_TORCH.md"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    image_size = tuple(int(v) for v in args.size.split("x"))
    result = run(args.images, args.classes, image_size, device, args.seed)
    for r in result["rows"]:
        print(f"{r['pipeline']:40s} AP={r['ap']:.4f} ΔAP={r['delta_ap']:+.4f} "
              f"({r['seconds']:.2f} s, {r['nms_launches']} NMS launches)")
    result["out"] = write_section(args.out, report_lines(result), args.append)
    print(json.dumps(result))
    off = [r["pipeline"] for r in result["rows"] if f"{r['delta_ap']:+.4f}" != "+0.0000"]
    if off:
        raise SystemExit(f"ΔAP is not +0.0000 on {off}")
    return result


if __name__ == "__main__":
    main()
