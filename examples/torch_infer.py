"""Inference example of the PyTorch port: load a detector, detect on images, draw boxes.

Counterpart of ``examples/infer.py``. ``--state`` is a checkpoint of the
port's ``Trainer`` (a ``checkpoint.pt``, or the directory holding it, such
as ``checkpoints/best``) or a reference-schema ``state_dict`` saved with
``torch.save`` (``Retinanet.save_torch_state_dict``).

    python examples/torch_infer.py --state checkpoints/best --num-classes 4 \\
        --images img1.jpg img2.jpg --out-dir detections/
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch

from pytorch_retinanet_tpu_torch.models import Retinanet
from pytorch_retinanet_tpu_torch.utils import visualize_boxes_and_labels_on_image_array


def load_weights(net: Retinanet, path: str) -> None:
    """A Trainer checkpoint (file or directory) or a reference-schema state_dict."""
    if os.path.isdir(path):
        path = os.path.join(path, "checkpoint.pt")
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "module" in state:
        net.load_state_dict(state["module"])
    else:
        net.load_torch_state_dict(state)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--state", required=True,
                    help="Trainer checkpoint (checkpoint.pt or its directory) or state_dict .pt")
    ap.add_argument("--num-classes", type=int, required=True)
    ap.add_argument("--backbone", default="resnet50")
    ap.add_argument("--images", nargs="+", required=True)
    ap.add_argument("--labels", nargs="*", default=None, help="class names (background first)")
    ap.add_argument("--min-size", type=int, default=800)
    ap.add_argument("--max-size", type=int, default=1333)
    ap.add_argument("--score-thresh", type=float, default=0.5)
    ap.add_argument("--out-dir", default="detections")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu")
    ap.add_argument("--compute-dtype", default="bfloat16", choices=["bfloat16", "float32"],
                    help="float32 where the CPU build's bf16 convolutions go non-finite")
    args = ap.parse_args()

    import cv2

    net = Retinanet(
        num_classes=args.num_classes,
        backbone_kind=args.backbone,
        min_size=args.min_size,
        max_size=args.max_size,
        pretrained=False,
        compute_dtype=args.compute_dtype,
        device=args.device,
    )
    load_weights(net, args.state)

    os.makedirs(args.out_dir, exist_ok=True)
    images = []
    for p in args.images:
        raw = cv2.imread(p, cv2.IMREAD_COLOR)
        if raw is None:
            raise FileNotFoundError(f"could not read image: {p}")
        images.append(cv2.cvtColor(raw, cv2.COLOR_BGR2RGB))
    results = net.predict(images)
    written = set()
    for path, img, det in zip(args.images, images, results):
        n = int((det["scores"] > args.score_thresh).sum())
        viz = visualize_boxes_and_labels_on_image_array(
            img, det["boxes"], det["labels"], det["scores"],
            args.labels, min_score_thresh=args.score_thresh,
            max_boxes_to_draw=None,
        )
        name = os.path.basename(path)
        if name in written:  # same basename from different dirs
            stem, ext = os.path.splitext(name)
            k = 1
            while f"{stem}_{k}{ext}" in written:
                k += 1
            name = f"{stem}_{k}{ext}"
        written.add(name)
        out = os.path.join(args.out_dir, name)
        cv2.imwrite(out, cv2.cvtColor(viz, cv2.COLOR_RGB2BGR))
        print(f"{path}: {n} detections > {args.score_thresh} -> {out}")


if __name__ == "__main__":
    main()
