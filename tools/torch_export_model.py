"""CLI: export the PyTorch port's inference program as serving artifacts.

Counterpart of ``tools/export_model.py``. Builds a port ``Retinanet``,
optionally loads a torchvision backbone, and writes one ``torch.export``
artifact (``.pt2``, with its ``.json`` sidecar) per resolution bucket
(landscape and portrait), each with the weights baked in. See
``pytorch_retinanet_tpu_torch/export.py`` for the artifact's contract. The
artifact runs on the device it was exported on (``--device``, the card by
default).

    python tools/torch_export_model.py --backbone resnet50 --num-classes 90 \\
        --batch 8 --wire-dtype uint8 --out-dir exported/
    python tools/torch_export_model.py --check exported/resnet50_800x1344_b8_u8.pt2
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backbone", default="resnet50")
    ap.add_argument("--num-classes", type=int, default=90)
    ap.add_argument("--min-size", type=int, default=800)
    ap.add_argument("--max-size", type=int, default=1333)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--wire-dtype", default="float32", choices=["float32", "uint8"],
                    help="image input dtype of the exported program; uint8 uploads a "
                    "quarter of the bytes per request (serving wire)")
    ap.add_argument("--torch-backbone", default=None,
                    help="torchvision ResNet .pth to load into the backbone")
    ap.add_argument("--device", default="cuda",
                    help="device the artifact runs on (cuda, or cpu)")
    ap.add_argument("--out-dir", default="exported")
    ap.add_argument("--check", default=None,
                    help="load an existing artifact and run a seeded batch")
    args = ap.parse_args()

    import numpy as np
    import torch

    from pytorch_retinanet_tpu_torch.export import load_exported, save_exported

    if args.check:
        infer = load_exported(args.check)
        (b, h, w, _), wire = infer.in_shapes[0].shape, infer.in_shapes[0].dtype
        images = np.random.default_rng(0).random((b, h, w, 3)).astype(np.float32)
        if wire == torch.uint8:
            images = (images * 255).astype(np.uint8)
        sizes = np.tile(np.asarray([[h, w]], np.float32), (b, 1))
        out = infer(images, sizes)
        print(f"ok: device={infer.device} batch={b} bucket={h}x{w} wire={wire} "
              f"detections_valid={int(out['valid'].sum())}")
        return

    from pytorch_retinanet_tpu_torch.models import Retinanet
    from pytorch_retinanet_tpu_torch.models.retinanet import resolution_buckets

    net = Retinanet(
        num_classes=args.num_classes,
        backbone_kind=args.backbone,
        min_size=args.min_size,
        max_size=args.max_size,
        pretrained=False,
        device=args.device,
    )
    if args.torch_backbone:
        net.load_torch_backbone(args.torch_backbone)

    for bucket in resolution_buckets(args.min_size, args.max_size):
        tag = "_u8" if args.wire_dtype == "uint8" else ""
        name = f"{args.backbone}_{bucket[0]}x{bucket[1]}_b{args.batch}{tag}.pt2"
        path = os.path.join(args.out_dir, name)
        save_exported(net, path, args.batch, bucket, wire_dtype=args.wire_dtype)
        print(f"wrote {path} ({os.path.getsize(path) / 1e6:.1f} MB)")


if __name__ == "__main__":
    main()
