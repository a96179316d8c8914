"""Host cost of the PyTorch port's input pipeline, per image and per stage -> LOADER_TORCH.json.

The port's counterpart of ``tools/bench_loader.py``. On seeded COCO-sized
JPEGs (640x480 and 480x640, textured, q90, ~3 GT boxes each) it times every
host stage of the port's ``data/`` layer on one thread, best of 3 passes,
ms per image:

  decode        ``PascalDataset.load_image`` (cv2.imread + BGR->RGB)
  tofloat       uint8 -> f32 / 255 at the source size (``ToFloat``)
  flip_u8/f32   ``HorizontalFlip(p=1)`` on each dtype
  resize_u8/f32 cv2.resize to the 800 / 1333 bucket scale (``resize_for_bucket_host``)
  pad_u8/f32    a zeroed 1344x1344 frame and the image written into it
  targets       box rescale and ``pad_targets``

and three end-to-end ``DetectionLoader`` pipelines (one worker thread):

  full_pipeline        f32 wire, ``Compose([HorizontalFlip(0.5), ToFloat()])``
  full_pipeline_uint8  uint8 wire, no transform
  full_pipeline_train  the training default: ``HorizontalFlip`` kept on bytes
                       (``build_transforms(..., keep_bytes=True)``), "auto" wire

then the training pipeline again with one worker per host CPU (img/s). On
the card's host the batches are pinned, as ``RetinaNetModel`` asks there.
It records the host's CPU count. Nothing here touches the card.

    python tools/torch_bench_loader.py                       # writes LOADER_TORCH.json
    python tools/torch_bench_loader.py --device cpu --images 4 --out /tmp/l.json \
        --data-dir /tmp/loader_data
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pytorch_retinanet_tpu_torch.data import DetectionLoader, PascalDataset  # noqa: E402
from pytorch_retinanet_tpu_torch.data.loader import pad_targets, resize_for_bucket_host  # noqa: E402
from pytorch_retinanet_tpu_torch.data.transforms import (  # noqa: E402
    Compose,
    HorizontalFlip,
    ToFloat,
    build_transforms,
)
from pytorch_retinanet_tpu_torch.models.retinanet import resolve_device  # noqa: E402
from torch_parity_report import device_label  # noqa: E402


def make_dataset(root: str, n: int) -> str:
    """A CSV dataset of `n` textured JPEGs of COCO's modal size, from seed 0."""
    import cv2

    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(0)
    rows = ["filename,width,height,class,xmin,ymin,xmax,ymax,labels"]
    for i in range(n):
        w, h = (640, 480) if i % 2 == 0 else (480, 640)
        # Blurred noise compresses like a natural image; a flat fill would
        # make decode unrealistically cheap.
        img = cv2.GaussianBlur(rng.randint(0, 255, (h, w, 3), np.uint8), (0, 0), 3)
        path = os.path.join(root, f"im{i}.jpg")
        cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_QUALITY, 90])
        for b in range(3):
            x0, y0 = rng.randint(0, w - 60), rng.randint(0, h - 60)
            bw, bh = rng.randint(30, 60, 2)
            rows.append(f"{path},{w},{h},c{b % 3},{x0},{y0},{x0 + bw},{y0 + bh},{b % 3 + 1}")
    csv_path = os.path.join(root, "bench.csv")
    with open(csv_path, "w") as f:
        f.write("\n".join(rows) + "\n")
    return csv_path


def time_per_image(fn, n_images: int, repeats: int = 3) -> float:
    """Best of `repeats` wall ms per image (the best filters the host's noise)."""
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, (time.perf_counter() - t0) / n_images * 1e3)
    return best


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", type=int, default=48)
    ap.add_argument("--min-size", type=int, default=800)
    ap.add_argument("--max-size", type=int, default=1333)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cuda (the default: batches pinned, as for the card) or cpu")
    ap.add_argument("--data-dir", default=os.path.join(REPO, "build", "loader_bench"))
    ap.add_argument("--out", default=os.path.join(REPO, "LOADER_TORCH.json"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    pin = device.type == "cuda"

    csv_path = make_dataset(args.data_dir, args.images)
    ds = PascalDataset(csv_path, transforms=Compose([HorizontalFlip(p=0.5), ToFloat()]))
    n = len(ds)

    # Stages, on frames decoded once.
    raw = [ds.load_image(i) for i in range(n)]
    raw_f32 = [im.astype(np.float32) / 255.0 for im in raw]
    flip = HorizontalFlip(p=1.0)
    rngs = [np.random.default_rng(i) for i in range(n)]
    boxes1, labels1 = np.asarray([[10, 10, 50, 50]], np.float32), np.asarray([1], np.int64)

    def resize_all(frames, wire):
        return [resize_for_bucket_host(im, args.min_size, args.max_size, wire_dtype=wire)[0]
                for im in frames]

    pad_hw = (1344, 1344)  # the larger bucket side both ways, as the JAX tool pads

    def pad_frames(frames, dtype):
        out = []
        for fr in frames:
            buf = np.zeros((*pad_hw, 3), dtype)
            buf[: fr.shape[0], : fr.shape[1]] = fr
            out.append(buf)
        return out

    resized_u8, resized_f32 = resize_all(raw, np.uint8), resize_all(raw_f32, np.float32)
    stages = {
        "decode": lambda: [ds.load_image(i) for i in range(n)],
        "tofloat": lambda: [im.astype(np.float32) / 255.0 for im in raw],
        "flip_u8": lambda: [flip(im, boxes1, labels1, rngs[i]) for i, im in enumerate(raw)],
        "flip_f32": lambda: [flip(im, boxes1, labels1, rngs[i]) for i, im in enumerate(raw_f32)],
        "resize_u8": lambda: resize_all(raw, np.uint8),
        "resize_f32": lambda: resize_all(raw_f32, np.float32),
        "pad_u8": lambda: pad_frames(resized_u8, np.uint8),
        "pad_f32": lambda: pad_frames(resized_f32, np.float32),
        "targets": lambda: [pad_targets(boxes1 * 1.25, labels1, 100) for _ in range(n)],
    }
    stage_ms = {k: time_per_image(v, n) for k, v in stages.items()}

    def loader(dataset, workers, dtype):
        return DetectionLoader(dataset, args.batch_size, min_size=args.min_size,
                               max_size=args.max_size, num_workers=workers, shuffle=False,
                               image_dtype=dtype, pin_memory=pin)

    def drain(ld):
        count = sum(int(batch["batch_mask"].sum()) for batch in ld)
        if count != n:
            raise RuntimeError(f"the loader gave {count} images of {n}")

    f32_loader = loader(ds, 1, np.float32)
    sample_ms = time_per_image(lambda: [f32_loader._load_sample(i) for i in range(n)], n)
    train_tfms = build_transforms([{"class_name": "HorizontalFlip", "params": {"p": 0.5}}],
                                  keep_bytes=True)
    train_ds = PascalDataset(csv_path, transforms=train_tfms)
    pipelines = {
        "full_pipeline": f32_loader,
        "full_pipeline_uint8": loader(PascalDataset(csv_path, transforms=Compose([])), 1, np.uint8),
        "full_pipeline_train": loader(train_ds, 1, "auto"),
    }
    pipeline_ms = {k: time_per_image(lambda ld=ld: drain(ld), n) for k, ld in pipelines.items()}
    if pipelines["full_pipeline_train"].image_dtype != np.uint8:
        raise RuntimeError("the training pipeline's auto wire did not resolve to uint8")
    cpus = os.cpu_count() or 1
    threaded_ms = time_per_image(lambda: drain(loader(train_ds, cpus, "auto")), n)

    result = {
        "images": n, "source_size": "640x480 / 480x640 jpeg q90 (COCO val2017's modal size)",
        "bucket": f"{args.min_size}/{args.max_size}", "batch_size": args.batch_size,
        "host": {"cpu_count": cpus, "affinity": len(os.sched_getaffinity(0)),
                 "torch": torch.__version__, "pinned": pin, "device": device_label(device)},
        "timing": "best of 3 passes, host wall ms per image; stages on one thread",
        "stage_ms": stage_ms,
        "per_image_ms": {"sample_prep_f32": sample_ms, **pipeline_ms},
        "single_thread_img_per_sec": {k: 1e3 / v for k, v in pipeline_ms.items()},
        "train_pipeline_threads": {"workers": cpus, "ms_per_image": threaded_ms,
                                   "img_per_sec": 1e3 / threaded_ms},
    }
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
        f.write("\n")
    print(json.dumps({"stage_ms": stage_ms, "per_image_ms": result["per_image_ms"],
                      "train_pipeline_threads": result["train_pipeline_threads"]}))
    return result


if __name__ == "__main__":
    main()
