"""The port's main path as its card tests and tools drive it.

``configs/hparams.yaml``'s values written out (PyYAML is optional on the
card's machine), the shapes the main path runs at (R50-FPN, 90 classes, the
800x1344 bucket, predict at batch 32, training at batch 16 with 100 padded
GT rows), seeded inputs at those shapes, the task model on served batches
and a step recorder. ``tests/test_torch_cuda.py``, ``tests/torch_card.py``
and the tools (``torch_kernel_table.py``, ``torch_bench_train.py``,
``torch_engine_divergence.py``) take them from here. Nothing here imports
JAX or touches CUDA while it is imported; the port is imported inside the
functions that use it.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

MAX_GT = 100
BATCH, H, W, TRAIN_BATCH = 32, 800, 1344, 16
# R-50's anchors a level at 800x1344.
LEVEL_ANCHORS = (151200, 37800, 9450, 2457, 693)
# R50 identity blocks the fused trunk sends to the bottleneck kernel at
# 800x1344: (H, W, mid, blocks per forward) of layers 2, 3 and 4.
BOTTLENECK_STAGES = ((100, 168, 128, 3), (50, 84, 256, 5), (25, 42, 512, 2))
HPARAMS = {
    "model": {"backbone_kind": "resnet50", "num_classes": 90, "freeze_bn": True,
              "min_size": 800, "max_size": 1333, "pretrained": False},
    "dataloader": {"train_bs": TRAIN_BATCH, "valid_bs": TRAIN_BATCH, "test_bs": TRAIN_BATCH},
    "optimizer": {"class_name": "torch.optim.SGD",
                  "params": {"lr": 0.001, "weight_decay": 0.001, "momentum": 0.9}},
    "scheduler": {"class_name": "torch.optim.lr_scheduler.ReduceLROnPlateau",
                  "params": {"mode": "min", "factor": 0.1, "patience": 5},
                  "interval": "epoch", "frequency": 1, "monitor": "val_loss"},
}


def seeded_gt(rng: np.random.Generator, n_valid, h: int, w: int,
              num_classes: int) -> Dict[str, np.ndarray]:
    """Padded GT drawn from `rng`: ``MAX_GT`` rows an image, `n_valid[i]` of
    them valid in image i, boxes of 16-400 px clipped to the h x w image."""
    b = len(n_valid)
    ctr = rng.uniform([0, 0], [w, h], (b, MAX_GT, 2))
    wh = rng.uniform(16, 400, (b, MAX_GT, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).clip(0, [w, h, w, h])
    valid = np.arange(MAX_GT)[None] < np.asarray(n_valid)[:, None]
    labels = np.where(valid, rng.integers(1, num_classes + 1, (b, MAX_GT)), 0)
    return {"boxes": np.where(valid[..., None], boxes, 0.0).astype(np.float32),
            "labels": labels.astype(np.int32), "valid": valid}


def seeded_batch(batch: int, h: int, w: int, num_classes: int, seed: int = 7) -> Dict[str, Any]:
    """uint8 images and padded GT (1-100 boxes of 16-400 px an image), from a seed."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (batch, h, w, 3), dtype=np.uint8)
    n_valid = rng.integers(1, MAX_GT + 1, batch)
    return {"images": images, **seeded_gt(rng, n_valid, h, w, num_classes)}


def served_model_class():
    """The task model serving ``loader`` and ``val_loader`` (lists of
    batches, no dataset on disk)."""
    from pytorch_retinanet_tpu_torch import RetinaNetModel

    class Served(RetinaNetModel):
        loader = val_loader = None

        def prepare_data(self):
            pass

        def train_dataloader(self, shard=0, num_shards=1):
            return self.loader

        def val_dataloader(self, shard=0, num_shards=1):
            return self.val_loader

    return Served


def recording(trainer) -> list:
    """Wrap the trainer's steps: each train step appends (lr, loss), each
    eval step ("eval", batch size)."""
    seen = []
    train_step, eval_step = trainer.train_step, trainer.eval_step

    def train(batch):
        lr = trainer.current_lr
        out = train_step(batch)
        seen.append((lr, out["loss"].item()))
        return out

    def evaluate(batch):
        seen.append(("eval", len(batch["images"])))
        return eval_step(batch)

    trainer.train_step, trainer.eval_step = train, evaluate
    return seen


def main_path_net(**kw):
    """R50-FPN as the predict cell runs it: 90 classes, prior 0.5, seed 0."""
    from pytorch_retinanet_tpu_torch.models import Retinanet

    return Retinanet(backbone_kind="resnet50", num_classes=90, pretrained=False, prior=0.5,
                     seed=0, **kw)


def main_path_batch(dev) -> tuple:
    """32 seeded 800x1333 uint8 images, and the padded 800x1344 batch and
    sizes that ``predict`` builds from them."""
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (800, 1333, 3), dtype=np.uint8) for _ in range(BATCH)]
    batch = torch.zeros((BATCH, H, W, 3), dtype=torch.uint8, device=dev)
    batch[:, :800, :1333] = torch.from_numpy(np.stack(images)).to(dev)
    return images, batch, torch.tensor([[800.0, 1333.0]] * BATCH, device=dev)


def match_inputs(anchors_levels, dev) -> list:
    """The training shapes' GT: [16, 100] padded rows with 0, 1, 3, 100 and
    seeded counts of valid rows, and a tie under anchor 5000 of level 0
    (image 3's rows 4 and 5 are that anchor's box; the first must win)."""
    rng = np.random.default_rng(6)
    n_valid = np.concatenate([[0, 1, 3, 100], rng.integers(1, MAX_GT + 1, TRAIN_BATCH - 4)])
    gt = seeded_gt(rng, n_valid, H, W, 90)
    gt["boxes"][3, 4] = gt["boxes"][3, 5] = anchors_levels[0][5000].cpu().numpy()
    return [torch.from_numpy(gt[k]).to(dev) for k in ("boxes", "labels", "valid")]


def r50_frozen_bn_shapes(batch: int, h: int, w: int) -> list:
    """(n, c, h, w, relu) of R-50's 53 frozen BNs in a forward at h x w, in
    order: the stem's; per block bn1 (at the block's input size), bn2, bn3,
    and the first block's downsample. bn1, bn2 and the stem's fuse their ReLU."""
    shapes = [(batch, 64, h // 2, w // 2, True)]
    hh, ww = h // 4, w // 4
    for stage, (depth, width) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
        for i in range(depth):
            stride = 2 if i == 0 and stage > 0 else 1
            shapes.append((batch, width, hh, ww, True))
            hh, ww = hh // stride, ww // stride
            shapes += [(batch, width, hh, ww, True), (batch, 4 * width, hh, ww, False)]
            if i == 0:
                shapes.append((batch, 4 * width, hh, ww, False))
    return shapes


def bottleneck_inputs(dev, b, h, w, mid, seed=0, b1=(0.5, 1.0)) -> list:
    """Seeded block inputs: x [b, h, w, 4 mid] bf16, GEMM-layout bf16
    weights, folded BN; b1 in [0.5, 1] makes conv2's zero padding matter."""
    g = torch.Generator().manual_seed(seed)
    c = 4 * mid

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=g)

    x = torch.randn((b, h, w, c), generator=g).to(torch.bfloat16)
    args = [x, torch.randn((c, mid), generator=g) * 0.05, u(0.5, 1.5, mid), u(*b1, mid),
            torch.randn((9, mid, mid), generator=g) * 0.05, u(0.5, 1.5, mid), u(-0.2, 0.2, mid),
            torch.randn((mid, c), generator=g) * 0.05, u(0.5, 1.5, c), u(-0.2, 0.2, c)]
    for i in (1, 4, 7):
        args[i] = args[i].to(torch.bfloat16)
    return [t.to(dev) for t in args]


def frozen_bn_inputs(dev, n, c, h, w, dtype, channels_last, offset, seed) -> tuple:
    """Seeded x and dy in `dtype` and layout (their storage `offset` elements
    in), and [C] f32 weight, bias, mean and var."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def activation():
        flat = torch.randn(n * c * h * w + offset, generator=g, device=dev).to(dtype)[offset:]
        return flat.view(n, h, w, c).permute(0, 3, 1, 2) if channels_last else flat.view(n, c, h, w)

    x, dy = activation(), activation()
    return x, dy, [0.5 + torch.rand(c, generator=g, device=dev),
                   0.3 * torch.randn(c, generator=g, device=dev),
                   0.3 * torch.randn(c, generator=g, device=dev),
                   0.2 + torch.rand(c, generator=g, device=dev)]


def focal_inputs(dev, b, a, c, dtype, offset, seed) -> tuple:
    """The classification head's output as training sees it: seeded logits
    of [b, a, c] in `dtype` (storage `offset` elements in) around the head's
    prior (-4.6), labels, matches (1% foreground, 2% ignored, the rest
    background) and an upstream gradient [b]."""
    g = torch.Generator(device=dev).manual_seed(seed)
    flat = (torch.randn(b * a * c + offset, generator=g, device=dev) * 2 - 4.6).to(dtype)
    u = torch.rand(b, a, generator=g, device=dev)
    matches = torch.where(u < 0.01, 0, torch.where(u < 0.03, -2, -1)).to(torch.int32)
    labels = torch.where(u < 0.01, torch.randint(1, c + 1, (b, a), generator=g, device=dev),
                         0).to(torch.int32)
    return flat[offset:].view(b, a, c), labels, matches, torch.rand(b, generator=g, device=dev) + 0.5
