"""Loss parity of the PyTorch port: the torch reference-semantics oracle vs its loss.

The port's counterpart of ``tools/loss_parity.py``, whose oracle it copies
(that file imports jax): the reference's ``RetinaNetLosses.forward``
(losses.py:113-145) as a per-image Python loop with dynamic shapes, a
torchvision-style ``box_iou`` matcher (box_utils.py:51-80), smooth-L1 on
the foreground encodes and sigmoid focal on the non-ignored anchors, with
the three documented corrections the port makes (``ops/losses.py``): the
paper's alpha, no ``+1`` logit shift, the modulating factor in the
gradient. The same seeded inputs as the JAX tool (seed 7) feed:

  1. the oracle (this file), on the CPU
  2. the port's ``retinanet_loss_levels``, plain match composition
  3. the same through the match kernel (on the card; on the CPU the
     plain composition again, ``use_match_kernel=None``)

Appends a "Loss path" section to ``PARITY_TORCH.md``, prints one JSON line,
and exits 1 if an arm is beyond the bar:

    python tools/torch_loss_parity.py                     # 800x1344, batch 4, 90 classes
    python tools/torch_loss_parity.py --device cpu --size 128x192 --out /tmp/p.md
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pytorch_retinanet_tpu_torch import config as C  # noqa: E402
from pytorch_retinanet_tpu_torch.kernels import match_targets  # noqa: E402
from pytorch_retinanet_tpu_torch.models.retinanet import resolve_device  # noqa: E402
from pytorch_retinanet_tpu_torch.ops import (  # noqa: E402
    generate_anchors_per_level,
    retinanet_loss_levels,
)
from torch_parity_report import device_label, write_section  # noqa: E402

# JAX's deltas against this oracle on the same inputs (PARITY_REPORT.md, TPU).
BAR = {"classification_loss": 1.44e-4, "regression_loss": 4.32e-6}
KEYS = ("classification_loss", "regression_loss")


def box_iou_torch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torchvision.ops.boxes.box_iou semantics (reference box_utils.py:74)."""
    area_a = (a[:, 2] - a[:, 0]).clamp(min=0) * (a[:, 3] - a[:, 1]).clamp(min=0)
    area_b = (b[:, 2] - b[:, 0]).clamp(min=0) * (b[:, 3] - b[:, 1]).clamp(min=0)
    lt = torch.max(a[:, None, :2], b[None, :, :2])
    rb = torch.min(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[:, None] + area_b[None, :] - inter).clamp(min=1e-12)


def oracle_loss_one(
    cls_logits: torch.Tensor,  # [A, C]
    box_deltas: torch.Tensor,  # [A, 4]
    anchors: torch.Tensor,  # [A, 4]
    gt_boxes: torch.Tensor,  # [n, 4] (real rows only: dynamic, as torch code has it)
    gt_labels: torch.Tensor,  # [n]
):
    """Reference ``RetinaNetLosses.calc_loss`` (losses.py:49-111) with the three
    documented corrections: one image's (cls_loss, reg_loss), each divided by
    its foreground count, as the reference's per-image terms are."""
    num_classes = cls_logits.shape[1]
    if len(gt_boxes) == 0:
        matches = torch.full((anchors.shape[0],), -2, dtype=torch.long)
    else:
        iou = box_iou_torch(gt_boxes, anchors)  # [n, A]
        vals, idx = iou.max(dim=0)  # first-occurrence argmax, like torch
        matches = idx.clone()
        matches[vals < C.IOU_THRESHOLDS_BACKGROUND] = -1
        band = (vals >= C.IOU_THRESHOLDS_BACKGROUND) & (vals <= C.IOU_THRESHOLDS_FOREGROUND)
        matches[band] = -2
    fg = matches >= 0
    num_fg = int(fg.sum().clamp(min=1))

    # smooth-L1 on the foreground encodes (losses.py:19-27; beta, sum reduction)
    reg_loss = torch.tensor(0.0)
    if fg.any():
        m = matches[fg]
        enc_t = _encode_torch(gt_boxes[m], anchors[fg])
        diff = (box_deltas[fg] - enc_t).abs()
        beta = C.SMOOTH_L1_LOSS_BETA
        reg_loss = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta).sum()

    # focal on the non-ignored anchors, one-hot minus the background column
    keep = matches >= -1
    logits = cls_logits[keep]
    labels = torch.zeros(keep.sum(), dtype=torch.long)
    labels[fg[keep]] = gt_labels[matches[keep][fg[keep]]]
    targets = torch.nn.functional.one_hot(labels, num_classes + 1)[:, 1:].float()
    p = torch.sigmoid(logits)
    ce = torch.nn.functional.binary_cross_entropy_with_logits(logits, targets, reduction="none")
    p_t = p * targets + (1 - p) * (1 - targets)
    # the paper's side (the correction of losses.py:44)
    alpha_t = C.FOCAL_LOSS_ALPHA * targets + (1 - C.FOCAL_LOSS_ALPHA) * (1 - targets)
    cls_loss = (alpha_t * (1 - p_t) ** C.FOCAL_LOSS_GAMMA * ce).sum()
    return cls_loss / num_fg, reg_loss / num_fg


def _encode_torch(gt: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """bbox_2_activ (box_utils.py:25-34) in torch, f32."""
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = (anchors[:, 0] + anchors[:, 2]) * 0.5
    acy = (anchors[:, 1] + anchors[:, 3]) * 0.5
    gw = gt[:, 2] - gt[:, 0]
    gh = gt[:, 3] - gt[:, 1]
    gcx = (gt[:, 0] + gt[:, 2]) * 0.5
    gcy = (gt[:, 1] + gt[:, 3]) * 0.5
    w = C.BBOX_REG_WEIGHTS
    return torch.stack(
        [
            (gcx - acx) / aw * w[0],
            (gcy - acy) / ah * w[1],
            torch.log(gw / aw + 1e-8) * w[2],
            torch.log(gh / ah + 1e-8) * w[3],
        ],
        dim=1,
    )


def seeded_inputs(h: int, w: int, batch: int, classes: int, max_gt: int, seed: int = 7):
    """``tools/loss_parity.py``'s draws: head outputs and 1-29 GT boxes an image."""
    anchors_levels = generate_anchors_per_level((h, w))
    num_anchors = sum(len(a) for a in anchors_levels)
    rng = np.random.default_rng(seed)
    cls = rng.normal(-4.0, 1.0, size=(batch, num_anchors, classes)).astype(np.float32)
    reg = rng.normal(0.0, 0.3, size=(batch, num_anchors, 4)).astype(np.float32)
    boxes = np.zeros((batch, max_gt, 4), np.float32)
    labels = np.zeros((batch, max_gt), np.int32)
    valid = np.zeros((batch, max_gt), bool)
    n_gts = []
    for b in range(batch):
        n = int(rng.integers(1, 30))
        n_gts.append(n)
        cx = rng.uniform(50, w - 50, n)
        cy = rng.uniform(50, h - 50, n)
        bw = rng.uniform(16, 300, n)
        bh = rng.uniform(16, 300, n)
        boxes[b, :n] = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], axis=1)
        labels[b, :n] = rng.integers(1, classes + 1, n)
        valid[b, :n] = True
    return anchors_levels, cls, reg, boxes, labels, valid, n_gts


def oracle_losses(cls, reg, anchors, boxes, labels, n_gts) -> dict:
    """The oracle's batch-averaged losses, one image at a time on the CPU."""
    cls_t, reg_t, anchors_t = (torch.from_numpy(x) for x in (cls, reg, anchors))
    cls_sum = reg_sum = 0.0
    for b, n in enumerate(n_gts):
        c_l, r_l = oracle_loss_one(cls_t[b], reg_t[b], anchors_t, torch.from_numpy(boxes[b, :n]),
                                   torch.from_numpy(labels[b, :n]).long())
        cls_sum += float(c_l)
        reg_sum += float(r_l)
    return {"classification_loss": cls_sum / len(n_gts), "regression_loss": reg_sum / len(n_gts)}


def run(h: int, w: int, batch: int, classes: int, max_gt: int, device: torch.device) -> dict:
    anchors_levels, cls, reg, boxes, labels, valid, n_gts = seeded_inputs(
        h, w, batch, classes, max_gt)
    splits = np.cumsum([len(a) for a in anchors_levels])[:-1]
    oracle = oracle_losses(cls, reg, np.concatenate(anchors_levels), boxes, labels, n_gts)

    to = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
    cls_levels = [to(a) for a in np.split(cls, splits, axis=1)]
    box_levels = [to(a) for a in np.split(reg, splits, axis=1)]
    anc_levels = [to(a) for a in anchors_levels]
    gt = (to(boxes), to(labels), to(valid))

    def port(kernel: Optional[bool]) -> dict:
        before = match_targets.launches
        with torch.no_grad():
            out = retinanet_loss_levels(cls_levels, box_levels, anc_levels, *gt,
                                        num_classes=classes, use_match_kernel=kernel)
        res = {k: float(out[k]) for k in KEYS}
        res["match_launches"] = match_targets.launches - before
        return res

    plain = port(False)
    # On the card the match kernel; on the CPU the default is the plain composition.
    kernel = port(True if device.type == "cuda" else None)
    rows = [("torch oracle (reference loop)", oracle), ("port, plain match", plain),
            ("port, match kernel", kernel)]
    within = all(abs(d[k] - oracle[k]) <= BAR[k] for _, d in rows[1:] for k in KEYS)
    return {
        "size": [h, w], "batch": batch, "classes": classes,
        "anchors": int(sum(len(a) for a in anchors_levels)), "device": device_label(device),
        "oracle": oracle, "port_plain": plain, "port_kernel": kernel,
        "kernel_bitwise_equal_plain": all(plain[k] == kernel[k] for k in KEYS),
        "max_abs_delta": max(abs(d[k] - oracle[k]) for _, d in rows[1:] for k in KEYS),
        "bar": BAR, "within_bar": within, "rows": rows,
    }


def report_lines(r: dict) -> List[str]:
    h, w = r["size"]
    lines = [
        f"## Loss path: {h}x{w}, {r['classes']} classes, batch {r['batch']} "
        f"(A={r['anchors']:,}; {r['device']})",
        "",
        "Identical head outputs and padded GT (seed 7, as `tools/loss_parity.py`) feed the",
        "oracle (a per-image dynamic loop mirroring the reference's losses.py:113-145 with",
        "the three documented corrections, on the CPU) and the port's per-level loss",
        "(`tools/torch_loss_parity.py`). The bar is JAX's delta on the same inputs:",
        f"|Δcls| <= {BAR['classification_loss']:.2e}, |Δreg| <= {BAR['regression_loss']:.2e}.",
        "",
        "| pipeline | classification | regression | Δcls vs oracle | Δreg | match kernel launches |",
        "|---|---|---|---|---|---|",
    ]
    oracle = r["oracle"]
    for name, d in r["rows"]:
        lines.append(
            f"| {name} | {d['classification_loss']:.6f} | {d['regression_loss']:.6f} | "
            f"{d['classification_loss'] - oracle['classification_loss']:+.2e} | "
            f"{d['regression_loss'] - oracle['regression_loss']:+.2e} | "
            f"{d.get('match_launches', '')} |")
    lines += ["", f"Within the bar: **{r['within_bar']}**. Match-kernel arm bit for bit equal "
              f"to the plain arm: **{r['kernel_bitwise_equal_plain']}**.", ""]
    return lines


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", default="800x1344")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--classes", type=int, default=90)
    ap.add_argument("--max-gt", type=int, default=100)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--out", default=os.path.join(REPO, "PARITY_TORCH.md"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    h, w = (int(v) for v in args.size.split("x"))
    result = run(h, w, args.batch, args.classes, args.max_gt, device)
    result["out"] = write_section(args.out, report_lines(result), append=True)
    print("\n".join(report_lines(result)))
    print(json.dumps(result))
    if not result["within_bar"]:
        raise SystemExit(f"the loss is {result['max_abs_delta']:.3e} from the oracle, beyond {BAR}")
    return result


if __name__ == "__main__":
    main()
