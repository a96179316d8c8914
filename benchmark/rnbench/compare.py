"""The numbers that decide ``correct``: what the timed path produced,
against the plain reference (``reference.py``), which works everything out
again from the raw inputs and the seeded weights.

Predict, per checked image (boxes in the original image's pixels; the
widest over the images):

- ``box_gap_px``: for each detection, the distance (largest coordinate
  difference) to the nearest of the reference's decoded boxes of all
  anchors. It finds the anchor that the detection came from.
- ``logit_gap``: for each detection, its score's logit against the
  reference's logit of that anchor and the detection's class (a logit, as
  a sigmoid near 1 would hide the gap).
- ``nms_excess``: how far the largest IoU between two detections of one
  class (each at least ``NMS_MIN_SIDE_PX`` wide and high) lies above
  ``nms_thres`` (greedy NMS keeps no such pair).
- ``missed_iou``: for each reference detection that the program must have
  kept or suppressed, ``nms_thres`` less its largest IoU with a program
  detection of its class (0 where that IoU is above the threshold). It
  reads ``nms_thres`` for a detection the program lacks outright.
- ``extra_iou``: the same for each program detection against the
  reference's, and ``nms_thres`` for one whose anchor and class the
  reference's selection drops.

The last three do not depend on how ties fall: greedy NMS keeps a
candidate or drops it for a kept one of its class that overlaps it above
the threshold, so where bf16 and f32 break a tie differently, the box one
side keeps overlaps the box the other keeps. A detection is held to them
only where every stage of the selection (per-level anchors, per-level
pairs, the cross-level top-k, the score threshold and the other side's
``max_detections``-th score) keeps it by more than ``LOGIT_MARGIN``, and
where its box is at least ``MIN_SIDE_PX`` wide and high.

The detections' own order is not compared: it is the order of their
scores, which the logit gap already holds.

Training (see ``train.py``): each of the first three steps' loss, the
first gradient as the optimizer holds it, and the parameters' change after
the three steps, the last two as a relative gap of norms by the worst leaf.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional

import numpy as np
import torch

from . import reference as R

REF_BLOCK = 8  # images per reference forward
AMBIGUOUS_PX = 1.0
# A candidate within the logit gap that a correct run may show (the
# predict cell's limit of ``logit_gap``) of a cut may fall either way.
LOGIT_MARGIN = 0.22
# A box clipped to a sliver at the image's edge may be valid on one side only.
MIN_SIDE_PX = 1.0
# The batched NMS offsets each class by 4097 px, where f32 rounds a
# coordinate to 1/64 px: on a box under this many (original) pixels that
# moves its IoU by more than ~0.005.
NMS_MIN_SIDE_PX = 8.0


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile, linear between order statistics."""
    return float(np.percentile(np.asarray(values, np.float64), q))


@torch.no_grad()
def reference_outputs(images: List[np.ndarray], sd: Dict[str, torch.Tensor], m: Dict, device,
                      q: R.Quant = None):
    """Per image: (per-level logits and deltas, resized (h, w), original
    (h, w), bucket) of the reference detector, computed in blocks."""
    out = []
    for start in range(0, len(images), REF_BLOCK):
        block = images[start:start + REF_BLOCK]
        batch, new_hw, orig_hw = R.padded_batch(block, m["min_size"], m["max_size"], device)
        cls, box = R.detector(sd, batch, m["backbone_kind"], m["num_classes"], q)
        for i in range(len(block)):
            out.append(([c[i] for c in cls], [b[i] for b in box], new_hw[i], orig_hw[i],
                        tuple(batch.shape[1:3])))
    return out


def detections_of(outputs, m: Dict, fault: Optional[str] = None) -> List[Dict]:
    """Reference detections of `reference_outputs` (``R.postprocess``'s
    fields, on the host), boxes in original pixels."""
    dets = []
    anchors_cache = {}
    for cls, box, new_hw, orig_hw, bucket in outputs:
        if bucket not in anchors_cache:
            anchors_cache[bucket] = [torch.from_numpy(a).to(cls[0].device)
                                     for a in R.anchors_per_level(bucket)]
        d = R.postprocess(cls, box, anchors_cache[bucket], new_hw,
                          pre_nms_top_k=m["pre_nms_top_k"], score_thres=m["score_thres"],
                          nms_thres=m["nms_thres"], max_detections=m["max_detections"], fault=fault)
        d = {k: v.cpu().numpy() if torch.is_tensor(v) else v for k, v in d.items()}
        d["boxes"] = d["boxes"] * _scale(new_hw, orig_hw)
        dets.append(d)
    return dets


def _scale(new_hw, orig_hw) -> np.ndarray:
    (nh, nw), (oh, ow) = new_hw, orig_hw
    return np.array([ow, oh, ow, oh], np.float32) / np.array([nw, nh, nw, nh], np.float32)


def _logit(p) -> np.ndarray:
    p = np.clip(np.asarray(p, np.float64), 1e-12, 1 - 1e-12)
    return np.log(p / (1 - p))


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """float64 IoU, [n, 4] x [k, 4] -> [n, k]."""
    a, b = np.asarray(a, np.float64).reshape(-1, 4), np.asarray(b, np.float64).reshape(-1, 4)
    lo = np.maximum(a[:, None, :2], b[None, :, :2])
    hi = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(hi - lo, 0, None).prod(-1)
    area_a = np.clip(a[:, 2:] - a[:, :2], 0, None).prod(-1)
    area_b = np.clip(b[:, 2:] - b[:, :2], 0, None).prod(-1)
    return inter / np.maximum(area_a[:, None] + area_b[None] - inter, 1e-12)


def _shortfall(boxes, labels, other_boxes, other_labels, thr: float) -> np.ndarray:
    """Per box: `thr` less its largest IoU with an `other` box of its class,
    at least 0."""
    iou = _iou(boxes, other_boxes) * (np.asarray(labels)[:, None] == np.asarray(other_labels)[None])
    best = iou.max(1) if iou.shape[1] else np.zeros(len(iou))
    return np.clip(thr - best, 0, None)


class _Image:
    """The reference's view of one checked image: every anchor's logits,
    decoded boxes and level, and the margin by which the reference's
    selection keeps an (anchor, class) pair."""

    def __init__(self, out, ref: Dict, m: Dict, cache: Dict, device):
        cls, box, new_hw, orig_hw, bucket = out
        if bucket not in cache:
            per_level = R.anchors_per_level(bucket)
            cache[bucket] = (torch.from_numpy(np.concatenate(per_level)).to(device),
                             np.repeat(np.arange(len(per_level)), [len(a) for a in per_level]))
        anchors, level = cache[bucket]
        self.logits = torch.cat(cls).double().cpu().numpy()  # [A, C]
        resized = R.clip(R.decode(torch.cat(box), anchors), new_hw)
        self.side = (resized[:, 2:] - resized[:, :2]).amin(-1).cpu().numpy()
        self.dense = resized * torch.from_numpy(_scale(new_hw, orig_hw)).to(device)
        best = self.logits.max(1)
        self.anchor_margin = best - np.asarray(ref["anchor_cut"], np.float64)[level]
        self.pair_cut = np.asarray(ref["pair_cut"], np.float64)[level]
        self.cut = max(ref["cross_cut"], float(_logit(m["score_thres"])))

    def margin(self, anchor: np.ndarray, cls0: np.ndarray) -> np.ndarray:
        """The reference's margin of each (anchor, zero-based class) pair."""
        logit = self.logits[anchor, cls0]
        return np.minimum(np.minimum(self.anchor_margin[anchor], logit - self.pair_cut[anchor]),
                          logit - self.cut)


@torch.no_grad()
def predict_checks(images: List[np.ndarray], dets: List[Dict[str, np.ndarray]],
                   sd: Dict[str, torch.Tensor], m: Dict, device,
                   detail: Optional[List[str]] = None, outputs=None) -> Dict[str, float]:
    """The predict numbers of `dets` (one per image) against the reference
    (`outputs` of `reference_outputs`, computed here when None); what
    explains them goes into `detail`."""
    if outputs is None:
        with R.f32_exact():
            outputs = reference_outputs(images, sd, m, device)
    ref_dets = detections_of(outputs, m)
    thr, cap = float(m["nms_thres"]), int(m["max_detections"])
    out = dict.fromkeys(("box_gap_px", "logit_gap", "nms_excess", "missed_iou", "extra_iou"), 0.0)
    counts, held = [], [0, 0]
    cache = {}
    for det, ref, o in zip(dets, ref_dets, outputs):
        counts.append((len(det["scores"]), len(ref["scores"])))
        got = np.asarray(det["boxes"], np.float32).reshape(-1, 4)
        labels = np.asarray(det["labels"], np.int64).reshape(-1)
        scores = np.asarray(det["scores"], np.float64).reshape(-1)
        n = len(scores)
        if n > cap:  # more answers than the configuration allows
            out["box_gap_px"] = math.inf
            continue
        img = _Image(o, ref, m, cache, device)
        num_classes = img.logits.shape[1]
        if bool(((labels < 1) | (labels > num_classes)).any()):
            out["logit_gap"] = math.inf
            continue
        anchor = np.zeros(0, np.int64)
        if n:
            dist = (torch.as_tensor(got, device=device)[:, None, :] - img.dense[None]).abs().amax(-1)
            gap = dist.min(1).values
            # Clipping gives anchors near the image's corners the same box:
            # the detection's anchor is among those within AMBIGUOUS_PX of
            # the nearest, and its score is the one nearest the detection's.
            ref_scores = torch.sigmoid(torch.as_tensor(img.logits[:, labels - 1].T, device=device))
            diff = (torch.as_tensor(scores, device=device)[:, None] - ref_scores).abs()
            diff = torch.where(dist <= gap[:, None] + AMBIGUOUS_PX, diff, math.inf)
            anchor = diff.min(1).indices.cpu().numpy()
            out["box_gap_px"] = max(out["box_gap_px"], float(gap.max()))
            out["logit_gap"] = max(out["logit_gap"],
                                   float(np.abs(_logit(scores) - img.logits[anchor, labels - 1]).max()))
        if n > 1:
            iou = _iou(got, got)
            big = (got[:, 2:] - got[:, :2]).min(1) >= NMS_MIN_SIDE_PX
            same = (labels[:, None] == labels[None]) & big[:, None] & big[None]
            np.fill_diagonal(same, False)
            if same.any():
                out["nms_excess"] = max(out["nms_excess"], float(iou[same].max()) - thr)
        # Each reference detection that the program ranks above its own last
        # kept score (all, where it kept fewer than `cap`) is the program's, or
        # overlaps the one that suppressed it.
        prog_last = float(_logit(scores.min())) if n >= cap else -math.inf
        r_anchor, r_cls0 = ref["anchors"].astype(np.int64), ref["labels"].astype(np.int64) - 1
        must = ((img.margin(r_anchor, r_cls0) > LOGIT_MARGIN) & (img.side[r_anchor] >= MIN_SIDE_PX)
                & (ref["logits"] > prog_last + LOGIT_MARGIN))
        held[0] += int(must.sum())
        if must.any():
            short = _shortfall(ref["boxes"][must], ref["labels"][must], got, labels, thr)
            out["missed_iou"] = max(out["missed_iou"], float(short.max()))
        if n:
            # And the other way; a detection that the reference's selection
            # drops by more than the margin matches nothing.
            ref_last = float(ref["logits"][-1]) if len(ref["logits"]) >= cap else -math.inf
            margin = img.margin(anchor, labels - 1)
            if (margin < -LOGIT_MARGIN).any():
                out["extra_iou"] = max(out["extra_iou"], thr)
            must = ((margin > LOGIT_MARGIN) & (img.side[anchor] >= MIN_SIDE_PX)
                    & (img.logits[anchor, labels - 1] > ref_last + LOGIT_MARGIN))
            held[1] += int(must.sum())
            if must.any():
                short = _shortfall(got[must], labels[must], ref["boxes"], ref["labels"], thr)
                out["extra_iou"] = max(out["extra_iou"], float(short.max()))
    if detail is not None:
        differ = [c for c in counts if c[0] != c[1]]
        detail.append(f"detections per image, program / reference, where they differ: {differ[:8]} "
                      f"({len(differ)} of {len(counts)} images); held to the NMS checks: "
                      f"{held[0]} of {sum(c[1] for c in counts)} reference, "
                      f"{held[1]} of {sum(c[0] for c in counts)} program detections")
    return out


def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              keep: Optional[List[str]] = None, detail: Optional[List[str]] = None,
              what: str = "") -> float:
    """The worst leaf's | |got| - |want| | over max(|want|, the median
    leaf's |want|), over the leaves in `keep` (all when None). The three
    worst leaves go into `detail`."""
    keys = list(want) if keep is None else keep
    want_n = {k: float(torch.linalg.vector_norm(want[k].double())) for k in want}
    median = statistics.median(want_n.values())
    gaps = []
    for k in keys:
        g = float(torch.linalg.vector_norm(got[k].double()))
        gap = abs(g - want_n[k]) / max(want_n[k], median, 1e-30) if math.isfinite(g) else math.inf
        gaps.append((gap, k, g, want_n[k]))
    gaps.sort(reverse=True)
    if detail is not None:
        detail += [f"{what} leaf {k}: program {g:.6g} reference {w:.6g} gap {gap:.4g} "
                   f"(median leaf {median:.6g})" for gap, k, g, w in gaps[:3]]
    return gaps[0][0] if gaps else 0.0
