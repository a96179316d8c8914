"""Self-contained COCO detection evaluation (pycocotools-compatible bbox mAP).

The port's copy of ``pytorch_retinanet_tpu/eval/coco_eval.py``. Its greedy
matcher runs in the port's native library (:func:`..native.coco_match`).

The reference evaluates with pycocotools' ``COCOeval`` (a C-extension package;
``utils/coco/coco_eval.py:6-10``). The port does not depend on it: this
module re-implements the canonical COCO bbox evaluation
protocol in vectorized numpy, matching pycocotools' published algorithm
exactly — same greedy matcher (score-descending detections, crowd handling,
ignore regions), same 101-point interpolated precision, same 12 summary
metrics in the same ``stats`` order — so ``stats[0]`` is the AP@[.5:.95] the
reference reports (``model.py:140-146``).

Two public classes:

* :class:`COCOeval` — drop-in algorithmic replacement for
  ``pycocotools.cocoeval.COCOeval`` (bbox, segm and keypoints).
* :class:`CocoEvaluator` — reference-parity accumulator
  (``utils/coco/coco_eval.py:15``): per-batch ``update(predictions)``, then
  ``synchronize_between_processes`` / ``accumulate`` / ``summarize``.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..data.coco import COCOIndex
from ..native import coco_match


def bbox_iou_xywh(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """Pairwise IoU of xywh boxes; crowd GT uses IoU = inter / dt_area
    (pycocotools ``maskUtils.iou`` semantics for bbox)."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dx1, dy1 = dt[:, 0], dt[:, 1]
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    ix = np.maximum(
        np.minimum(dx2[:, None], gx2[None, :]) - np.maximum(dx1[:, None], gx1[None, :]),
        0,
    )
    iy = np.maximum(
        np.minimum(dy2[:, None], gy2[None, :]) - np.maximum(dy1[:, None], gy1[None, :]),
        0,
    )
    inter = ix * iy
    d_area = (dt[:, 2] * dt[:, 3])[:, None]
    g_area = (gt[:, 2] * gt[:, 3])[None, :]
    union = np.where(iscrowd[None, :].astype(bool), d_area, d_area + g_area - inter)
    return inter / np.maximum(union, 1e-12)


# COCO 17-keypoint OKS sigmas (pycocotools Params.setKpParams).
KPT_OKS_SIGMAS = np.array(
    [0.26, 0.25, 0.25, 0.35, 0.35, 0.79, 0.79, 0.72, 0.72, 0.62, 0.62,
     1.07, 1.07, 0.87, 0.87, 0.89, 0.89]
) / 10.0


class Params:
    """Evaluation parameters (pycocotools.cocoeval.Params)."""

    def __init__(self, iouType: str = "bbox"):
        self.iouType = iouType
        self.imgIds: List = []
        self.catIds: List = []
        self.iouThrs = np.linspace(0.5, 0.95, 10)
        self.recThrs = np.linspace(0.0, 1.00, 101)
        if iouType == "keypoints":
            self.maxDets = [20]
            self.areaRng = [[0.0, 1e10], [32.0**2, 96.0**2], [96.0**2, 1e10]]
            self.areaRngLbl = ["all", "medium", "large"]
            self.kpt_oks_sigmas = KPT_OKS_SIGMAS.copy()
        else:
            self.maxDets = [1, 10, 100]
            self.areaRng = [
                [0.0, 1e10],
                [0.0, 32.0**2],
                [32.0**2, 96.0**2],
                [96.0**2, 1e10],
            ]
            self.areaRngLbl = ["all", "small", "medium", "large"]
        self.useCats = 1


class COCOeval:
    """COCO evaluation (bbox / segm / keypoints):
    evaluate → accumulate → summarize → ``stats``."""

    def __init__(self, cocoGt: COCOIndex, cocoDt: COCOIndex, iouType: str = "bbox"):
        if iouType not in ("bbox", "segm", "keypoints"):
            raise NotImplementedError(f"unknown iouType {iouType!r}")
        self.iouType = iouType
        self.cocoGt = cocoGt
        self.cocoDt = cocoDt
        self.params = Params(iouType)
        self.params.imgIds = sorted(cocoGt.getImgIds())
        self.params.catIds = sorted(cocoGt.getCatIds())
        self.evalImgs: Dict = {}
        self.eval: Dict = {}
        self.stats = np.zeros(10 if iouType == "keypoints" else 12)

    # ------------------------------------------------------------------ #
    def _prepare(self):
        p = self.params
        self._gts: Dict = {}
        self._dts: Dict = {}
        for img_id in p.imgIds:
            for cat_id in p.catIds:
                self._gts[(img_id, cat_id)] = []
                self._dts[(img_id, cat_id)] = []
        for ann in self.cocoGt.anns.values():
            key = (ann["image_id"], ann["category_id"])
            if key in self._gts:
                if self.iouType == "keypoints":
                    # GT with no labeled keypoints is ignore-only
                    # (pycocotools _prepare keypoints branch).
                    ann = dict(ann)
                    nk = ann.get(
                        "num_keypoints",
                        int(np.count_nonzero(
                            np.asarray(ann.get("keypoints", []))[2::3]
                        )) if ann.get("keypoints") is not None else 0,
                    )
                    ann["ignore"] = ann.get("ignore", 0) or (nk == 0)
                self._gts[key].append(ann)
        for ann in self.cocoDt.anns.values():
            key = (ann["image_id"], ann["category_id"])
            if key in self._dts:
                self._dts[key].append(ann)

    def _gt_mask(self, ann, h: int, w: int) -> np.ndarray:
        from ..data.masks import segmentation_to_mask

        return segmentation_to_mask(ann.get("segmentation"), h, w)

    def evaluate(self):
        self._prepare()
        p = self.params
        self.ious = {
            (img_id, cat_id): self.computeIoU(img_id, cat_id)
            for img_id in p.imgIds
            for cat_id in p.catIds
        }
        self.evalImgs = {
            (img_id, cat_id, tuple(aRng)): self.evaluateImg(
                img_id, cat_id, aRng, p.maxDets[-1]
            )
            for cat_id in p.catIds
            for aRng in p.areaRng
            for img_id in p.imgIds
        }

    def computeIoU(self, img_id, cat_id) -> np.ndarray:
        gt = self._gts[(img_id, cat_id)]
        dt = sorted(self._dts[(img_id, cat_id)], key=lambda d: -d["score"])
        dt = dt[: self.params.maxDets[-1]]
        if not gt or not dt:
            return np.zeros((len(dt), len(gt)))
        if self.iouType == "keypoints":
            return self.computeOks(dt, gt)
        crowd = np.asarray([x.get("iscrowd", 0) for x in gt])
        if self.iouType == "segm":
            from ..data.masks import iou as rle_iou

            info = self.cocoGt.imgs[img_id]
            h, w = int(info["height"]), int(info["width"])
            dm = np.stack([self._gt_mask(x, h, w) for x in dt])
            gm = np.stack([self._gt_mask(x, h, w) for x in gt])
            return rle_iou(dm, gm, crowd)
        d = np.asarray([x["bbox"] for x in dt], np.float64)
        g = np.asarray([x["bbox"] for x in gt], np.float64)
        return bbox_iou_xywh(d, g, crowd)

    def computeOks(self, dts: List[dict], gts: List[dict]) -> np.ndarray:
        """Object Keypoint Similarity matrix [D, G]
        (pycocotools ``computeOks``: per-keypoint gaussian falloff scaled by
        OKS sigma and GT area; unlabeled-GT falls back to a box-distance
        penalty)."""
        sigmas = self.params.kpt_oks_sigmas
        variances = (sigmas * 2.0) ** 2
        k = len(sigmas)
        ious = np.zeros((len(dts), len(gts)))
        for j, gt in enumerate(gts):
            g = np.asarray(gt["keypoints"], np.float64)
            xg, yg, vg = g[0::3], g[1::3], g[2::3]
            k1 = int(np.count_nonzero(vg > 0))
            bb = gt["bbox"]
            x0, x1 = bb[0] - bb[2], bb[0] + bb[2] * 2
            y0, y1 = bb[1] - bb[3], bb[1] + bb[3] * 2
            for i, dt in enumerate(dts):
                d = np.asarray(dt["keypoints"], np.float64)
                xd, yd = d[0::3], d[1::3]
                if k1 > 0:
                    dx, dy = xd - xg, yd - yg
                else:
                    z = np.zeros(k)
                    dx = np.maximum(z, x0 - xd) + np.maximum(z, xd - x1)
                    dy = np.maximum(z, y0 - yd) + np.maximum(z, yd - y1)
                e = (dx**2 + dy**2) / variances / (
                    gt.get("area", bb[2] * bb[3]) + np.spacing(1)
                ) / 2.0
                if k1 > 0:
                    e = e[vg > 0]
                ious[i, j] = np.sum(np.exp(-e)) / e.shape[0] if e.size else 0.0
        return ious

    def evaluateImg(self, img_id, cat_id, aRng, maxDet) -> Optional[dict]:
        """Greedy per-image matching (pycocotools ``evaluateImg``, the
        algorithm the reference runs per batch via its patched ``evaluate``,
        reference coco_eval.py:305-348)."""
        gt = self._gts[(img_id, cat_id)]
        dt = self._dts[(img_id, cat_id)]
        if not gt and not dt:
            return None
        p = self.params
        T = len(p.iouThrs)

        gt_ignore0 = np.asarray(
            [
                # closed range [lo, hi] like pycocotools (ignore if area <
                # aRng[0] or area > aRng[1]) — half-open binning would drop
                # areas exactly at 32^2/96^2 from small/medium
                1
                if (g.get("ignore", 0) or g.get("iscrowd", 0))
                or not (aRng[0] <= g.get("area", g["bbox"][2] * g["bbox"][3]) <= aRng[1])
                else 0
                for g in gt
            ],
            np.float64,
        )
        gtind = np.argsort(gt_ignore0, kind="mergesort")  # non-ignored first
        gt = [gt[i] for i in gtind]
        gtIg = gt_ignore0[gtind]
        dtind = np.argsort([-d["score"] for d in dt], kind="mergesort")
        dt = [dt[i] for i in dtind][:maxDet]
        iscrowd = [int(g.get("iscrowd", 0)) for g in gt]

        ious_full = self.ious[(img_id, cat_id)]
        ious = ious_full[:, gtind] if ious_full.size else ious_full

        G, D = len(gt), len(dt)
        gtm = np.zeros((T, G))
        dtm = np.zeros((T, D))
        dtIg = np.zeros((T, D))
        if ious.size:
            # The greedy T*D*G matcher in C++ (pycocotools runs it in C too).
            dtm_idx, gtm_idx, dt_ig_u8 = coco_match(
                ious, gtIg, np.asarray(iscrowd, np.int32), np.asarray(p.iouThrs)
            )
            gt_ids = np.asarray([g["id"] for g in gt])
            dt_ids = np.asarray([d["id"] for d in dt])
            dtm = np.where(dtm_idx > 0, gt_ids[np.maximum(dtm_idx - 1, 0)], 0).astype(np.float64)
            gtm = np.where(gtm_idx > 0, dt_ids[np.maximum(gtm_idx - 1, 0)], 0).astype(np.float64)
            dtIg = dt_ig_u8.astype(np.float64)
        # unmatched detections outside the area range are ignored
        a = np.asarray(
            [
                not (aRng[0] <= d.get("area", d["bbox"][2] * d["bbox"][3]) <= aRng[1])
                for d in dt
            ],
            dtype=bool,
        ).reshape(1, D)
        dtIg = np.logical_or(dtIg, np.logical_and(dtm == 0, np.repeat(a, T, 0)))
        return {
            "dtMatches": dtm,
            "gtMatches": gtm,
            "dtScores": [d["score"] for d in dt],
            "gtIgnore": gtIg,
            "dtIgnore": dtIg,
        }

    def accumulate(self):
        """Accumulate per-image results into precision/recall tensors
        (pycocotools ``accumulate``)."""
        p = self.params
        T, R = len(p.iouThrs), len(p.recThrs)
        K, A, M = len(p.catIds), len(p.areaRng), len(p.maxDets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        scores = -np.ones((T, R, K, A, M))

        for k, cat_id in enumerate(p.catIds):
            for a, aRng in enumerate(p.areaRng):
                imgs = [
                    self.evalImgs.get((img_id, cat_id, tuple(aRng)))
                    for img_id in p.imgIds
                ]
                imgs = [e for e in imgs if e is not None]
                if not imgs:
                    continue
                for m, maxDet in enumerate(p.maxDets):
                    dtScores = np.concatenate(
                        [e["dtScores"][:maxDet] for e in imgs]
                    )
                    inds = np.argsort(-dtScores, kind="mergesort")
                    dtScoresSorted = dtScores[inds]
                    dtm = np.concatenate(
                        [e["dtMatches"][:, :maxDet] for e in imgs], axis=1
                    )[:, inds]
                    dtIg = np.concatenate(
                        [e["dtIgnore"][:, :maxDet] for e in imgs], axis=1
                    )[:, inds]
                    gtIg = np.concatenate([e["gtIgnore"] for e in imgs])
                    npig = int(np.count_nonzero(gtIg == 0))
                    if npig == 0:
                        continue
                    tps = np.logical_and(dtm, np.logical_not(dtIg))
                    fps = np.logical_and(
                        np.logical_not(dtm), np.logical_not(dtIg)
                    )
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                    for t in range(T):
                        tp, fp = tp_sum[t], fp_sum[t]
                        rc = tp / npig
                        pr = tp / np.maximum(fp + tp, np.spacing(1))
                        recall[t, k, a, m] = rc[-1] if len(rc) else 0.0
                        q = np.zeros(R)
                        ss = np.zeros(R)
                        pr = pr.tolist()
                        for i in range(len(pr) - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds_r = np.searchsorted(rc, p.recThrs, side="left")
                        for ri, pi in enumerate(inds_r):
                            if pi < len(pr):
                                q[ri] = pr[pi]
                                ss[ri] = dtScoresSorted[pi]
                        precision[t, :, k, a, m] = q
                        scores[t, :, k, a, m] = ss
        self.eval = {
            "precision": precision,
            "recall": recall,
            "scores": scores,
            "params": p,
        }

    def _summarize(self, ap: int, iouThr=None, areaRng="all", maxDets=100) -> float:
        p = self.params
        aind = [i for i, l in enumerate(p.areaRngLbl) if l == areaRng]
        mind = [i for i, m in enumerate(p.maxDets) if m == maxDets]
        if ap == 1:
            s = self.eval["precision"]
            if iouThr is not None:
                s = s[np.where(np.abs(p.iouThrs - iouThr) < 1e-9)[0]]
            s = s[:, :, :, aind, mind]
        else:
            s = self.eval["recall"]
            if iouThr is not None:
                s = s[np.where(np.abs(p.iouThrs - iouThr) < 1e-9)[0]]
            s = s[:, :, aind, mind]
        valid = s[s > -1]
        return float(np.mean(valid)) if valid.size else -1.0

    def summarize(self, verbose: bool = True):
        """Compute the canonical COCO metrics into ``stats`` (12 for
        bbox/segm, 10 for keypoints — pycocotools summarizeDets/Kps)."""
        if self.iouType == "keypoints":
            defs = [
                (1, None, "all", 20, "Average Precision  (AP) @[ OKS=0.50:0.95 | area=   all | maxDets= 20 ]"),
                (1, 0.50, "all", 20, "Average Precision  (AP) @[ OKS=0.50      | area=   all | maxDets= 20 ]"),
                (1, 0.75, "all", 20, "Average Precision  (AP) @[ OKS=0.75      | area=   all | maxDets= 20 ]"),
                (1, None, "medium", 20, "Average Precision  (AP) @[ OKS=0.50:0.95 | area=medium | maxDets= 20 ]"),
                (1, None, "large", 20, "Average Precision  (AP) @[ OKS=0.50:0.95 | area= large | maxDets= 20 ]"),
                (0, None, "all", 20, "Average Recall     (AR) @[ OKS=0.50:0.95 | area=   all | maxDets= 20 ]"),
                (0, 0.50, "all", 20, "Average Recall     (AR) @[ OKS=0.50      | area=   all | maxDets= 20 ]"),
                (0, 0.75, "all", 20, "Average Recall     (AR) @[ OKS=0.75      | area=   all | maxDets= 20 ]"),
                (0, None, "medium", 20, "Average Recall     (AR) @[ OKS=0.50:0.95 | area=medium | maxDets= 20 ]"),
                (0, None, "large", 20, "Average Recall     (AR) @[ OKS=0.50:0.95 | area= large | maxDets= 20 ]"),
            ]
            self.stats = np.asarray(
                [self._summarize(ap, thr, area, md) for ap, thr, area, md, _ in defs]
            )
            if verbose:
                for (ap, thr, area, md, label), v in zip(defs, self.stats):
                    print(f" {label} = {v:0.3f}")
            return self.stats
        defs = [
            (1, None, "all", 100, "Average Precision  (AP) @[ IoU=0.50:0.95 | area=   all | maxDets=100 ]"),
            (1, 0.50, "all", 100, "Average Precision  (AP) @[ IoU=0.50      | area=   all | maxDets=100 ]"),
            (1, 0.75, "all", 100, "Average Precision  (AP) @[ IoU=0.75      | area=   all | maxDets=100 ]"),
            (1, None, "small", 100, "Average Precision  (AP) @[ IoU=0.50:0.95 | area= small | maxDets=100 ]"),
            (1, None, "medium", 100, "Average Precision  (AP) @[ IoU=0.50:0.95 | area=medium | maxDets=100 ]"),
            (1, None, "large", 100, "Average Precision  (AP) @[ IoU=0.50:0.95 | area= large | maxDets=100 ]"),
            (0, None, "all", 1, "Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | maxDets=  1 ]"),
            (0, None, "all", 10, "Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | maxDets= 10 ]"),
            (0, None, "all", 100, "Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | maxDets=100 ]"),
            (0, None, "small", 100, "Average Recall     (AR) @[ IoU=0.50:0.95 | area= small | maxDets=100 ]"),
            (0, None, "medium", 100, "Average Recall     (AR) @[ IoU=0.50:0.95 | area=medium | maxDets=100 ]"),
            (0, None, "large", 100, "Average Recall     (AR) @[ IoU=0.50:0.95 | area= large | maxDets=100 ]"),
        ]
        self.stats = np.asarray(
            [self._summarize(ap, thr, area, md) for ap, thr, area, md, _ in defs]
        )
        if verbose:
            for (ap, thr, area, md, label), v in zip(defs, self.stats):
                print(f" {label} = {v:0.3f}")
        return self.stats


class CocoEvaluator:
    """Reference-parity evaluation accumulator (reference coco_eval.py:15-59).

    ``update`` takes ``{image_id: {"boxes" xyxy, "scores", "labels",
    ["masks"], ["keypoints"]}}`` exactly like the reference's test loop feeds
    it (``model.py:132-138``), converts per iou_type to COCO result records
    (reference prepare_for_coco_detection/segmentation/keypoint,
    coco_eval.py:71-156), and accumulates host-side until ``summarize``.
    """

    SUPPORTED = ("bbox", "segm", "keypoints")

    def __init__(self, coco_gt: COCOIndex, iou_types: Sequence[str] = ("bbox",)):
        for t in iou_types:
            if t not in self.SUPPORTED:
                raise NotImplementedError(
                    f"iou_type {t!r} not supported (one of {self.SUPPORTED})"
                )
        self.coco_gt = copy.deepcopy(coco_gt)
        self.iou_types = list(iou_types)
        self.results: Dict[str, List[dict]] = {t: [] for t in self.iou_types}
        self.img_ids: List = []
        self.coco_eval: Dict[str, COCOeval] = {}

    def update(self, predictions: Dict) -> None:
        self.img_ids.extend(predictions.keys())
        for t in self.iou_types:
            self.results[t].extend(self.prepare(predictions, t))

    def prepare(self, predictions: Dict, iou_type: str) -> List[dict]:
        if iou_type == "bbox":
            return self.prepare_for_coco_detection(predictions)
        if iou_type == "segm":
            return self.prepare_for_coco_segmentation(predictions)
        return self.prepare_for_coco_keypoint(predictions)

    @staticmethod
    def prepare_for_coco_detection(predictions: Dict) -> List[dict]:
        records = []
        for image_id, pred in predictions.items():
            boxes = np.asarray(pred["boxes"], np.float64).reshape(-1, 4)
            if not len(boxes):
                continue
            xywh = boxes.copy()
            xywh[:, 2:] -= xywh[:, :2]
            scores = np.asarray(pred["scores"], np.float64)
            labels = np.asarray(pred["labels"], np.int64)
            records.extend(
                {
                    "image_id": image_id,
                    "category_id": int(labels[i]),
                    "bbox": [float(v) for v in xywh[i]],
                    "score": float(scores[i]),
                }
                for i in range(len(boxes))
            )
        return records

    @staticmethod
    def prepare_for_coco_segmentation(predictions: Dict) -> List[dict]:
        """Binary instance masks → compressed-RLE result records (reference
        prepare_for_coco_segmentation, coco_eval.py:95-123; masks > 0.5 like
        the reference's threshold)."""
        from ..data.masks import encode

        records = []
        for image_id, pred in predictions.items():
            masks = pred.get("masks")
            if masks is None or len(masks) == 0:
                continue
            masks = np.asarray(masks)
            scores = np.asarray(pred["scores"], np.float64)
            labels = np.asarray(pred["labels"], np.int64)
            records.extend(
                {
                    "image_id": image_id,
                    "category_id": int(labels[i]),
                    "segmentation": encode(masks[i] > 0.5),
                    "score": float(scores[i]),
                }
                for i in range(len(masks))
            )
        return records

    @staticmethod
    def prepare_for_coco_keypoint(predictions: Dict) -> List[dict]:
        """[N, K, 3] keypoints → flattened result records (reference
        prepare_for_coco_keypoint, coco_eval.py:126-156)."""
        records = []
        for image_id, pred in predictions.items():
            kps = pred.get("keypoints")
            if kps is None or len(kps) == 0:
                continue
            kps = np.asarray(kps, np.float64).reshape(len(kps), -1)
            scores = np.asarray(pred["scores"], np.float64)
            labels = np.asarray(pred["labels"], np.int64)
            records.extend(
                {
                    "image_id": image_id,
                    "category_id": int(labels[i]),
                    "keypoints": [float(v) for v in kps[i]],
                    "score": float(scores[i]),
                }
                for i in range(len(kps))
            )
        return records

    def synchronize_between_processes(self, all_gather_fn=None) -> None:
        """Merge result shards across data-parallel eval processes (reference
        coco_eval.py:44-49/164-183 used pickle-over-NCCL).

        ``all_gather_fn(obj)`` returns every process's ``obj`` in rank order
        (``parallel.all_gather_objects``, as ``Trainer.test`` passes it); every
        rank then holds all image ids and results, in rank order. Without
        one this is the single-process identity."""
        if all_gather_fn is None:
            def all_gather_fn(obj):
                return [obj]
        merged_ids = all_gather_fn(self.img_ids)
        self.img_ids = [i for shard in merged_ids for i in shard]
        for t in self.iou_types:
            merged = all_gather_fn(self.results[t])
            self.results[t] = [r for shard in merged for r in shard]

    def accumulate(self) -> None:
        for t in self.iou_types:
            res = self.results[t]
            coco_dt = self.coco_gt.loadRes(res) if res else COCOIndex()
            e = COCOeval(self.coco_gt, coco_dt, t)
            e.params.imgIds = sorted(set(self.img_ids)) or e.params.imgIds
            e.evaluate()
            e.accumulate()
            self.coco_eval[t] = e

    def summarize(self, verbose: bool = True) -> Dict[str, np.ndarray]:
        """Summarize every iou_type → ``{iou_type: stats array}``.

        The headline metric is ``summarize()["bbox"][0]`` (AP@[.5:.95]),
        exactly what the reference reads as ``coco_eval["bbox"].stats[0]``
        (reference model.py:140-146). Returning the full per-type dict means
        segm/keypoint stats are never silently dropped when multiple
        iou_types are evaluated."""
        if not self.coco_eval:
            self.accumulate()
        return {t: self.coco_eval[t].summarize(verbose) for t in self.iou_types}
