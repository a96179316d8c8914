// Native host-side detection ops of pytorch_retinanet_tpu_torch: the port's
// own copy of pytorch_retinanet_tpu/native/src/detection_native.cc.
//
// The reference delegates its native needs to torchvision's C++/CUDA NMS
// (reference retinanet/models.py:210) and pycocotools' C extension
// (reference utils/coco/coco_eval.py:6). The device-side work runs in the
// CUDA kernels under csrc/; this library provides the HOST-side pieces:
//
//   * nms_xyxy        — greedy hard NMS (a host test oracle)
//   * box_iou_xyxy    — pairwise IoU used by the host tooling
//   * coco_match      — the COCO evaluator's per-(image,category) greedy
//                       matcher across IoU thresholds: the O(T*D*G) inner loop
//                       that dominates mAP evaluation wall-time (pycocotools
//                       runs this in C too; evaluateImg in cocoeval.py)
//   * coco_iou_xywh   — pairwise IoU in COCO xywh convention with crowd
//                       semantics (inter/dt_area for crowd GT)
//   * rle_decode_runs, rle_encode_mask, mask_iou — the COCO RLE mask codec
//                       and mask IoU
//
// Exposed as a plain C ABI consumed via ctypes (no Python headers needed).

#include <algorithm>
#include <cstdint>
#include <cstring>

extern "C" {

// Pairwise IoU of XYXY boxes: out[i*nb + j] = IoU(a[i], b[j]).
void box_iou_xyxy(const float* a, int na, const float* b, int nb, float* out) {
  for (int i = 0; i < na; ++i) {
    const float ax1 = a[i * 4], ay1 = a[i * 4 + 1], ax2 = a[i * 4 + 2],
                ay2 = a[i * 4 + 3];
    const float aarea =
        std::max(0.f, ax2 - ax1) * std::max(0.f, ay2 - ay1);
    for (int j = 0; j < nb; ++j) {
      const float bx1 = b[j * 4], by1 = b[j * 4 + 1], bx2 = b[j * 4 + 2],
                  by2 = b[j * 4 + 3];
      const float iw =
          std::min(ax2, bx2) - std::max(ax1, bx1);
      const float ih =
          std::min(ay2, by2) - std::max(ay1, by1);
      const float inter = std::max(0.f, iw) * std::max(0.f, ih);
      const float barea =
          std::max(0.f, bx2 - bx1) * std::max(0.f, by2 - by1);
      const float uni = aarea + barea - inter;
      out[i * nb + j] = uni > 0.f ? inter / uni : 0.f;
    }
  }
}

// Greedy hard NMS over score-DESCENDING XYXY boxes (same suppression rule as
// torchvision::nms: suppress j if IoU with a kept i<j is strictly > thr).
// keep[i] in {0,1}.
void nms_xyxy(const float* boxes, int n, float iou_thr, uint8_t* keep) {
  for (int i = 0; i < n; ++i) keep[i] = 1;
  for (int i = 0; i < n; ++i) {
    if (!keep[i]) continue;
    const float x1 = boxes[i * 4], y1 = boxes[i * 4 + 1], x2 = boxes[i * 4 + 2],
                y2 = boxes[i * 4 + 3];
    const float area_i =
        std::max(0.f, x2 - x1) * std::max(0.f, y2 - y1);
    for (int j = i + 1; j < n; ++j) {
      if (!keep[j]) continue;
      const float iw =
          std::min(x2, boxes[j * 4 + 2]) - std::max(x1, boxes[j * 4]);
      const float ih =
          std::min(y2, boxes[j * 4 + 3]) - std::max(y1, boxes[j * 4 + 1]);
      const float inter = std::max(0.f, iw) * std::max(0.f, ih);
      const float area_j = std::max(0.f, boxes[j * 4 + 2] - boxes[j * 4]) *
                           std::max(0.f, boxes[j * 4 + 3] - boxes[j * 4 + 1]);
      const float uni = area_i + area_j - inter;
      if (uni > 0.f && inter / uni > iou_thr) keep[j] = 0;
    }
  }
}

// Pairwise IoU in COCO xywh convention. crowd[j] != 0 => IoU = inter / dt_area
// (pycocotools maskUtils.iou bbox semantics). out[d*ng + g], doubles to match
// pycocotools numerics.
void coco_iou_xywh(const double* dt, int nd, const double* gt, int ng,
                   const int32_t* crowd, double* out) {
  for (int d = 0; d < nd; ++d) {
    const double dx1 = dt[d * 4], dy1 = dt[d * 4 + 1];
    const double dx2 = dx1 + dt[d * 4 + 2], dy2 = dy1 + dt[d * 4 + 3];
    const double darea = dt[d * 4 + 2] * dt[d * 4 + 3];
    for (int g = 0; g < ng; ++g) {
      const double gx1 = gt[g * 4], gy1 = gt[g * 4 + 1];
      const double gx2 = gx1 + gt[g * 4 + 2], gy2 = gy1 + gt[g * 4 + 3];
      const double iw = std::min(dx2, gx2) - std::max(dx1, gx1);
      const double ih = std::min(dy2, gy2) - std::max(dy1, gy1);
      const double inter = std::max(0.0, iw) * std::max(0.0, ih);
      const double garea = gt[g * 4 + 2] * gt[g * 4 + 3];
      const double uni = crowd[g] ? darea : darea + garea - inter;
      out[d * ng + g] = uni > 0.0 ? inter / uni : 0.0;
    }
  }
}

// COCO evaluateImg greedy matcher (pycocotools cocoeval.py evaluateImg inner
// loop) for one (image, category, area-range) cell:
//
// Inputs:
//   ious   [D x G] row-major, with GT already sorted non-ignored-first
//   gt_ig  [G]     ignore flag per (sorted) gt
//   crowd  [G]     iscrowd per (sorted) gt
//   thrs   [T]     IoU thresholds
// Outputs:
//   dtm    [T x D] matched gt index + 1, or 0 (caller maps to ids)
//   gtm    [T x G] matched dt index + 1, or 0
//   dt_ig  [T x D] detection-ignore flags from matched-to-ignored-gt
//
// Detections must arrive score-descending (they do: computeIoU sorts).
void coco_match(const double* ious, int D, int G, const double* gt_ig,
                const int32_t* crowd, const double* thrs, int T, int32_t* dtm,
                int32_t* gtm, uint8_t* dt_ig) {
  std::memset(dtm, 0, sizeof(int32_t) * T * D);
  std::memset(gtm, 0, sizeof(int32_t) * T * G);
  std::memset(dt_ig, 0, sizeof(uint8_t) * T * D);
  for (int t = 0; t < T; ++t) {
    for (int d = 0; d < D; ++d) {
      double iou = std::min(thrs[t], 1.0 - 1e-10);
      int m = -1;
      for (int g = 0; g < G; ++g) {
        // gt already matched (and not crowd) — skip
        if (gtm[t * G + g] > 0 && !crowd[g]) continue;
        // gts are sorted non-ignored first: once we have a real match and
        // reach the ignored region, stop looking
        if (m > -1 && gt_ig[m] == 0.0 && gt_ig[g] == 1.0) break;
        if (ious[d * G + g] < iou) continue;
        iou = ious[d * G + g];
        m = g;
      }
      if (m == -1) continue;
      dt_ig[t * D + d] = gt_ig[m] != 0.0 ? 1 : 0;
      dtm[t * D + d] = m + 1;
      gtm[t * G + m] = d + 1;
    }
  }
}

// ---------------------------------------------------------------------------
// RLE mask codec (the framework's replacement for pycocotools' _mask C
// extension, reference coco_utils.py:25-45 / coco_eval.py:95-123). COCO RLE
// is COLUMN-major: runs alternate 0s/1s starting with 0s.

// Expand runs into a row-major [h, w] uint8 mask.
void rle_decode_runs(const uint32_t* counts, int m, int h, int w,
                     uint8_t* mask /* h*w, row-major */) {
  std::memset(mask, 0, (size_t)h * w);
  long pos = 0;
  for (int i = 0; i < m; ++i) {
    if (i & 1) {  // odd runs are foreground
      const long end = pos + counts[i];
      for (long p = pos; p < end; ++p) {
        // column-major position p -> (row = p % h, col = p / h)
        mask[(p % h) * (size_t)w + (p / h)] = 1;
      }
    }
    pos += counts[i];
  }
}

// Row-major [h, w] uint8 mask -> column-major runs. counts must have room for
// h*w + 1 entries; returns the run count.
int rle_encode_mask(const uint8_t* mask, int h, int w, uint32_t* counts) {
  int m = 0;
  uint8_t prev = 0;
  uint32_t run = 0;
  for (long col = 0; col < w; ++col) {
    for (long row = 0; row < h; ++row) {
      const uint8_t v = mask[row * (size_t)w + col] ? 1 : 0;
      if (v != prev) {
        counts[m++] = run;
        run = 0;
        prev = v;
      }
      ++run;
    }
  }
  counts[m++] = run;
  return m;
}

// Pairwise mask IoU with crowd semantics (inter / dt_area for crowd GT).
// dt: [D, h*w] row-major uint8; gt: [G, h*w]; out: [D, G] double.
void mask_iou(const uint8_t* dt, int nd, const uint8_t* gt, int ng,
              const int32_t* crowd, long hw, double* out) {
  for (int d = 0; d < nd; ++d) {
    const uint8_t* dm = dt + (size_t)d * hw;
    long darea = 0;
    for (long p = 0; p < hw; ++p) darea += dm[p];
    for (int g = 0; g < ng; ++g) {
      const uint8_t* gm = gt + (size_t)g * hw;
      long inter = 0, garea = 0;
      for (long p = 0; p < hw; ++p) {
        inter += dm[p] & gm[p];
        garea += gm[p];
      }
      const double uni =
          crowd[g] ? (double)darea : (double)(darea + garea - inter);
      out[(size_t)d * ng + g] = uni > 0.0 ? inter / uni : 0.0;
    }
  }
}

}  // extern "C"
