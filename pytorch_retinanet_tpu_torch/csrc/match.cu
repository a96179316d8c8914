// Anchor matching and loss targets for one pyramid level.
//
// Replaces pytorch_retinanet_tpu/kernels/match_pallas.py::match_targets
// (_match_kernel), which forms the [N_pad, T] IoU plane of an anchor tile in
// VMEM, reduces it, gathers the matched GT row by a one-hot sum and encodes
// it, one (image, 1024-anchor tile) grid cell at a time. The planar [4, T]
// layout and the lane tiles exist for Mosaic and are not carried over.
//
// What bounds it on an H100: at the training shapes (batch 16, the 800x1344
// bucket's 201,600 anchors, N = 100 padded GT rows) the writes, 16 x 201,600
// x 24 B = 77 MB, 0.023 ms at 3.35 TB/s. Scanning every (anchor, row) pair
// with an IEEE division each would cost 322.6 M pairs per step, about 20x
// that floor in instruction time; the pairs that can have a non-zero
// intersection are a small share of them, because a block of consecutive
// anchors covers a narrow strip of the image.
//
// Design: a grid over (256-anchor block, image), one anchor per thread.
//   1. The block reduces its anchors to their bounding box.
//   2. It stages in shared memory, in ascending row order, only the image's
//      valid GT rows that overlap that box (open intervals on both axes),
//      with their original indices, and notes the first valid row.
//   3. Each thread starts from IoU 0 at the first valid row and scans the
//      staged rows with a strict `>`; a pair whose intersection has a zero
//      side gets IoU 0 without the division.
//   4. Thresholds, the all-ignore rule, the matched row (row 0 when the
//      anchor is not foreground) read from global memory, the encode, and
//      coalesced [B, A] / [B, A, 4] stores.
// Why this equals a scan of every row: a padded row's IoU is -1 there, below
// every valid row's (>= 0), so it can win only when no row is valid, where
// the all-ignore rule decides. A culled row lies wholly on one side of the
// box, so for every anchor of the block min(g.x2, a.x2) - max(g.x1, a.x1)
// <= 0 (or the same in y): its IoU is +-0. Starting from 0 at the first
// valid row gives what the full scan gives when every IoU is 0 (the first
// valid row), and a strict `>` never lets a later 0 replace it; when some
// IoU is positive the first row that reaches the maximum is staged. The
// zero pre-test is exact because __fdiv_rn(+-0, positive) is +-0, which
// compares equal to +0. The box is reduced from the block's own anchors, so
// the cull holds for any anchor order.
//
// Exactness: the IoU follows ops/boxes.py::box_iou with GT as the first
// operand (area_g + area_a - inter, union clamped at 1e-12) and the encode
// follows ops/boxes.py::encode_boxes, with explicit round-to-nearest
// intrinsics and IEEE division (the file is also built with -fmad=false), so
// matches, labels and the centre targets equal the plain composition bit for
// bit. logf is not correctly rounded: tw and th may differ by an ulp or two.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kIouEps = 1e-12f;
constexpr float kEncodeEps = 1e-8f;

struct Params {
  int a, n;
  float fg_thr, bg_thr;
  float w0, w1, w2, w3;
};

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f), fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

__global__ void __launch_bounds__(kThreads) match_kernel(
    const float4* __restrict__ anchors, const float4* __restrict__ gt,
    const int32_t* __restrict__ labels, const uint8_t* __restrict__ valid,
    int32_t* __restrict__ matches, int32_t* __restrict__ fg_labels,
    float4* __restrict__ reg, Params p) {
  extern __shared__ float4 smem[];
  float4* s_box = smem;                                          // [n], staged rows
  float* s_area = reinterpret_cast<float*>(s_box + p.n);         // [n]
  int32_t* s_row = reinterpret_cast<int32_t*>(s_area + p.n);     // [n], original index
  __shared__ float4 s_red[kWarps];
  __shared__ int s_count[kWarps];
  __shared__ int s_first;

  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = blockIdx.x * kThreads + tid;
  const bool active = i < p.a;
  const float4 an = active ? anchors[i] : make_float4(INFINITY, INFINITY, -INFINITY, -INFINITY);

  // 1. The block's bounding box (min x1, y1; max x2, y2).
  float4 box = an;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    box.x = fminf(box.x, __shfl_xor_sync(kFull, box.x, s));
    box.y = fminf(box.y, __shfl_xor_sync(kFull, box.y, s));
    box.z = fmaxf(box.z, __shfl_xor_sync(kFull, box.z, s));
    box.w = fmaxf(box.w, __shfl_xor_sync(kFull, box.w, s));
  }
  if (lane == 0) s_red[warp] = box;
  if (tid == 0) s_first = p.n;
  __syncthreads();
  box = s_red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    const float4 o = s_red[w];
    box = make_float4(fminf(box.x, o.x), fminf(box.y, o.y), fmaxf(box.z, o.z), fmaxf(box.w, o.w));
  }

  // 2. Stage the valid rows that overlap the box, in ascending order.
  const float4* gb = gt + (size_t)b * p.n;
  const uint8_t* vb = valid + (size_t)b * p.n;
  int count = 0;
  for (int base = 0; base < p.n; base += kThreads) {
    const int j = base + tid;
    const bool v = j < p.n && vb[j];
    bool keep = false;
    float4 g = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (v) {
      g = gb[j];
      keep = !(g.z <= box.x || g.x >= box.z || g.w <= box.y || g.y >= box.w);
    }
    const unsigned kept = __ballot_sync(kFull, keep);
    const unsigned any = __ballot_sync(kFull, v);
    if (lane == 0) {
      s_count[warp] = __popc(kept);
      if (any) atomicMin(&s_first, base + warp * 32 + __ffs(any) - 1);
    }
    __syncthreads();
    int offset = count, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_count[w];
      offset += w < warp ? c : 0;
      total += c;
    }
    if (keep) {
      const int pos = offset + __popc(kept & ((1u << lane) - 1u));
      s_box[pos] = g;
      s_area[pos] = box_area(g);
      s_row[pos] = j;
    }
    count += total;
    __syncthreads();
  }
  const int first = s_first;
  if (!active) return;

  // 3. The scan: IoU 0 at the first valid row, then the staged rows.
  const bool any_gt = first < p.n;
  const float area_a = box_area(an);
  float best = any_gt ? 0.0f : -2.0f;
  int best_idx = any_gt ? first : 0;
  for (int k = 0; k < count; ++k) {
    const float4 g = s_box[k];
    const float iw = fmaxf(__fsub_rn(fminf(g.z, an.z), fmaxf(g.x, an.x)), 0.0f);
    const float ih = fmaxf(__fsub_rn(fminf(g.w, an.w), fmaxf(g.y, an.y)), 0.0f);
    if (iw == 0.0f || ih == 0.0f) continue;  // IoU +-0, never above best >= 0
    const float inter = __fmul_rn(iw, ih);
    const float uni = __fsub_rn(__fadd_rn(s_area[k], area_a), inter);
    const float v = __fdiv_rn(inter, fmaxf(uni, kIouEps));
    if (v > best) {
      best = v;
      best_idx = s_row[k];
    }
  }

  // 4. Thresholds, the matched row, the encode.
  int m = -2;
  if (best < p.bg_thr) m = -1;
  if (best > p.fg_thr) m = best_idx;
  if (!any_gt) m = -2;
  const bool fg = m >= 0;
  const int sel = fg ? best_idx : 0;
  const float4 g = gb[sel];

  const float acx = __fmul_rn(__fadd_rn(an.x, an.z), 0.5f);
  const float acy = __fmul_rn(__fadd_rn(an.y, an.w), 0.5f);
  const float aw = __fsub_rn(an.z, an.x);
  const float ah = __fsub_rn(an.w, an.y);
  const float mcx = __fmul_rn(__fadd_rn(g.x, g.z), 0.5f);
  const float mcy = __fmul_rn(__fadd_rn(g.y, g.w), 0.5f);
  const float mw = __fsub_rn(g.z, g.x);
  const float mh = __fsub_rn(g.w, g.y);
  float4 t;
  t.x = __fmul_rn(__fdiv_rn(__fsub_rn(mcx, acx), aw), p.w0);
  t.y = __fmul_rn(__fdiv_rn(__fsub_rn(mcy, acy), ah), p.w1);
  t.z = __fmul_rn(logf(__fadd_rn(__fdiv_rn(mw, aw), kEncodeEps)), p.w2);
  t.w = __fmul_rn(logf(__fadd_rn(__fdiv_rn(mh, ah), kEncodeEps)), p.w3);

  const size_t o = (size_t)b * p.a + i;
  matches[o] = m;
  fg_labels[o] = fg ? labels[(size_t)b * p.n + sel] : 0;
  reg[o] = t;
}

}  // namespace

// anchors [A, 4] f32, gt [B, N, 4] f32 (both 16-byte aligned), labels [B, N]
// int32, valid [B, N] bytes 0/1; outputs matches [B, A] int32, fg_labels
// [B, A] int32, reg [B, A, 4] f32. N >= 1. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int match_targets(const void* anchors, const void* gt, const void* labels,
                             const void* valid, void* matches, void* fg_labels, void* reg,
                             int batch, int a, int n, float fg_thr, float bg_thr,
                             float w0, float w1, float w2, float w3, void* stream) {
  const Params p{a, n, fg_thr, bg_thr, w0, w1, w2, w3};
  const size_t smem = (size_t)n * (sizeof(float4) + sizeof(float) + sizeof(int32_t));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((a + kThreads - 1) / kThreads, batch);
  match_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(anchors), static_cast<const float4*>(gt),
      static_cast<const int32_t*>(labels), static_cast<const uint8_t*>(valid),
      static_cast<int32_t*>(matches), static_cast<int32_t*>(fg_labels),
      static_cast<float4*>(reg), p);
  return (int)cudaGetLastError();
}
