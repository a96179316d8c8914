// Anchor matching and loss targets for one pyramid level.
//
// Replaces pytorch_retinanet_tpu/kernels/match_pallas.py::match_targets
// (_match_kernel), which forms the [N_pad, T] IoU plane of an anchor tile in
// VMEM, reduces it, gathers the matched GT row by a one-hot sum and encodes
// it, one (image, 1024-anchor tile) grid cell at a time. The planar [4, T]
// layout and the lane tiles exist for Mosaic and are not carried over.
//
// What bounds it on an H100: operations. At the training shapes (batch 16,
// the 800x1344 bucket's 201,600 anchors, N = 100 padded GT rows) a step
// needs 322.6 M IoU pairs, about 12 f32 operations each and an IEEE
// division, against about 81 MB of anchors, GT and outputs: ~0.06 ms at the
// 67 TFLOP/s f32 peak against ~0.024 ms of HBM traffic.
//
// Design: a grid over (256-anchor block, image). The block stages the
// image's GT rows (box, area, label, valid) in shared memory; every thread
// owns one anchor, scans the rows in index order keeping the best IoU with a
// strict `>` (ties keep the first index, as jnp.argmax does), applies the
// thresholds and the all-ignore rule, gathers the matched row (row 0 when the
// anchor is not foreground, the XLA path's safe index) and writes the three
// outputs in [B, A] / [B, A, 4] layout. No [B, A, N] intermediate is formed.
//
// Exactness: the IoU follows ops/boxes.py::box_iou with GT as the first
// operand (area_g + area_a - inter, union clamped at 1e-12) and the encode
// follows ops/boxes.py::encode_boxes, with explicit round-to-nearest
// intrinsics and IEEE division (the file is also built with -fmad=false), so
// matches, labels and the centre targets equal the plain composition bit for
// bit. logf is not correctly rounded: tw and th may differ by an ulp or two.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
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
  float4* g_box = smem;                                            // [n]
  float* g_area = reinterpret_cast<float*>(g_box + p.n);           // [n]
  int32_t* g_label = reinterpret_cast<int32_t*>(g_area + p.n);     // [n]
  uint8_t* g_valid = reinterpret_cast<uint8_t*>(g_label + p.n);    // [n]

  const int b = blockIdx.y;
  const float4* gb = gt + (size_t)b * p.n;
  int any_valid = 0;
  for (int j = threadIdx.x; j < p.n; j += kThreads) {
    const float4 box = gb[j];
    g_box[j] = box;
    g_area[j] = box_area(box);
    g_label[j] = labels[(size_t)b * p.n + j];
    g_valid[j] = valid[(size_t)b * p.n + j];
    any_valid |= g_valid[j];
  }
  const bool any_gt = __syncthreads_or(any_valid);

  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.a) return;
  const float4 an = anchors[i];
  const float area_a = box_area(an);

  float best = -2.0f;  // below any IoU and below the -1 of an invalid row
  int best_idx = 0;
  for (int j = 0; j < p.n; ++j) {
    float v = -1.0f;
    if (g_valid[j]) {
      const float4 g = g_box[j];
      const float iw = fmaxf(__fsub_rn(fminf(g.z, an.z), fmaxf(g.x, an.x)), 0.0f);
      const float ih = fmaxf(__fsub_rn(fminf(g.w, an.w), fmaxf(g.y, an.y)), 0.0f);
      const float inter = __fmul_rn(iw, ih);
      const float uni = __fsub_rn(__fadd_rn(g_area[j], area_a), inter);
      v = __fdiv_rn(inter, fmaxf(uni, kIouEps));
    }
    if (v > best) {
      best = v;
      best_idx = j;
    }
  }

  int m = -2;
  if (best < p.bg_thr) m = -1;
  if (best > p.fg_thr) m = best_idx;
  if (!any_gt) m = -2;
  const bool fg = m >= 0;
  const int sel = fg ? best_idx : 0;
  const float4 g = g_box[sel];

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
  fg_labels[o] = fg ? g_label[sel] : 0;
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
  const size_t smem = (size_t)n * (sizeof(float4) + sizeof(float) + sizeof(int32_t) + 1);
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
