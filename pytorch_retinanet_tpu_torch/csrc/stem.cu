// Fused ResNet stem: 7x7 stride-2 conv (pad 3, 3 -> 64) -> folded frozen BN
// -> ReLU -> 3x3 stride-2 max pool (pad 1), in one pass over the image.
//
// Replaces pytorch_retinanet_tpu/kernels/stem_pallas.py::fused_stem
// (_stem_kernel), the TPU kernel that keeps the stride-2 conv map in VMEM
// and hands the pooled map to the trunk.
//
// What bounds it on an H100: at the main-path shape (32 x 800 x 1344 x 3 f32
// in, 32 x 200 x 336 x 64 bf16 out) the kernel must move 0.69 GB (0.21 ms at
// 3.35 TB/s) and do 162 GFLOP. On the tensor cores that is 0.16 ms; this
// first version does its multiply-adds in f32 on the CUDA cores (67 TFLOP/s
// peak, so about 2.4 ms at best), which makes it bound by operations.
// Tensor cores (mma/wgmma on an implicit GEMM) are the next step.
//
// Design: persistent CTAs of 256 threads, two per SM. Each CTA loads the
// 7x7x3x64 weights (bf16-rounded, f32 in shared memory) once, then walks
// over tiles of 8 x 7 pooled outputs of one image. A tile needs 17 x 15 conv
// outputs (the pool window reaches one conv row and column before the tile)
// and a 39 x 35 x 3 input halo. Per tile:
//   1. the halo is read from HBM, rounded to bf16, and stored per channel
//      with even and odd columns apart, so that neighbouring threads read
//      neighbouring words for every tap;
//   2. each thread accumulates 4 conv pixels x 16 channels in f32 registers
//      over the 147 taps (16 weights are one warp-uniform broadcast read,
//      reused for the 4 pixels), applies y * scale + bias and ReLU, rounds
//      to bf16 and stages the value in shared memory. Conv positions outside
//      the image (the pool's padding) are stored as 0, which is exact because
//      the pool reads ReLU outputs;
//   3. the 3x3 stride-2 max runs over the staged tile in bf16 and writes
//      NHWC rows with 16-byte stores.
// The stride-2 conv map never reaches HBM. Rounding points are those of the
// plain version: bf16 input and weights, f32 accumulation and BN, bf16 ReLU
// output, exact max.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCin = 3, kCout = 64, kKs = 7;
constexpr int kTaps = kKs * kKs * kCin;        // 147
constexpr int kTileH = 8, kTileW = 7;          // pooled outputs per tile
constexpr int kConvH = 2 * kTileH + 1;         // 17 conv rows per tile
constexpr int kConvW = 2 * kTileW + 1;         // 15 conv columns per tile
constexpr int kConvPix = kConvH * kConvW;      // 255
constexpr int kInH = 2 * kConvH + 5;           // 39 input rows
constexpr int kInW = 2 * kConvW + 5;           // 35 input columns
constexpr int kInHalf = (kInW + 1) / 2;        // 18 columns per parity
constexpr int kInRow = 2 * kInHalf;            // words per staged input row
constexpr int kThreads = 256;
constexpr int kPixPerThread = 4;
constexpr int kChPerThread = 16;
constexpr int kPixGroups = kThreads / (kCout / kChPerThread);   // 64

static_assert(kPixGroups * kPixPerThread >= kConvPix, "tile does not fit the threads");

constexpr size_t kWeightFloats = (size_t)kTaps * kCout;
constexpr size_t kInFloats = (size_t)kCin * kInH * kInRow;
constexpr size_t kSmemBytes = (kWeightFloats + 2 * kCout + kInFloats) * sizeof(float) +
                              (size_t)kConvPix * kCout * sizeof(__nv_bfloat16);

__global__ void __launch_bounds__(kThreads, 2) stem_kernel(
    const float* __restrict__ x,       // [B, H, W, 3] normalized f32
    const float* __restrict__ w,       // [7, 7, 3, 64] f32 (bf16-rounded values)
    const float* __restrict__ scale,   // [64]
    const float* __restrict__ bias,    // [64]
    __nv_bfloat16* __restrict__ out,   // [B, H/4, W/4, 64]
    int batch, int h, int wd) {
  extern __shared__ __align__(16) float smem_f[];
  float* w_s = smem_f;                                  // [147][64]
  float* scale_s = w_s + kWeightFloats;                 // [64]
  float* bias_s = scale_s + kCout;                      // [64]
  float* in_s = bias_s + kCout;                         // [3][39][2][18]
  __nv_bfloat16* conv_s = reinterpret_cast<__nv_bfloat16*>(in_s + kInFloats);  // [255][64]

  const int tid = threadIdx.x;
  const int hc = h / 2, wc = wd / 2;       // conv map
  const int hp = h / 4, wp = wd / 4;       // pooled map
  const int tiles_h = (hp + kTileH - 1) / kTileH;
  const int tiles_w = (wp + kTileW - 1) / kTileW;
  const long long n_tiles = (long long)batch * tiles_h * tiles_w;

  for (int i = tid; i < (int)kWeightFloats; i += kThreads) w_s[i] = w[i];
  if (tid < kCout) {
    scale_s[tid] = scale[tid];
    bias_s[tid] = bias[tid];
  }

  // This thread's share of the conv work: 16 channels, 4 pixels.
  const int cg = tid / kPixGroups;          // warp-uniform channel group
  const int pg = tid % kPixGroups;
  int pix_off[kPixPerThread];
  int pix_id[kPixPerThread];
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    int p = pg + k * kPixGroups;
    pix_id[k] = p;
    if (p >= kConvPix) p = kConvPix - 1;    // duplicate work, never stored
    const int lr = p / kConvW, lc = p % kConvW;
    pix_off[k] = (2 * lr) * kInRow + lc;
  }

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = (int)(tile / ((long long)tiles_h * tiles_w));
    const int rem = (int)(tile % ((long long)tiles_h * tiles_w));
    const int ph0 = (rem / tiles_w) * kTileH;
    const int pw0 = (rem % tiles_w) * kTileW;
    const int gy0 = 4 * ph0 - 5, gx0 = 4 * pw0 - 5;   // input origin of the halo
    const int cy0 = 2 * ph0 - 1, cx0 = 2 * pw0 - 1;   // conv origin of the tile

    // 1. Input halo -> shared memory, bf16-rounded, zero outside the image.
    const float* xb = x + (size_t)b * h * wd * kCin;
    for (int idx = tid; idx < kInH * kInW * kCin; idx += kThreads) {
      const int li = idx / (kInW * kCin);
      const int r = idx - li * (kInW * kCin);
      const int lj = r / kCin;
      const int ci = r - lj * kCin;
      const int gy = gy0 + li, gx = gx0 + lj;
      float v = 0.0f;
      if (gy >= 0 && gy < h && gx >= 0 && gx < wd) {
        v = __bfloat162float(__float2bfloat16_rn(xb[((size_t)gy * wd + gx) * kCin + ci]));
      }
      in_s[(ci * kInH + li) * kInRow + (lj & 1) * kInHalf + (lj >> 1)] = v;
    }
    __syncthreads();

    // 2. Conv + BN + ReLU for 4 pixels x 16 channels.
    float acc[kPixPerThread][kChPerThread];
#pragma unroll
    for (int k = 0; k < kPixPerThread; ++k)
#pragma unroll
      for (int c = 0; c < kChPerThread; ++c) acc[k][c] = 0.0f;

    for (int ky = 0; ky < kKs; ++ky) {
#pragma unroll
      for (int kx = 0; kx < kKs; ++kx) {
#pragma unroll
        for (int ci = 0; ci < kCin; ++ci) {
          const float4* wv = reinterpret_cast<const float4*>(
              w_s + ((ky * kKs + kx) * kCin + ci) * kCout + cg * kChPerThread);
          const float4 w0 = wv[0], w1 = wv[1], w2 = wv[2], w3 = wv[3];
          const float wr[kChPerThread] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w,
                                          w2.x, w2.y, w2.z, w2.w, w3.x, w3.y, w3.z, w3.w};
          const int base = (ci * kInH + ky) * kInRow + (kx & 1) * kInHalf + (kx >> 1);
#pragma unroll
          for (int k = 0; k < kPixPerThread; ++k) {
            const float v = in_s[base + pix_off[k]];
#pragma unroll
            for (int c = 0; c < kChPerThread; ++c) acc[k][c] = fmaf(v, wr[c], acc[k][c]);
          }
        }
      }
    }

#pragma unroll
    for (int k = 0; k < kPixPerThread; ++k) {
      const int p = pix_id[k];
      if (p >= kConvPix) continue;
      const int cy = cy0 + p / kConvW, cx = cx0 + p % kConvW;
      const bool inside = cy >= 0 && cy < hc && cx >= 0 && cx < wc;
      __align__(16) __nv_bfloat16 y[kChPerThread];
#pragma unroll
      for (int c = 0; c < kChPerThread; ++c) {
        const int ch = cg * kChPerThread + c;
        const float v = __fadd_rn(__fmul_rn(acc[k][c], scale_s[ch]), bias_s[ch]);
        y[c] = __float2bfloat16_rn(inside ? fmaxf(v, 0.0f) : 0.0f);
      }
      uint4* dst = reinterpret_cast<uint4*>(conv_s + (size_t)p * kCout + cg * kChPerThread);
      dst[0] = reinterpret_cast<const uint4*>(y)[0];
      dst[1] = reinterpret_cast<const uint4*>(y)[1];
    }
    __syncthreads();

    // 3. 3x3 stride-2 max over the staged tile, 8 channels per item.
    constexpr int kChunks = kCout / 8;
    for (int item = tid; item < kTileH * kTileW * kChunks; item += kThreads) {
      const int chunk = item % kChunks;
      const int pix = item / kChunks;
      const int pr = pix / kTileW, pc = pix % kTileW;
      const int ph = ph0 + pr, pw = pw0 + pc;
      if (ph >= hp || pw >= wp) continue;
      __nv_bfloat162 m[4];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int p = (2 * pr + dy) * kConvW + (2 * pc + dx);
          const uint4 raw = *reinterpret_cast<const uint4*>(conv_s + (size_t)p * kCout + chunk * 8);
          const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
          for (int q = 0; q < 4; ++q) m[q] = (dy == 0 && dx == 0) ? v[q] : __hmax2(m[q], v[q]);
        }
      }
      __nv_bfloat16* o = out + (((size_t)b * hp + ph) * wp + pw) * kCout + chunk * 8;
      *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(m);
    }
    // The next tile's halo load reuses in_s only; conv_s is rewritten after
    // the next __syncthreads, when every thread has finished this pool.
  }
}

}  // namespace

// x [B, H, W, 3] f32 NHWC (H % 4 == 0, W % 4 == 0), w [7, 7, 3, 64] f32,
// scale/bias [64] f32, out [B, H/4, W/4, 64] bf16 NHWC.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int stem_forward(const void* x, const void* w, const void* scale, const void* bias,
                            void* out, int batch, int h, int wd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stem_kernel, kThreads,
                                                           kSmemBytes)) != cudaSuccess)
    return (int)err;
  const long long tiles = (long long)batch * ((h / 4 + kTileH - 1) / kTileH) *
                          ((wd / 4 + kTileW - 1) / kTileW);
  const long long grid = per_sm > 0 ? (long long)per_sm * sms : (long long)sms;
  stem_kernel<<<(unsigned)(tiles < grid ? tiles : grid), kThreads, kSmemBytes, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), batch, h, wd);
  return (int)cudaGetLastError();
}
