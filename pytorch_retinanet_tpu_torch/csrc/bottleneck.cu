// Fused identity bottleneck on the tensor cores.
//
// Replaces pytorch_retinanet_tpu/kernels/bottleneck_pallas.py::fused_bottleneck
// (_bottleneck_kernel): one stride-1 identity ResNet bottleneck,
//   y1 = relu(x @ w1 * s1 + b1)            1x1, C -> mid
//   y2 = relu(conv3x3(y1, pad 1) * s2 + b2) 3x3, mid -> mid
//   out = relu(y2 @ w3 * s3 + b3 + x)      1x1, mid -> C
// on NHWC bf16, with f32 accumulation and epilogues and y1, y2 rounded to
// bf16, reading x once (plus the halo) and writing the output once. The TPU
// kernel's row tiles, double-buffered halo DMA and im2col-as-values exist for
// Mosaic and VMEM and are not carried over.
//
// What bounds it on an H100: operations. A block at batch 32 does 34 * mid^2
// multiply-adds per pixel: 299.5 GFLOP at every R50 stage (0.30 ms at the
// 989 TFLOP/s dense bf16 peak), against 1.10 GB of x and output at layer2
// (0.33 ms at 3.35 TB/s), 0.55 GB at layer3 and 0.28 GB at layer4.
//
// Design: one CTA of 8 warps per (image, 8x8 output tile).
//   conv1 runs over the tile's 10x10 halo (100 positions padded to 112 rows,
//   seven m16 tiles), in 128-channel N chunks, with x and w1 staged through
//   shared memory 32 input channels at a time by cp.async (two buffers). y1
//   lands in shared memory as bf16, and every halo position outside the
//   image is stored as 0: the 3x3 reads zero padding there. (The TPU kernel
//   zero-pads the block's INPUT rows and runs conv1 over them, so above the
//   first and below the last image row its 3x3 reads relu(b1), not zero:
//   its output rows 0 and H-1 differ from the composition it fuses.)
//   conv2 is nine accumulated tap GEMMs over y1: each lane hands ldmatrix the
//   y1 row of its own output pixel shifted by the tap, so no im2col buffer is
//   formed. y2 lands in shared memory as bf16.
//   conv3 runs in 128-channel N chunks of C; its epilogue reads the residual
//   from the tile's own pixels of x (L2-resident after conv1 read them) and
//   writes the output.
// All products are mma.sync m16n8k16 bf16 -> f32 with ldmatrix fragment loads
// from padded rows (16 bytes of padding per row keeps ldmatrix free of bank
// conflicts). Epilogues round like the plain version: y * s, + b and + x each
// rounded in f32, one bf16 rounding. wgmma, TMA and warp specialisation are
// later work.
//
// Shared memory: y1 112 x (mid + 8) and y2 64 x (mid + 8) bf16, plus two
// staging buffers of 17.25 KB: 83 KB at mid 128, 218 KB at mid 512.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kTile = 8;       // output tile kTile x kTile
constexpr int kHaloW = kTile + 2;
constexpr int kHalo = kHaloW * kHaloW;  // 100
constexpr int kHaloRows = 112;          // 7 m16 tiles
constexpr int kPix = kTile * kTile;     // 64
constexpr int kNC = 128;                // N chunk
constexpr int kKC = 32;                 // K depth of one staging buffer
constexpr int kPad = 8;                 // bf16 padding per shared-memory row
constexpr int kLdA = kKC + kPad;
constexpr int kLdB = kNC + kPad;
constexpr int kStageA = kHaloRows * kLdA;  // elements
constexpr int kStageB = kKC * kLdB;
constexpr int kStage = kStageA + kStageB;

struct Params {
  const bf16* x;
  const bf16* w1;  // [C, mid]
  const bf16* w2;  // [9, mid, mid]
  const bf16* w3;  // [mid, C]
  const float* s1;
  const float* b1;
  const float* s2;
  const float* b2;
  const float* s3;
  const float* b3;
  bf16* out;
  int h, w, c, mid, tiles_w;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; zero-fills when `pred` is false.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float bn(float acc, float s, float b) {
  return __fadd_rn(__fmul_rn(acc, s), b);
}

__device__ __forceinline__ __nv_bfloat162 pack(float lo, float hi) {
  __nv_bfloat162 v;
  v.x = __float2bfloat16_rn(lo);
  v.y = __float2bfloat16_rn(hi);
  return v;
}

// Stage rows [k0, k0 + kKC) x cols [n0, n0 + kNC) of a row-major weight with
// `ld` columns into a staging buffer's B part.
__device__ __forceinline__ void stage_weights(bf16* sb, const bf16* wt, int ld, int k0, int n0) {
  for (int i = threadIdx.x; i < kKC * (kNC / 8); i += kThreads) {
    const int r = i / (kNC / 8), q = i % (kNC / 8);
    cp_async16(sb + r * kLdB + q * 8, wt + (size_t)(k0 + r) * ld + n0 + q * 8, true);
  }
}

__global__ void __launch_bounds__(kThreads, 2) bottleneck_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ld = p.mid + kPad;
  bf16* y1s = reinterpret_cast<bf16*>(smem_raw);  // [kHaloRows][ld]
  bf16* y2s = y1s + kHaloRows * ld;                // [kPix][ld]
  bf16* stage = y2s + kPix * ld;                   // 2 x [A | B]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h0 = (blockIdx.x / p.tiles_w) * kTile, w0 = (blockIdx.x % p.tiles_w) * kTile;
  const size_t img = (size_t)blockIdx.y * p.h * p.w * p.c;
  const bf16* xb = p.x + img;
  bf16* ob = p.out + img;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row group and column pair
  const int lrow = lane & 15, lcol = (lane >> 4) * 8;  // ldmatrix row / column of this lane

  // ---- conv1 over the halo: y1s = relu(x_halo @ w1 * s1 + b1), zero outside ----
  {
    const int nk = p.c / kKC;
    auto stage_x = [&](int buf, int k0) {
      bf16* sa = stage + buf * kStage;
      for (int i = threadIdx.x; i < kHaloRows * (kKC / 8); i += kThreads) {
        const int r = i / (kKC / 8), q = i % (kKC / 8);
        const int hh = h0 - 1 + r / kHaloW, ww = w0 - 1 + r % kHaloW;
        const bool ok = r < kHalo && hh >= 0 && hh < p.h && ww >= 0 && ww < p.w;
        const bf16* src = ok ? xb + ((size_t)hh * p.w + ww) * p.c + k0 + q * 8 : p.x;
        cp_async16(sa + r * kLdA + q * 8, src, ok);
      }
    };
    for (int n0 = 0; n0 < p.mid; n0 += kNC) {
      float acc[7][2][4];
#pragma unroll
      for (int m = 0; m < 7; ++m)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.0f;
      stage_x(0, 0);
      stage_weights(stage + kStageA, p.w1, p.mid, 0, n0);
      cp_async_commit();
      for (int ks = 0; ks < nk; ++ks) {
        if (ks + 1 < nk) {
          const int nb = (ks + 1) & 1;
          stage_x(nb, (ks + 1) * kKC);
          stage_weights(stage + nb * kStage + kStageA, p.w1, p.mid, (ks + 1) * kKC, n0);
        }
        cp_async_commit();
        cp_async_wait_one();
        __syncthreads();
        const bf16* sa = stage + (ks & 1) * kStage;
        const bf16* sb = sa + kStageA;
#pragma unroll
        for (int kk = 0; kk < kKC; kk += 16) {
          unsigned b[4];
          ldsm_x4_trans(b, sb + (kk + lrow) * kLdB + warp * 16 + lcol);
#pragma unroll
          for (int m = 0; m < 7; ++m) {
            unsigned a[4];
            ldsm_x4(a, sa + (m * 16 + lrow) * kLdA + kk + lcol);
            mma_bf16(acc[m][0], a, b);
            mma_bf16(acc[m][1], a, b + 2);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int m = 0; m < 7; ++m) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = m * 16 + g + half * 8;
          const int hh = h0 - 1 + r / kHaloW, ww = w0 - 1 + r % kHaloW;
          const bool inside = r < kHalo && hh >= 0 && hh < p.h && ww >= 0 && ww < p.w;
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const int col = n0 + warp * 16 + n * 8 + t4 * 2;
            float v0 = 0.0f, v1 = 0.0f;
            if (inside) {
              v0 = fmaxf(bn(acc[m][n][half * 2], p.s1[col], p.b1[col]), 0.0f);
              v1 = fmaxf(bn(acc[m][n][half * 2 + 1], p.s1[col + 1], p.b1[col + 1]), 0.0f);
            }
            *reinterpret_cast<__nv_bfloat162*>(y1s + r * ld + col) = pack(v0, v1);
          }
        }
      }
    }
  }

  // Warp tile of conv2 and conv3: 32 output pixels x 32 channels of the chunk.
  const int wm = warp >> 2, wn = warp & 3;

  // ---- conv2: y2s = relu(sum_taps y1s[pixel + tap] @ w2[tap] * s2 + b2) ----
  {
    int hrow[2];  // halo row of this lane's ldmatrix pixel at tap (0, 0)
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int px = wm * 32 + m * 16 + lrow;
      hrow[m] = (px / kTile) * kHaloW + px % kTile;
    }
    const int kper = p.mid / kKC, nk = 9 * kper;
    for (int n0 = 0; n0 < p.mid; n0 += kNC) {
      float acc[2][4][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.0f;
      stage_weights(stage + kStageA, p.w2, p.mid, 0, n0);
      cp_async_commit();
      for (int s = 0; s < nk; ++s) {
        if (s + 1 < nk) {
          const int tap = (s + 1) / kper, k0 = ((s + 1) % kper) * kKC;
          stage_weights(stage + ((s + 1) & 1) * kStage + kStageA,
                        p.w2 + (size_t)tap * p.mid * p.mid, p.mid, k0, n0);
        }
        cp_async_commit();
        cp_async_wait_one();
        __syncthreads();
        const int tap = s / kper, k0 = (s % kper) * kKC;
        const int shift = (tap / 3) * kHaloW + tap % 3;
        const bf16* sb = stage + (s & 1) * kStage + kStageA;
#pragma unroll
        for (int kk = 0; kk < kKC; kk += 16) {
          unsigned b[2][4];
          ldsm_x4_trans(b[0], sb + (kk + lrow) * kLdB + wn * 32 + lcol);
          ldsm_x4_trans(b[1], sb + (kk + lrow) * kLdB + wn * 32 + 16 + lcol);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            unsigned a[4];
            ldsm_x4(a, y1s + (hrow[m] + shift) * ld + k0 + kk + lcol);
#pragma unroll
            for (int n = 0; n < 4; ++n) mma_bf16(acc[m][n], a, b[n >> 1] + (n & 1) * 2);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int px = wm * 32 + m * 16 + g + half * 8;
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int col = n0 + wn * 32 + n * 8 + t4 * 2;
            const float v0 = fmaxf(bn(acc[m][n][half * 2], p.s2[col], p.b2[col]), 0.0f);
            const float v1 = fmaxf(bn(acc[m][n][half * 2 + 1], p.s2[col + 1], p.b2[col + 1]), 0.0f);
            *reinterpret_cast<__nv_bfloat162*>(y2s + px * ld + col) = pack(v0, v1);
          }
        }
      }
    }
  }

  // ---- conv3 + residual: out = relu(y2s @ w3 * s3 + b3 + x) ----
  {
    const int nk = p.mid / kKC;
    for (int n0 = 0; n0 < p.c; n0 += kNC) {
      float acc[2][4][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.0f;
      stage_weights(stage + kStageA, p.w3, p.c, 0, n0);
      cp_async_commit();
      for (int s = 0; s < nk; ++s) {
        if (s + 1 < nk) {
          stage_weights(stage + ((s + 1) & 1) * kStage + kStageA, p.w3, p.c, (s + 1) * kKC, n0);
        }
        cp_async_commit();
        cp_async_wait_one();
        __syncthreads();
        const bf16* sb = stage + (s & 1) * kStage + kStageA;
#pragma unroll
        for (int kk = 0; kk < kKC; kk += 16) {
          unsigned b[2][4];
          ldsm_x4_trans(b[0], sb + (kk + lrow) * kLdB + wn * 32 + lcol);
          ldsm_x4_trans(b[1], sb + (kk + lrow) * kLdB + wn * 32 + 16 + lcol);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            unsigned a[4];
            ldsm_x4(a, y2s + (wm * 32 + m * 16 + lrow) * ld + s * kKC + kk + lcol);
#pragma unroll
            for (int n = 0; n < 4; ++n) mma_bf16(acc[m][n], a, b[n >> 1] + (n & 1) * 2);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int px = wm * 32 + m * 16 + g + half * 8;
          const int hh = h0 + px / kTile, ww = w0 + px % kTile;
          if (hh >= p.h || ww >= p.w) continue;
          const size_t base = ((size_t)hh * p.w + ww) * p.c;
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int col = n0 + wn * 32 + n * 8 + t4 * 2;
            const __nv_bfloat162 xr = *reinterpret_cast<const __nv_bfloat162*>(xb + base + col);
            const float v0 = fmaxf(__fadd_rn(bn(acc[m][n][half * 2], p.s3[col], p.b3[col]),
                                             __bfloat162float(xr.x)), 0.0f);
            const float v1 = fmaxf(__fadd_rn(bn(acc[m][n][half * 2 + 1], p.s3[col + 1], p.b3[col + 1]),
                                             __bfloat162float(xr.y)), 0.0f);
            *reinterpret_cast<__nv_bfloat162*>(ob + base + col) = pack(v0, v1);
          }
        }
      }
    }
  }
}

}  // namespace

// x, out [B, H, W, C] bf16 NHWC; w1 [C, mid], w2 [9, mid, mid], w3 [mid, C]
// bf16; s1, b1, s2, b2 [mid] and s3, b3 [C] f32. Every pointer 16-byte
// aligned; mid % 128 == 0, mid <= 512, C == 4 * mid. Returns the cudaError_t
// of the launch (0 on success).
extern "C" int bottleneck_forward(const void* x, const void* w1, const void* w2, const void* w3,
                                  const void* s1, const void* b1, const void* s2, const void* b2,
                                  const void* s3, const void* b3, void* out, int batch, int h,
                                  int w, int c, int mid, void* stream) {
  if (mid % kNC != 0 || c % kNC != 0 || mid > 512) return (int)cudaErrorInvalidValue;
  const int tiles_h = (h + kTile - 1) / kTile, tiles_w = (w + kTile - 1) / kTile;
  const Params p{static_cast<const bf16*>(x),   static_cast<const bf16*>(w1),
                 static_cast<const bf16*>(w2),  static_cast<const bf16*>(w3),
                 static_cast<const float*>(s1), static_cast<const float*>(b1),
                 static_cast<const float*>(s2), static_cast<const float*>(b2),
                 static_cast<const float*>(s3), static_cast<const float*>(b3),
                 static_cast<bf16*>(out),       h,
                 w,                             c,
                 mid,                           tiles_w};
  const size_t smem = ((size_t)(kHaloRows + kPix) * (mid + kPad) + 2 * kStage) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(bottleneck_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tiles_h * tiles_w, batch);
  bottleneck_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
