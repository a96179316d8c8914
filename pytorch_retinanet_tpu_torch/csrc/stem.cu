// Fused ResNet stem: normalize -> 7x7 stride-2 conv (pad 3, 3 -> 64) ->
// folded frozen BN -> ReLU -> 3x3 stride-2 max pool (pad 1), in one pass
// over a uint8 or f32 NHWC image.
//
// Replaces pytorch_retinanet_tpu/kernels/stem_pallas.py::fused_stem
// (_stem_kernel, with the normalize of fused_stem folded in), the TPU kernel
// that keeps the stride-2 conv map in VMEM and hands the pooled map to the
// trunk.
//
// What bounds it on an H100: at the main-path shape (32 x 800 x 1344 x 3
// uint8 in, 32 x 200 x 336 x 64 bf16 out) the kernel must move 0.38 GB
// (0.11 ms at 3.35 TB/s; 0.69 GB and 0.21 ms from f32) and do 162 GFLOP
// (0.16 ms on the bf16 tensor cores). So it is bound by operations from
// uint8 and by bytes from f32. The multiply-adds run on the tensor cores
// (wgmma m64n64k16, bf16 in, f32 accumulate, A from registers); the halo
// overlap, the padding of K and M and the extra conv row and column of each
// tile add about 1.37x to the useful work.
//
// Design: persistent CTAs of two warpgroups, two CTAs per SM. Each CTA keeps
// the packed weights (the B operand, 64 x 192 bf16, K-major with the 128-byte
// swizzle that wgmma reads) in shared memory and walks over tiles of 7 x 16
// pooled outputs of one image. A tile needs 15 x 33 conv outputs (the pool
// reaches one conv row and column before the tile) and an input halo of 35
// rows x 72 pixels. Per tile:
//   1. the halo is read with 4-byte (uint8) or 16-byte (f32) loads, all of a
//      thread's loads issued before any is used (from uint8 while the tile
//      before is computed), normalized ((v - mean[c]) / std[c], IEEE
//      division; from uint8 through a 768-entry table made once per CTA),
//      rounded to bf16 and stored as rows of interleaved channels, exactly as
//      NHWC lays them out. Pixels outside the image are 0, the conv's zero
//      padding in normalized space;
//   2. an implicit GEMM: conv pixel (r, c) of the tile reads, for kernel row
//      ky, the 21 contiguous elements 6c .. 6c + 20 of staged row 2r + ky.
//      K is laid out as 7 rows x 24 (3 zero-weight slots per row), padded to
//      176 = 11 k16 steps, so each A register (two consecutive k) is one
//      aligned 32-bit shared-memory load; rows of 114 words put the two conv
//      rows an m16 slice may span on disjoint banks. M = 495 conv pixels (512
//      with padding) in 8 blocks of 64, 4 per warpgroup, each one group of 11
//      wgmma with N = 64. The epilogue applies y * scale + bias and ReLU in
//      f32, rounds to bf16, and stores the conv tile in shared memory
//      (16-byte chunks XOR-swizzled by the pixel) with 0 outside the conv
//      map, which is exact because the pool reads ReLU outputs;
//   3. the 3x3 stride-2 max runs over the staged tile in bf16 and writes NHWC
//      rows with 16-byte stores.
// The stride-2 conv map never reaches HBM. Rounding points are those of the
// plain version: bf16 normalized input and weights, f32 accumulation and BN,
// bf16 ReLU output, exact max.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kCout = 64;
constexpr int kTileH = 7, kTileW = 16;            // pooled outputs per tile
constexpr int kConvH = 2 * kTileH + 1;            // 15 conv rows per tile
constexpr int kConvW = 2 * kTileW + 1;            // 33 conv columns per tile
constexpr int kConvPix = kConvH * kConvW;         // 495
constexpr int kInRows = 2 * kConvH + 5;           // 35 staged input rows
constexpr int kQuads = 55;                        // 4-element groups staged per row
constexpr int kRowWords = 114;                    // 32-bit words per staged row
constexpr int kKSteps = 11;                       // K = 7 x 24 = 168, padded to 176
constexpr int kThreads = 256;                     // two warpgroups
constexpr int kBlocks = 8;                        // m64 blocks per tile
constexpr int kHaloItems = kInRows * kQuads;
constexpr int kHaloIters = (kHaloItems + kThreads - 1) / kThreads;

static_assert(4 * kQuads >= 6 * (kConvW - 1) + 24, "staged row too short for the taps");
static_assert(2 * kRowWords >= 2 * kQuads, "staged row stride too short");
static_assert((2 * kRowWords) % 32 == 4, "conv rows must fall on shifted banks");
static_assert(64 * kBlocks >= kConvPix, "M does not fit the blocks");

constexpr int kBBytes = 3 * 64 * 128;             // B: 3 K chunks of 64 rows x 128 bytes
constexpr int kConvBytes = kConvPix * kCout * 2;  // bf16 conv tile, 128 B per pixel
constexpr int kHaloBytes = kInRows * kRowWords * 4;
constexpr int kLutEntries = 3 * 256;
// 1024 bytes of slack align the swizzled B operand.
constexpr size_t kSmemBytes = 1024 + (size_t)kBBytes + kConvBytes + kHaloBytes +
                              2 * kCout * sizeof(float) + kLutEntries * 2;

// Matrix descriptor of a K-major operand with the 128-byte swizzle: rows of 64
// bf16 (128 bytes), 8-row groups 1024 bytes apart, 1024-aligned; a k16 step
// within the 64 advances the start by 32 bytes.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// wgmma.mma_async m64n64k16, bf16 in, f32 accumulate (d += a * b), A from
// registers (the m16n8k16 A fragment of the warp's 16 rows), B through a
// descriptor.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keep the compiler from moving accumulator reads or writes across wgmma.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Word offset, within a staged row pair, of k16 step `s`, half `h` (k0 =
// 16 s + 8 h): kernel row ky = k0 / 24 at element k0 - 24 ky. The last half
// step (k >= 168) has zero weights; it rereads kernel row 6 so that A stays
// finite.
__host__ __device__ constexpr int a_offset(int s, int h) {
  const int k0 = 16 * s + 8 * h, ky = k0 / 24;
  return ky >= 7 ? 6 * kRowWords : ky * kRowWords + (k0 - 24 * ky) / 2;
}

// bf16 bits of (v - mean) / std, rounded to nearest even; IEEE division.
__device__ __forceinline__ uint32_t normalize(float v, float mean, float std) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(__fdiv_rn(__fsub_rn(v, mean), std)));
}

// Per-channel normalize constants, passed by value.
struct Norm {
  float mean[3], std[3];
};

// Where tile `tile` starts: image, first pooled row and column.
struct TileOrigin {
  int b, ph0, pw0;
};

__device__ __forceinline__ TileOrigin tile_origin(long long tile, int tiles_h, int tiles_w) {
  const long long per_image = (long long)tiles_h * tiles_w;
  const int rem = (int)(tile % per_image);
  return {(int)(tile / per_image), (rem / tiles_w) * kTileH, (rem % tiles_w) * kTileW};
}

// The raw halo words of one tile, as this thread loads them: for staged
// group qd of row li (item tid + it * kThreads), bytes 1-3 of word w0 + qd and
// byte 0 of the next word (uint8), or the float4 w0 + qd and the next float
// (f32). Staged element 0 is image element 3 (4 pw0 - 5) of its row, one past
// a 4-aligned word. Bit 2 it (2 it + 1) of `ok` says whether the first (the
// next) word lies inside the image.
template <bool kU8>
struct HaloRaw {
  typename std::conditional<kU8, uint32_t, float4>::type lo[kHaloIters];
  typename std::conditional<kU8, uint32_t, float>::type hi[kHaloIters];
  uint32_t ok;
};

template <bool kU8>
__device__ __forceinline__ void load_halo(HaloRaw<kU8>& raw, const void* __restrict__ x_,
                                          TileOrigin t, int h, int row_words, int tid) {
  const int gy0 = 4 * t.ph0 - 5;
  const int w0 = (3 * (4 * t.pw0 - 5) - 1) / 4;
  raw.ok = 0;
#pragma unroll
  for (int it = 0; it < kHaloIters; ++it) {
    const int idx = tid + it * kThreads;
    const int li = idx / kQuads;
    const int wi = w0 + idx - li * kQuads;
    const int gy = gy0 + li;
    const bool row_ok = idx < kHaloItems && gy >= 0 && gy < h;
    const bool ok0 = row_ok && wi >= 0 && wi < row_words;
    const bool ok1 = row_ok && wi + 1 >= 0 && wi + 1 < row_words;
    raw.ok |= (ok0 ? 1u : 0u) << (2 * it) | (ok1 ? 2u : 0u) << (2 * it);
    const size_t row = ((size_t)t.b * h + (row_ok ? gy : 0)) * row_words;
    if constexpr (kU8) {
      const uint32_t* xw = static_cast<const uint32_t*>(x_) + row;
      raw.lo[it] = ok0 ? __ldg(xw + wi) : 0u;
      raw.hi[it] = ok1 ? __ldg(xw + wi + 1) : 0u;
    } else {
      const float4* xf = reinterpret_cast<const float4*>(static_cast<const float*>(x_) + 4 * row);
      raw.lo[it] = ok0 ? __ldg(xf + wi) : make_float4(0.f, 0.f, 0.f, 0.f);
      raw.hi[it] = ok1 ? __ldg(reinterpret_cast<const float*>(xf + wi + 1)) : 0.0f;
    }
  }
}

// Normalize, round to bf16 (0 outside the image) and store the staged rows.
template <bool kU8>
__device__ __forceinline__ void store_halo(const HaloRaw<kU8>& raw, uint32_t* halo_s,
                                           const uint16_t* lut_s, const Norm& nm, int tid) {
#pragma unroll
  for (int it = 0; it < kHaloIters; ++it) {
    const int idx = tid + it * kThreads;
    if (idx >= kHaloItems) break;
    const int li = idx / kQuads;
    const int qd = idx - li * kQuads;
    uint32_t v[4];                        // bf16 bits
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ch = (qd + j) % 3;        // staged element 4 qd + j; 4 = 1 mod 3
      const bool ok = (raw.ok >> (2 * it + (j == 3))) & 1u;
      if constexpr (kU8) {
        const uint32_t bytes = __funnelshift_r(raw.lo[it], raw.hi[it], 8);
        v[j] = ok ? lut_s[ch * 256 + ((bytes >> (8 * j)) & 255u)] : 0u;
      } else {
        const float f = j == 0 ? raw.lo[it].y : j == 1 ? raw.lo[it].z : j == 2 ? raw.lo[it].w : raw.hi[it];
        v[j] = ok ? normalize(f, nm.mean[ch], nm.std[ch]) : 0u;
      }
    }
    *reinterpret_cast<uint2*>(halo_s + li * kRowWords + 2 * qd) =
        make_uint2(v[0] | (v[1] << 16), v[2] | (v[3] << 16));
  }
}

template <bool kU8>
__global__ void __launch_bounds__(kThreads, 2) stem_kernel(
    const void* __restrict__ x_,          // [B, H, W, 3] uint8 or f32, NHWC
    const Norm nm,
    const uint4* __restrict__ wpack,      // packed B, kBBytes
    const float* __restrict__ scale,      // [64]
    const float* __restrict__ bias,       // [64]
    __nv_bfloat16* __restrict__ out,      // [B, H/4, W/4, 64]
    int batch, int h, int wd) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (uint32_t)__cvta_generic_to_shared(smem_raw) % 1024) % 1024);
  uint4* b_s = reinterpret_cast<uint4*>(smem);
  unsigned char* conv_s = smem + kBBytes;
  uint32_t* halo_s = reinterpret_cast<uint32_t*>(smem + kBBytes + kConvBytes);
  float* scale_s = reinterpret_cast<float*>(smem + kBBytes + kConvBytes + kHaloBytes);
  float* bias_s = scale_s + kCout;
  uint16_t* lut_s = reinterpret_cast<uint16_t*>(bias_s + kCout);  // [3][256] bf16 bits
  const uint32_t b_addr = (uint32_t)__cvta_generic_to_shared(smem);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;                // warpgroup: m64 blocks wg, wg + 2, ...
  const int wq = (tid >> 5) & 3;          // warp within the warpgroup: rows 16 wq ..
  const int lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int hc = h / 2, wc = wd / 2;      // conv map
  const int hp = h / 4, wp = wd / 4;      // pooled map
  const int tiles_h = (hp + kTileH - 1) / kTileH;
  const int tiles_w = (wp + kTileW - 1) / kTileW;
  const long long n_tiles = (long long)batch * tiles_h * tiles_w;
  const int row_words = 3 * wd / 4;       // 4-element words per image row (W % 4 == 0)

  for (int i = tid; i < kBBytes / 16; i += kThreads) b_s[i] = wpack[i];
  if (tid < kCout) {
    scale_s[tid] = scale[tid];
    bias_s[tid] = bias[tid];
  }
  if constexpr (kU8) {
    for (int i = tid; i < kLutEntries; i += kThreads)
      lut_s[i] = normalize((float)(i & 255), nm.mean[i >> 8], nm.std[i >> 8]);
  }
  // B was written through the generic proxy; wgmma reads it through the async one.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // From uint8 the next tile's halo words are loaded into registers while
  // this tile is computed (16 registers); from f32 (40) they are loaded when
  // the tile starts.
  HaloRaw<kU8> raw;
  if constexpr (kU8) {
    if (blockIdx.x < n_tiles)
      load_halo<kU8>(raw, x_, tile_origin(blockIdx.x, tiles_h, tiles_w), h, row_words, tid);
  }
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const TileOrigin t = tile_origin(tile, tiles_h, tiles_w);

    // 1. Halo: normalize, round to bf16, zero outside the image.
    if constexpr (!kU8) load_halo<kU8>(raw, x_, t, h, row_words, tid);
    store_halo<kU8>(raw, halo_s, lut_s, nm, tid);
    __syncthreads();
    if constexpr (kU8) {
      if (tile + gridDim.x < n_tiles)
        load_halo<kU8>(raw, x_, tile_origin(tile + gridDim.x, tiles_h, tiles_w), h, row_words, tid);
    }

    // 2. Implicit GEMM on the tensor cores, BN + ReLU, conv tile to shared memory.
#pragma unroll 1
    for (int j = 0; j < kBlocks / 2; ++j) {
      const int blk = 2 * j + wg;
      int abase[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        int m = blk * 64 + wq * 16 + g + 8 * hh;
        m = m < kConvPix ? m : kConvPix - 1;      // padding rows: computed, never stored
        const int r = m / kConvW, c = m - r * kConvW;
        abase[hh] = r * 2 * kRowWords + 3 * c + q;
      }
      uint32_t a[kKSteps][4];
#pragma unroll
      for (int s = 0; s < kKSteps; ++s) {
        a[s][0] = halo_s[abase[0] + a_offset(s, 0)];
        a[s][1] = halo_s[abase[1] + a_offset(s, 0)];
        a[s][2] = halo_s[abase[0] + a_offset(s, 1)];
        a[s][3] = halo_s[abase[1] + a_offset(s, 1)];
      }
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
      wg_fence();
#pragma unroll
      for (int s = 0; s < kKSteps; ++s)
        wgmma_rs_n64(acc, a[s], desc(b_addr + (s / 4) * 8192 + (s % 4) * 32));
      wg_commit();
      wg_wait_all();
      fence_acc(acc);

      // This thread's two rows of the block; outside the conv map they hold
      // 0, the pool's padding.
      bool inside[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = blk * 64 + wq * 16 + g + 8 * hh;
        const int r = m / kConvW, c = m - r * kConvW;
        const int cy = 2 * t.ph0 - 1 + r, cx = 2 * t.pw0 - 1 + c;
        inside[hh] = cy >= 0 && cy < hc && cx >= 0 && cx < wc;
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = nt * 8 + 2 * q;
        const float2 sc = *reinterpret_cast<const float2*>(scale_s + n);
        const float2 bi = *reinterpret_cast<const float2*>(bias_s + n);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = blk * 64 + wq * 16 + g + 8 * hh;
          if (m >= kConvPix) continue;
          const float y0 = fmaxf(__fadd_rn(__fmul_rn(acc[4 * nt + 2 * hh], sc.x), bi.x), 0.0f);
          const float y1 = fmaxf(__fadd_rn(__fmul_rn(acc[4 * nt + 2 * hh + 1], sc.y), bi.y), 0.0f);
          *reinterpret_cast<__nv_bfloat162*>(conv_s + m * 128 + ((nt ^ (m & 7)) << 4) + 4 * q) =
              __floats2bfloat162_rn(inside[hh] ? y0 : 0.0f, inside[hh] ? y1 : 0.0f);
        }
      }
    }
    __syncthreads();

    // 3. 3x3 stride-2 max over the staged conv tile, 8 channels per item.
    for (int item = tid; item < kTileH * kTileW * 8; item += kThreads) {
      const int chunk = item & 7;
      const int pix = item >> 3;
      const int pr = pix / kTileW, pc = pix % kTileW;
      const int ph = t.ph0 + pr, pw = t.pw0 + pc;
      if (ph >= hp || pw >= wp) continue;
      __nv_bfloat162 mx[4];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int p = (2 * pr + dy) * kConvW + (2 * pc + dx);
          const uint4 v4 = *reinterpret_cast<const uint4*>(conv_s + p * 128 + ((chunk ^ (p & 7)) << 4));
          const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&v4);
#pragma unroll
          for (int k = 0; k < 4; ++k) mx[k] = (dy == 0 && dx == 0) ? v[k] : __hmax2(mx[k], v[k]);
        }
      }
      __nv_bfloat16* o = out + (((size_t)t.b * hp + ph) * wp + pw) * kCout + chunk * 8;
      *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(mx);
    }
    // The next tile's halo store touches halo_s only, which no thread reads
    // after the __syncthreads above; conv_s is rewritten only after the next
    // tile's first __syncthreads, when every thread has finished this pool.
  }
}

template <bool kU8>
int launch(const void* x, const Norm& nm, const void* wpack, const void* scale, const void* bias,
           void* out, int batch, int h, int wd, cudaStream_t s) {
  auto kernel = stem_kernel<kU8>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, kSmemBytes)) !=
      cudaSuccess)
    return (int)err;
  const long long tiles = (long long)batch * ((h / 4 + kTileH - 1) / kTileH) *
                          ((wd / 4 + kTileW - 1) / kTileW);
  const long long grid = per_sm > 0 ? (long long)per_sm * sms : (long long)sms;
  kernel<<<(unsigned)(tiles < grid ? tiles : grid), kThreads, kSmemBytes, s>>>(
      x, nm, static_cast<const uint4*>(wpack), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), batch, h, wd);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, H, W, 3] NHWC, uint8 (is_u8 = 1, 4-byte aligned) or f32 (16-byte
// aligned), H % 4 == 0, W % 4 == 0; mean0-2, std0-2 the per-channel
// normalize constants; wpack the packed B
// operand (kernels/stem.py::pack_stem_weights, 24576 bytes); scale, bias [64]
// f32; out [B, H/4, W/4, 64] bf16 NHWC. Returns the cudaError_t of the launch
// (0 on success).
extern "C" int stem_forward(const void* x, int is_u8, float mean0, float mean1, float mean2,
                            float std0, float std1, float std2, const void* wpack,
                            const void* scale, const void* bias, void* out, int batch, int h,
                            int wd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Norm nm = {{mean0, mean1, mean2}, {std0, std1, std2}};
  return is_u8 ? launch<true>(x, nm, wpack, scale, bias, out, batch, h, wd, s)
               : launch<false>(x, nm, wpack, scale, bias, out, batch, h, wd, s);
}
