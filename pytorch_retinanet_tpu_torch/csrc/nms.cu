// Greedy NMS keep mask over score-descending, class-offset XYXY candidates.
//
// Replaces pytorch_retinanet_tpu/kernels/nms_pallas.py::pallas_nms_keep_mask
// (_nms_kernel), which builds the [K, K] suppression matrix in VMEM and runs
// the greedy fixpoint as matvecs on the MXU, one image per call under vmap.
//
// What bounds it on an H100: not bytes and not arithmetic. At K = 1000 an
// image needs 0.5 M IoU pairs and a 128 KB bitmask (4 MB for a batch of 32,
// about 1.2 us of HBM traffic). Greedy suppression is a serial chain over the
// candidates, so the kernel is bound by the latency of the in-order scan.
//
// Design, two launches on the caller's stream, over 64-candidate chunks:
//   1. nms_mask_kernel: one 64-thread block per tile (row chunk r, column
//      chunk c >= r) of each image; the lower triangle is never read and
//      never launched. Thread t owns row i = 64r + t and writes one 64-bit
//      word: bit u of word (i, c) says that candidate i, if kept, removes
//      candidate j = 64c + u (j > i, both valid, IoU > thr). A pair whose
//      intersection has a zero side gets IoU 0 without the division.
//      Diagonal tiles also write their words to a compact array, and the
//      chunk's valid bits.
//   2. nms_scan_kernel: one warp per image walks the chunks in order. The
//      removed bits live in shared memory, one word per chunk, seeded with
//      the invalid candidates and those past K. For chunk c the warp
//        - reads word c once, and the chunk's 64 diagonal words into
//          registers, two per lane, ahead of the chain;
//        - resolves the 64 decisions with register bit operations: only the
//          alive candidates whose diagonal word is non-zero can change a
//          later decision in the chunk, so the chain visits those alone,
//          each a 32-bit find-first-set, a shuffle and an AND-NOT;
//        - writes the chunk's 64 keep bytes, two per lane, off the chain;
//        - ORs the kept rows into the removed words past c, lane w owning
//          word w (and w + 32, ...), all lanes at once.
//      Chunk c + 1's rows and diagonal words are copied into shared memory
//      with cp.async while chunk c resolves (two buffers, 1 KB per 64
//      candidates of K); where they do not fit (K above ~12,600) they are
//      read from global memory instead. This is sequential greedy itself,
//      not a fixpoint, so it needs no convergence loop and is exact at any K.
//
// Exactness: the IoU uses the operations and the order of
// ops/boxes.py::box_iou with explicit round-to-nearest intrinsics and IEEE
// division (the file is also built with -fmad=false), so every `> thr`
// decision equals the reference's; a zero intersection side makes the IoU
// +-0 there, so its decision is `0 > thr`.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kBlock = 64;  // candidates per chunk: rows and columns of a pass-1 block
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxScanSmem = 200 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f), fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

__global__ void __launch_bounds__(kBlock) nms_mask_kernel(
    const float4* __restrict__ boxes, const uint8_t* __restrict__ valid, u64* __restrict__ mask,
    u64* __restrict__ diag, u64* __restrict__ vmask, int k, int nwords, float thr) {
  int r = 0, rem = blockIdx.x;  // blockIdx.x enumerates the tiles c >= r, row by row
  while (rem >= nwords - r) {
    rem -= nwords - r;
    ++r;
  }
  const int c = r + rem, b = blockIdx.y, t = threadIdx.x;
  const int i = r * kBlock + t, j0 = c * kBlock;
  const float4* bb = boxes + (size_t)b * k;
  const uint8_t* vv = valid + (size_t)b * k;

  __shared__ float4 col_box[kBlock];
  __shared__ float col_area[kBlock];
  __shared__ unsigned col_bits[kBlock / 32];
  const bool col_valid = j0 + t < k && vv[j0 + t];
  if (j0 + t < k) {
    const float4 box = bb[j0 + t];
    col_box[t] = box;
    col_area[t] = box_area(box);
  }
  const unsigned bal = __ballot_sync(kFull, col_valid);
  if ((t & 31) == 0) col_bits[t >> 5] = bal;
  __syncthreads();
  u64 cols = col_bits[0] | ((u64)col_bits[1] << 32);  // valid candidates of the column chunk
  if (r == c) {
    if (t == 0) vmask[(size_t)b * nwords + r] = cols;  // the row chunk is the column chunk
    cols = t == kBlock - 1 ? 0ull : cols & (~0ull << (t + 1));  // j > i
  }
  if (!(i < k && vv[i])) cols = 0ull;

  const bool zero_suppresses = 0.0f > thr;
  u64 bits = 0ull;
  if (cols) {
    const float4 a = bb[i];
    const float area_a = box_area(a);
#pragma unroll 8
    for (int u = 0; u < kBlock; ++u) {
      if (!((cols >> u) & 1ull)) continue;
      const float4 o = col_box[u];
      const float ix = fmaxf(__fsub_rn(fminf(a.z, o.z), fmaxf(a.x, o.x)), 0.0f);
      const float iy = fmaxf(__fsub_rn(fminf(a.w, o.w), fmaxf(a.y, o.y)), 0.0f);
      bool s = zero_suppresses;
      if (ix != 0.0f && iy != 0.0f) {
        const float inter = __fmul_rn(ix, iy);
        const float uni = __fsub_rn(__fadd_rn(area_a, col_area[u]), inter);
        s = __fdiv_rn(inter, fmaxf(uni, 1e-12f)) > thr;
      }
      if (s) bits |= 1ull << u;
    }
  }
  const size_t row = (size_t)b * nwords * kBlock + i;
  mask[row * nwords + c] = bits;
  if (r == c) diag[row] = bits;
}

// 64 rows x nwords words of the mask and the chunk's 64 diagonal words;
// contiguous and 16-byte aligned on both sides.
__device__ __forceinline__ void copy_chunk(u64* dst, const u64* rows, const u64* diag, int nwords,
                                           int lane) {
  const int row_units = nwords * kBlock / 2;
  for (int q = lane; q < row_units + kBlock / 2; q += 32) {
    const u64* src = q < row_units ? rows + 2 * q : diag + 2 * (q - row_units);
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst + 2 * q));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__global__ void __launch_bounds__(32) nms_scan_kernel(
    const u64* __restrict__ mask, const u64* __restrict__ diag, const u64* __restrict__ vmask,
    uint8_t* __restrict__ keep, int k, int nwords, int staged) {
  extern __shared__ __align__(16) u64 smem[];
  const int b = blockIdx.x, lane = threadIdx.x;
  const size_t chunk_words = (size_t)kBlock * nwords, buf_words = chunk_words + kBlock;
  u64* s_buf = smem;                                 // [2][64 rows + 64 diagonal words], if staged
  u64* s_rem = smem + (staged ? 2 * buf_words : 0);  // [nwords] removed bits
  const u64* rows = mask + (size_t)b * nwords * chunk_words;
  const u64* dg = diag + (size_t)b * nwords * kBlock;
  uint8_t* kp = keep + (size_t)b * k;

  for (int w = lane; w < nwords; w += 32) s_rem[w] = ~vmask[(size_t)b * nwords + w];
  if (staged) copy_chunk(s_buf, rows, dg, nwords, lane);
  __syncwarp();

  for (int c = 0; c < nwords; ++c) {
    const u64* chunk = rows + c * chunk_words;
    const u64* chunk_diag = dg + c * kBlock;
    if (staged) {
      // Chunk c + 1 into the other buffer (its last reader, chunk c - 1, is done).
      if (c + 1 < nwords) {
        copy_chunk(s_buf + ((c + 1) & 1) * buf_words, chunk + chunk_words, chunk_diag + kBlock,
                   nwords, lane);
      } else {
        asm volatile("cp.async.commit_group;\n" ::);
      }
      asm volatile("cp.async.wait_group 1;\n" ::);
      __syncwarp();
      chunk = s_buf + (c & 1) * buf_words;
      chunk_diag = chunk + chunk_words;
    }
    // The chunk's diagonal words, ahead of the chain, as 32-bit halves.
    const u64 d_lo = chunk_diag[lane], d_hi = chunk_diag[lane + 32];
    const unsigned diag_lo = __ballot_sync(kFull, d_lo != 0ull);
    const unsigned diag_hi = __ballot_sync(kFull, d_hi != 0ull);
    const u64 removed_in = s_rem[c];
    unsigned rm_lo = (unsigned)removed_in, rm_hi = (unsigned)(removed_in >> 32);
    // Candidates 0-31 of the chunk, then 32-63 (whose words have no low bits).
    for (unsigned todo = ~rm_lo & diag_lo; todo;) {
      const int t = __ffs(todo) - 1;  // alive, and kept: nothing before it removed it
      const unsigned lo = __shfl_sync(kFull, (unsigned)d_lo, t);
      const unsigned hi = __shfl_sync(kFull, (unsigned)(d_lo >> 32), t);
      rm_lo |= lo;
      rm_hi |= hi;
      todo &= ~lo & (todo - 1u);
    }
    for (unsigned todo = ~rm_hi & diag_hi; todo;) {
      const int t = __ffs(todo) - 1;
      const unsigned hi = __shfl_sync(kFull, (unsigned)(d_hi >> 32), t);
      rm_hi |= hi;
      todo &= ~hi & (todo - 1u);
    }
    const u64 kept = ~(rm_lo | ((u64)rm_hi << 32));
    const int j = c * kBlock + lane;
    if (j < k) kp[j] = (uint8_t)((kept >> lane) & 1ull);
    if (j + 32 < k) kp[j + 32] = (uint8_t)((kept >> (lane + 32)) & 1ull);

    // The kept rows into the removed words past c: every row's word, kept
    // ones ORed, so that no step waits on the one before.
    if (kept) {
      for (int w = c + 1 + lane; w < nwords; w += 32) {
        u64 acc = s_rem[w];
#pragma unroll
        for (int t = 0; t < kBlock; ++t) {
          const u64 word = chunk[(size_t)t * nwords + w];
          acc |= (kept >> t) & 1ull ? word : 0ull;
        }
        s_rem[w] = acc;
      }
    }
    __syncwarp();
  }
}

}  // namespace

// boxes [B, K, 4] f32 (16-byte aligned), valid [B, K] bytes 0/1, scratch of
// B * 64 * W * (W + 1) + B * W u64 (16-byte aligned; W = ceil(K/64)), keep
// [B, K] bytes 0/1. Returns the cudaError_t of the launches (0 on success).
extern "C" int nms_keep_mask(const void* boxes, const void* valid, void* scratch, void* keep,
                             int batch, int k, float thr, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nwords = (k + kBlock - 1) / kBlock;
  const size_t rows = (size_t)batch * kBlock * nwords;  // padded rows of the batch
  u64* mask = static_cast<u64*>(scratch);               // [B, 64 W, W]
  u64* diag = mask + rows * nwords;                      // [B, 64 W], word (i, i / 64)
  u64* vmask = diag + rows;                              // [B, W] valid bits
  const dim3 grid(nwords * (nwords + 1) / 2, batch);
  nms_mask_kernel<<<grid, kBlock, 0, s>>>(static_cast<const float4*>(boxes),
                                          static_cast<const uint8_t*>(valid), mask, diag, vmask,
                                          k, nwords, thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t base_bytes = (size_t)nwords * sizeof(u64);
  const size_t staged_bytes = base_bytes + 2 * (size_t)kBlock * (nwords + 1) * sizeof(u64);
  const int staged = staged_bytes <= kMaxScanSmem ? 1 : 0;
  const size_t smem = staged ? staged_bytes : base_bytes;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nms_scan_kernel<<<batch, 32, smem, s>>>(mask, diag, vmask, static_cast<uint8_t*>(keep), k, nwords,
                                          staged);
  return (int)cudaGetLastError();
}
