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
// Design, two launches on the caller's stream:
//   1. nms_mask_kernel: a grid over (64-column block, 64-row block, image).
//      Each thread owns one row i and writes one 64-bit word of the
//      suppression bitmask: bit t of word (i, c) says that candidate i, if
//      kept, removes candidate j = 64c + t (j > i, both valid, IoU > thr).
//      Blocks wholly below the diagonal write zeros without computing.
//   2. nms_scan_kernel: one block per image. All threads stage the image's
//      bitmask and valid flags in shared memory (when they fit: K <= ~1700),
//      then one warp walks the rows in order, OR-ing each kept row into a
//      removed-mask in shared memory. This is sequential greedy itself, not a
//      fixpoint, so it needs no convergence loop.
//
// Exactness: the IoU uses the operations and the order of
// ops/boxes.py::box_iou with explicit round-to-nearest intrinsics and IEEE
// division (the file is also built with -fmad=false), so every `> thr`
// decision equals the reference's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;              // rows and columns per pass-1 block
constexpr int kScanThreads = 256;       // threads that stage the mask in pass 2
constexpr size_t kMaxScanSmem = 200 * 1024;

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f), fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

__device__ __forceinline__ float iou(float4 a, float area_a, float4 b) {
  const float ix = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  const float iy = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(ix, iy);
  const float uni = __fsub_rn(__fadd_rn(area_a, box_area(b)), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-12f));
}

__global__ void __launch_bounds__(kBlock) nms_mask_kernel(
    const float4* __restrict__ boxes, const uint8_t* __restrict__ valid,
    unsigned long long* __restrict__ mask, int k, int nwords, float thr) {
  const int col_block = blockIdx.x, row_block = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x;
  const int i = row_block * kBlock + t;
  const int j0 = col_block * kBlock;
  const float4* bb = boxes + (size_t)b * k;
  const uint8_t* vv = valid + (size_t)b * k;

  __shared__ float4 col_box[kBlock];
  __shared__ uint8_t col_valid[kBlock];
  if (j0 + t < k) {
    col_box[t] = bb[j0 + t];
    col_valid[t] = vv[j0 + t];
  }
  __syncthreads();
  if (i >= k) return;

  unsigned long long bits = 0ull;
  if (col_block >= row_block && vv[i]) {
    const float4 a = bb[i];
    const float area_a = box_area(a);
    const int n = min(kBlock, k - j0);
    for (int c = 0; c < n; ++c) {
      const int j = j0 + c;
      if (j > i && col_valid[c] && iou(a, area_a, col_box[c]) > thr) bits |= 1ull << c;
    }
  }
  mask[((size_t)b * k + i) * nwords + col_block] = bits;
}

__global__ void __launch_bounds__(kScanThreads) nms_scan_kernel(
    const unsigned long long* __restrict__ mask, const uint8_t* __restrict__ valid,
    uint8_t* __restrict__ keep, int k, int nwords, int rows_in_smem) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* removed = smem;                      // [nwords]
  unsigned long long* staged = smem + nwords;              // [k * nwords] if staged
  uint8_t* valid_s = reinterpret_cast<uint8_t*>(staged + (rows_in_smem ? (size_t)k * nwords : 0));

  const int b = blockIdx.x;
  const unsigned long long* rows = mask + (size_t)b * k * nwords;
  const uint8_t* vv = valid + (size_t)b * k;
  for (int w = threadIdx.x; w < nwords; w += blockDim.x) removed[w] = 0ull;
  for (int i = threadIdx.x; i < k; i += blockDim.x) valid_s[i] = vv[i];
  if (rows_in_smem) {
    for (size_t idx = threadIdx.x; idx < (size_t)k * nwords; idx += blockDim.x) staged[idx] = rows[idx];
    rows = staged;  // generic pointer into shared memory
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;

  const int lane = threadIdx.x;
  uint8_t* kp = keep + (size_t)b * k;
  for (int i = 0; i < k; ++i) {
    const bool kept = valid_s[i] && !((removed[i >> 6] >> (i & 63)) & 1ull);
    if (lane == 0) kp[i] = kept ? 1 : 0;
    if (kept) {
      for (int w = lane; w < nwords; w += 32) removed[w] |= rows[(size_t)i * nwords + w];
    }
    __syncwarp();
  }
}

}  // namespace

// boxes [B, K, 4] f32 (16-byte aligned), valid [B, K] bytes 0/1,
// mask scratch [B, K, ceil(K/64)] u64, keep [B, K] bytes 0/1.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int nms_keep_mask(const void* boxes, const void* valid, void* mask, void* keep,
                             int batch, int k, float thr, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nwords = (k + kBlock - 1) / kBlock;
  dim3 grid(nwords, nwords, batch);
  nms_mask_kernel<<<grid, kBlock, 0, s>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<unsigned long long*>(mask), k, nwords, thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t rows_bytes = (size_t)k * nwords * sizeof(unsigned long long);
  const size_t base_bytes = (size_t)nwords * sizeof(unsigned long long) + (size_t)k;
  const int rows_in_smem = base_bytes + rows_bytes <= kMaxScanSmem ? 1 : 0;
  const size_t smem = base_bytes + (rows_in_smem ? rows_bytes : 0);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nms_scan_kernel<<<batch, kScanThreads, smem, s>>>(
      static_cast<const unsigned long long*>(mask), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), k, nwords, rows_in_smem);
  return (int)cudaGetLastError();
}
