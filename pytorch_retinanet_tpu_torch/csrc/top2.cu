// Per-row top-2 classes of [A, C] logits in one pass over the bytes.
//
// Replaces pytorch_retinanet_tpu/kernels/select_pallas.py::pallas_top2_classes
// (_top2_kernel). On the TPU the [R, 90] block's minor dim is not 128-aligned,
// so Mosaic loads it as row-strided DMA into lane-padded tiles; here the rows
// are one flat stream of bytes.
//
// What bounds it on an H100: bytes. Each element is read once and four 4-byte
// values are written per row (at [32 * 151200, 90] bf16: 871 MB read, 0.26 ms
// at 3.35 TB/s); the compares are a few per element.
//
// Design: a CTA takes `rows` consecutive rows, copies their bytes into shared
// memory with coalesced 16-byte loads (element loads where the block's span is
// not 16-byte aligned), then one thread per row scans its row from shared
// memory twice, as the reference does: the first strict `>` scan gives the
// maximum and its lowest class id; the second, with that id set to -3e38,
// gives the second value and its lowest id. A row's stride in shared memory is
// C elements, which for bf16 C = 90 (45 words) puts the 32 rows a warp reads at
// once in 32 different banks. NaN logits are not handled (the comparisons skip
// them).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNeg = -3.0e38f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads) top2_kernel(const T* __restrict__ x, float* v1,
                                                        int32_t* c1, float* v2, int32_t* c2,
                                                        long long a, int c, int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const long long r0 = (long long)blockIdx.x * rows;
  const int n_rows = (int)min((long long)rows, a - r0);
  const long long n = (long long)n_rows * c;
  const T* src = x + r0 * c;
  const long long bytes = n * (long long)sizeof(T);
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (bytes & 15) == 0) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(s);
    for (long long i = threadIdx.x; i < bytes / 16; i += kThreads) d4[i] = __ldcs(s4 + i);
  } else {
    for (long long i = threadIdx.x; i < n; i += kThreads) s[i] = src[i];
  }
  __syncthreads();
  for (int r = threadIdx.x; r < n_rows; r += kThreads) {
    const T* row = s + (long long)r * c;
    float best = to_f32(row[0]);
    int idx = 0;
    for (int k = 1; k < c; ++k) {
      const float v = to_f32(row[k]);
      if (v > best) {
        best = v;
        idx = k;
      }
    }
    float second = idx == 0 ? kNeg : to_f32(row[0]);
    int idx2 = 0;
    for (int k = 1; k < c; ++k) {
      const float v = k == idx ? kNeg : to_f32(row[k]);
      if (v > second) {
        second = v;
        idx2 = k;
      }
    }
    const long long o = r0 + r;
    v1[o] = best;
    c1[o] = idx;
    v2[o] = second;
    c2[o] = idx2;
  }
}

template <typename T>
int launch(const void* x, void* v1, void* c1, void* v2, void* c2, long long a, int c, int rows,
           cudaStream_t stream) {
  const size_t smem = ((size_t)rows * c * sizeof(T) + 15) / 16 * 16;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        top2_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (a + rows - 1) / rows;
  top2_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(v1), static_cast<int32_t*>(c1),
      static_cast<float*>(v2), static_cast<int32_t*>(c2), a, c, rows);
  return (int)cudaGetLastError();
}

}  // namespace

// x [A, C] row-major, bf16 (is_bf16 = 1) or f32; outputs v1, v2 [A] f32 and
// c1, c2 [A] int32. `rows` rows per CTA, rows * C elements in shared memory
// (at most 227 KB). Returns the cudaError_t of the launch (0 on success).
extern "C" int top2_classes(const void* x, void* v1, void* c1, void* v2, void* c2, long long a,
                            int c, int rows, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, v1, c1, v2, c2, a, c, rows, s)
                 : launch<float>(x, v1, c1, v2, c2, a, c, rows, s);
}
