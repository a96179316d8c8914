// Frozen batch norm (running statistics) with an optional fused ReLU, forward
// and backward, for training.
//
// Replaces no Pallas kernel: the JAX package leaves frozen BN to XLA, which
// fuses the affine map, the ReLU and their transposes into the convolutions'
// neighbours. Under PyTorch's autograd, eval-mode F.batch_norm on a
// channels-last bf16 activation takes three passes for its input gradient
// (a generic elementwise kernel, a strided copy back into channels-last, a
// reduction for the parameter gradients) and the ReLU after it two more.
// Here each direction is one pass over the activation.
//
//   forward:  y  = act(round((x - mean) * scale + bias)),
//             scale = weight * rsqrt(var + eps), act = ReLU or identity,
//             f32 arithmetic, one rounding into x's dtype;
//   backward: g  = dy where the forward's y > 0 (ReLU; else dy),
//             dx = round(g * scale),
//             dbias = sum g, dweight = (sum g * (x - mean)) * rsqrt(var + eps),
//             sums per channel over (N, H, W) in f32.
//
// rsqrt is the reciprocal of the square root, each correctly rounded, and
// scale multiplies it by weight: flax's order of operations, which the port's
// CPU training is held to over many steps (a scale of weight / sqrt, one ulp
// off for some channels, drifts further from JAX's losses).
//
// The backward recomputes the ReLU mask from x with the forward's own
// arithmetic (the same device functions, IEEE operations that nvcc may not
// contract), so the mask is the forward's bit for bit and y is not saved.
// The plain version (kernels/frozen_bn.py) performs the same IEEE operations
// in the same order, so y and dx equal it bit for bit; the two sums differ
// by their order of addition.
//
// What bounds it on an H100: bytes. The forward reads x and writes y, the
// backward reads x and dy and writes dx: 4 and 6 bytes an element in bf16.
// At R-50, batch 16, 800x1344 the 53 frozen BNs see 3.81 G elements a step,
// 15.2 GB forward (4.5 ms at 3.35 TB/s) and 22.9 GB backward (6.8 ms).
//
// Design. Channels-last ([R = N*H*W rows, C]): each thread owns one group of
// VEC channels (16 bytes: 8 bf16 or 4 f32) for the whole launch, keeps their
// mean, scale and bias (and in the backward their two sums) in registers,
// and walks rows with a grid stride, U rows of loads in flight at a time. A
// block is rpb rows of C / VEC threads, so a warp reads whole rows: 16-byte
// loads, neighbouring threads on neighbouring addresses. The grid is one
// wave of resident blocks (occupancy API), from the stem's 4.3 M rows x 64
// channels to layer4's 16.8 K rows x 2048. NCHW ([N*C planes, H*W]): blocks
// take chunks of one plane, whose channel is one scalar. The backward's
// sums are deterministic: each thread adds its rows in a fixed order, a
// block adds its threads' sums in a fixed order into one row of a scratch
// [G, 2, C] buffer, and a second small kernel adds the G rows per channel in
// a fixed order. No atomics, so two runs (and two DDP ranks on the same
// rows) give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kRowThreads = 256;  // threads of a channels-last block with rpb > 1
constexpr int kUnroll = 4;        // rows (vectors) of loads in flight per thread
constexpr int kNchwChunkVecs = 4;  // vectors per thread in one NCHW chunk

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The value x's dtype holds for v: the forward's one rounding.
template <typename T>
__device__ __forceinline__ float rounded(float v) { return to_f32(from_f32<T>(v)); }

__device__ __forceinline__ float inv_std(float var, float eps) {
  return __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
}

// (x - mean) * scale + bias, rounded once per operation as the plain version.
__device__ __forceinline__ float affine(float x, float m, float s, float b) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, m), s), b);
}

// torch.relu of a rounded value: 0 where y <= 0, y elsewhere (NaN stays).
__device__ __forceinline__ float relu(float y) { return y <= 0.f ? 0.f : y; }

// N consecutive elements as floats. N * sizeof(T) == 16 is one vector load.
template <typename T, int N>
__device__ __forceinline__ void load(const T* __restrict__ p, float (&f)[N]) {
  if constexpr (N == 1) {
    f[0] = to_f32(p[0]);
  } else if constexpr (sizeof(T) == 4) {
    static_assert(N == 4, "f32 vectors are 4 wide");
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  } else {
    static_assert(N == 8, "bf16 vectors are 8 wide");
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x, f[2 * i + 1] = t.y;
    }
  }
}

template <typename T, int N>
__device__ __forceinline__ void store(T* __restrict__ p, const float (&f)[N]) {
  if constexpr (N == 1) {
    p[0] = from_f32<T>(f[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
}

struct Params {
  const float* w;
  const float* b;
  const float* mean;
  const float* var;
  float eps;
};

template <int N>
__device__ __forceinline__ void channel_params(const Params& p, int c0, float (&m)[N],
                                               float (&s)[N], float (&b)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    m[k] = p.mean[c0 + k];
    s[k] = __fmul_rn(p.w[c0 + k], inv_std(p.var[c0 + k], p.eps));
    b[k] = p.b[c0 + k];
  }
}

// y for one vector, in place.
template <typename T, int N, bool RELU>
__device__ __forceinline__ void forward_vec(float (&v)[N], const float (&m)[N],
                                            const float (&s)[N], const float (&b)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float y = rounded<T>(affine(v[k], m[k], s[k], b[k]));
    v[k] = RELU ? relu(y) : y;
  }
}

// dx for one vector into g (which holds dy), with the sums.
template <typename T, int N, bool RELU>
__device__ __forceinline__ void backward_vec(const float (&x)[N], float (&g)[N],
                                             const float (&m)[N], const float (&s)[N],
                                             const float (&b)[N], float (&sg)[N],
                                             float (&sgx)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float gk = g[k];
    if (RELU && rounded<T>(affine(x[k], m[k], s[k], b[k])) <= 0.f) gk = 0.f;
    sg[k] += gk;
    sgx[k] = fmaf(gk, __fsub_rn(x[k], m[k]), sgx[k]);
    g[k] = __fmul_rn(gk, s[k]);
  }
}

// ---------------------------------------------------------------------------
// Channels-last: [rows, c], blockDim = (c / N) * rpb.
// ---------------------------------------------------------------------------
template <typename T, int N, bool RELU>
__global__ void __launch_bounds__(kMaxThreads) forward_nhwc(const T* __restrict__ x,
                                                            T* __restrict__ y, Params p,
                                                            long long rows, int c, int rpb) {
  const int vpr = c / N;
  const int col = (threadIdx.x % vpr) * N;
  const int rr = threadIdx.x / vpr;
  float m[N], s[N], b[N];
  channel_params(p, col, m, s, b);
  const long long step = (long long)gridDim.x * rpb;
  long long r = (long long)blockIdx.x * rpb + rr;
  for (; r + (kUnroll - 1) * step < rows; r += kUnroll * step) {
    float v[kUnroll][N];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load<T, N>(x + (r + u * step) * c + col, v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      forward_vec<T, N, RELU>(v[u], m, s, b);
      store<T, N>(y + (r + u * step) * c + col, v[u]);
    }
  }
  for (; r < rows; r += step) {
    float v[N];
    load<T, N>(x + r * c + col, v);
    forward_vec<T, N, RELU>(v, m, s, b);
    store<T, N>(y + r * c + col, v);
  }
}

// Writes this block's sums into partial[blockIdx.x] = [sum g (c), sum g (x - mean) (c)].
template <typename T, int N, bool RELU>
__global__ void __launch_bounds__(kMaxThreads) backward_nhwc(
    const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
    float* __restrict__ partial, Params p, long long rows, int c, int rpb) {
  const int vpr = c / N;
  const int col = (threadIdx.x % vpr) * N;
  const int rr = threadIdx.x / vpr;
  float m[N], s[N], b[N], sg[N], sgx[N];
  channel_params(p, col, m, s, b);
#pragma unroll
  for (int k = 0; k < N; ++k) sg[k] = sgx[k] = 0.f;
  const long long step = (long long)gridDim.x * rpb;
  long long r = (long long)blockIdx.x * rpb + rr;
  for (; r + (kUnroll - 1) * step < rows; r += kUnroll * step) {
    float xv[kUnroll][N], gv[kUnroll][N];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      load<T, N>(x + (r + u * step) * c + col, xv[u]);
      load<T, N>(dy + (r + u * step) * c + col, gv[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      backward_vec<T, N, RELU>(xv[u], gv[u], m, s, b, sg, sgx);
      store<T, N>(dx + (r + u * step) * c + col, gv[u]);
    }
  }
  for (; r < rows; r += step) {
    float xv[N], gv[N];
    load<T, N>(x + r * c + col, xv);
    load<T, N>(dy + r * c + col, gv);
    backward_vec<T, N, RELU>(xv, gv, m, s, b, sg, sgx);
    store<T, N>(dx + r * c + col, gv);
  }
  float* out = partial + (long long)blockIdx.x * 2 * c;
  if (rpb == 1) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      out[col + k] = sg[k];
      out[c + col + k] = sgx[k];
    }
    return;
  }
  // The block's rpb row groups, added in order: red[which][rr][channel].
  extern __shared__ float red[];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    red[rr * c + col + k] = sg[k];
    red[(rpb + rr) * c + col + k] = sgx[k];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * c; i += blockDim.x) {
    const int which = i / c, ch = i - which * c;
    const float* src = red + (long long)which * rpb * c + ch;
    float acc = 0.f;
    for (int q = 0; q < rpb; ++q) acc += src[q * c];
    out[i] = acc;
  }
}

// ---------------------------------------------------------------------------
// NCHW: [planes = n * c, hw]; block i takes chunk i % chunks of plane i / chunks.
// ---------------------------------------------------------------------------
template <typename T, int N, bool RELU>
__global__ void __launch_bounds__(kRowThreads) forward_nchw(const T* __restrict__ x,
                                                            T* __restrict__ y, Params p,
                                                            long long hw, int c, int chunks,
                                                            long long chunk) {
  const long long plane = blockIdx.x / chunks;
  const long long lo = plane * hw + (blockIdx.x % chunks) * chunk;
  const long long hi = min(lo + chunk, (plane + 1) * hw);
  float m[1], s[1], b[1];
  channel_params(p, (int)(plane % c), m, s, b);
  for (long long i = lo + (long long)threadIdx.x * N; i < hi; i += (long long)blockDim.x * N) {
    float v[N];
    load<T, N>(x + i, v);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float yk = rounded<T>(affine(v[k], m[0], s[0], b[0]));
      v[k] = RELU ? relu(yk) : yk;
    }
    store<T, N>(y + i, v);
  }
}

// Writes this block's two sums at partial[(n * chunks + chunk) * 2c + {0, c} + channel].
template <typename T, int N, bool RELU>
__global__ void __launch_bounds__(kRowThreads) backward_nchw(
    const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
    float* __restrict__ partial, Params p, long long hw, int c, int chunks, long long chunk) {
  const long long plane = blockIdx.x / chunks;
  const int kc = blockIdx.x % chunks;
  const long long lo = plane * hw + kc * chunk;
  const long long hi = min(lo + chunk, (plane + 1) * hw);
  const int ch = (int)(plane % c);
  float m[1], s[1], b[1];
  channel_params(p, ch, m, s, b);
  float sg = 0.f, sgx = 0.f;
  for (long long i = lo + (long long)threadIdx.x * N; i < hi; i += (long long)blockDim.x * N) {
    float xv[N], gv[N];
    load<T, N>(x + i, xv);
    load<T, N>(dy + i, gv);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float g = gv[k];
      if (RELU && rounded<T>(affine(xv[k], m[0], s[0], b[0])) <= 0.f) g = 0.f;
      sg += g;
      sgx = fmaf(g, __fsub_rn(xv[k], m[0]), sgx);
      gv[k] = __fmul_rn(g, s[0]);
    }
    store<T, N>(dx + i, gv);
  }
  // Fixed-order tree: warp shuffles, then warp 0 over the warps.
  __shared__ float red[2][kRowThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sg += __shfl_down_sync(0xffffffffu, sg, o);
    sgx += __shfl_down_sync(0xffffffffu, sgx, o);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  if (lane == 0) red[0][warp] = sg, red[1][warp] = sgx;
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.f, bsum = 0.f;
    for (int w = 0; w < warps; ++w) a += red[0][w], bsum += red[1][w];
    float* out = partial + ((plane / c) * chunks + kc) * 2 * c;
    out[ch] = a;
    out[c + ch] = bsum;
  }
}

// dbias = sum over the g rows of partial[:, 0], dweight = sum of partial[:, 1]
// * rsqrt(var + eps); block (32 channels, 32 slices of the rows), fixed order.
__global__ void __launch_bounds__(1024) finalize(const float* __restrict__ partial, long long g,
                                                 int c, Params p, float* __restrict__ dweight,
                                                 float* __restrict__ dbias) {
  __shared__ float red[2][32][33];
  const int ch = blockIdx.x * 32 + threadIdx.x;
  float a = 0.f, bsum = 0.f;
  if (ch < c) {
    for (long long j = threadIdx.y; j < g; j += 32) {
      a += partial[j * 2 * c + ch];
      bsum += partial[j * 2 * c + c + ch];
    }
  }
  red[0][threadIdx.y][threadIdx.x] = a;
  red[1][threadIdx.y][threadIdx.x] = bsum;
  __syncthreads();
  if (threadIdx.y == 0 && ch < c) {
    a = bsum = 0.f;
    for (int q = 0; q < 32; ++q) a += red[0][q][threadIdx.x], bsum += red[1][q][threadIdx.x];
    dbias[ch] = a;
    dweight[ch] = __fmul_rn(bsum, inv_std(p.var[ch], p.eps));
  }
}

// ---------------------------------------------------------------------------
// Launch plans: the same for the forward, the backward and the scratch size.
// ---------------------------------------------------------------------------
struct Plan {
  int threads;
  int rpb;          // channels-last rows per block
  int chunks;       // NCHW chunks per plane
  long long chunk;  // NCHW elements per chunk
  long long grid;
  int smem;
};

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// Blocks of `kernel` resident on the card at once, asked once per (kernel,
// threads, shared memory): the forward and the backward (autograd's thread)
// may ask at the same time.
template <typename K>
long long resident_blocks(K kernel, int threads, int smem) {
  struct Entry {
    const void* kernel;
    int threads, smem;
    long long blocks;
  };
  static std::mutex lock;
  static std::vector<Entry> seen;
  const void* key = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> guard(lock);
  for (const Entry& e : seen)
    if (e.kernel == key && e.threads == threads && e.smem == smem) return e.blocks;
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  const long long blocks = (long long)(per_sm > 0 ? per_sm : 1) * sm_count();
  seen.push_back({key, threads, smem, blocks});
  return blocks;
}

template <typename K>
Plan plan(K kernel, long long n, int c, long long hw, bool channels_last, int vec, bool backward) {
  Plan q{};
  if (channels_last) {
    const int vpr = c / vec;
    q.rpb = vpr <= kRowThreads ? kRowThreads / vpr : 1;
    q.threads = vpr * q.rpb;
    q.smem = (backward && q.rpb > 1) ? 2 * q.rpb * c * (int)sizeof(float) : 0;
    const long long rows = n * hw;
    const long long per_block = (long long)q.rpb * kUnroll;
    const long long want = (rows + per_block - 1) / per_block;
    const long long cap = resident_blocks(kernel, q.threads, q.smem);
    q.grid = want < cap ? want : cap;
    if (q.grid < 1) q.grid = 1;
  } else {
    q.threads = kRowThreads;
    q.rpb = 1;
    q.chunk = (long long)kRowThreads * vec * kNchwChunkVecs;
    q.chunks = (int)((hw + q.chunk - 1) / q.chunk);
    q.grid = n * c * q.chunks;
  }
  return q;
}

// The number of rows of the backward's [G, 2, c] scratch.
long long partial_rows(const Plan& q, long long n, bool channels_last) {
  return channels_last ? q.grid : n * q.chunks;
}

// One instantiation's launches: run() of Forward, Backward and Rows, which
// dispatch() picks by dtype, vector width and ReLU.
template <typename T, int N, bool RELU>
struct Forward {
  static int run(const void* x, void* y, Params p, long long n, int c, long long hw, bool cl,
                 cudaStream_t stream) {
    if (cl) {
      auto kernel = forward_nhwc<T, N, RELU>;
      const Plan q = plan(kernel, n, c, hw, true, N, false);
      kernel<<<(unsigned)q.grid, q.threads, 0, stream>>>(static_cast<const T*>(x),
                                                        static_cast<T*>(y), p, n * hw, c, q.rpb);
    } else {
      auto kernel = forward_nchw<T, N, RELU>;
      const Plan q = plan(kernel, n, c, hw, false, N, false);
      kernel<<<(unsigned)q.grid, q.threads, 0, stream>>>(static_cast<const T*>(x),
                                                        static_cast<T*>(y), p, hw, c, q.chunks,
                                                        q.chunk);
    }
    return (int)cudaGetLastError();
  }
};

template <typename T, int N, bool RELU>
struct Rows {
  static long long run(long long n, int c, long long hw, bool cl) {
    if (cl) return partial_rows(plan(backward_nhwc<T, N, RELU>, n, c, hw, true, N, true), n, true);
    return partial_rows(plan(backward_nchw<T, N, RELU>, n, c, hw, false, N, true), n, false);
  }
};

template <typename T, int N, bool RELU>
struct Backward {
  static int run(const void* x, const void* dy, void* dx, void* partial, long long partial_n,
                 void* dweight, void* dbias, Params p, long long n, int c, long long hw, bool cl,
                 cudaStream_t stream) {
    if (Rows<T, N, RELU>::run(n, c, hw, cl) != partial_n) return (int)cudaErrorInvalidValue;
    if (cl) {
      auto kernel = backward_nhwc<T, N, RELU>;
      const Plan q = plan(kernel, n, c, hw, true, N, true);
      kernel<<<(unsigned)q.grid, q.threads, q.smem, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dx),
          static_cast<float*>(partial), p, n * hw, c, q.rpb);
    } else {
      auto kernel = backward_nchw<T, N, RELU>;
      const Plan q = plan(kernel, n, c, hw, false, N, true);
      kernel<<<(unsigned)q.grid, q.threads, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dx),
          static_cast<float*>(partial), p, hw, c, q.chunks, q.chunk);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    finalize<<<(c + 31) / 32, dim3(32, 32), 0, stream>>>(
        static_cast<const float*>(partial), partial_n, c, p, static_cast<float*>(dweight),
        static_cast<float*>(dbias));
    return (int)cudaGetLastError();
  }
};

// F<T, vec, relu>::run(args...) for the dtype, vector width (1 or 16 bytes)
// and ReLU asked for; `invalid` for a combination it does not take.
template <template <typename, int, bool> class F, typename R, typename... A>
R dispatch(R invalid, int is_bf16, int vec, int relu, A... args) {
  if (is_bf16) {
    if (vec == 8) return relu ? F<__nv_bfloat16, 8, true>::run(args...) : F<__nv_bfloat16, 8, false>::run(args...);
    if (vec == 1) return relu ? F<__nv_bfloat16, 1, true>::run(args...) : F<__nv_bfloat16, 1, false>::run(args...);
  } else {
    if (vec == 4) return relu ? F<float, 4, true>::run(args...) : F<float, 4, false>::run(args...);
    if (vec == 1) return relu ? F<float, 1, true>::run(args...) : F<float, 1, false>::run(args...);
  }
  return invalid;
}

}  // namespace

// x, y (and dy, dx): [n, c, h, w] of bf16 or f32, channels-last (channels_last
// = 1) or NCHW-contiguous; w, b, mean, var: [c] f32. vec: 1, or the elements
// of 16 bytes (8 bf16, 4 f32; then c, or h * w for NCHW, is a multiple of vec
// and the pointers are 16-byte aligned). Channels-last takes c / vec <= 512.
// Each returns a cudaError_t (0 on success).
extern "C" int frozen_bn_forward(const void* x, void* y, const void* w, const void* b,
                                 const void* mean, const void* var, float eps, long long n, int c,
                                 long long hw, int channels_last, int vec, int relu, int is_bf16,
                                 void* stream) {
  const Params p{static_cast<const float*>(w), static_cast<const float*>(b),
                 static_cast<const float*>(mean), static_cast<const float*>(var), eps};
  return dispatch<Forward>((int)cudaErrorInvalidValue, is_bf16, vec, relu, x, y, p, n, c, hw,
                           channels_last != 0, static_cast<cudaStream_t>(stream));
}

// The rows G of the [G, 2, c] f32 scratch that frozen_bn_backward takes for
// these arguments (-1 for arguments it does not take).
extern "C" long long frozen_bn_partial_rows(long long n, int c, long long hw, int channels_last,
                                            int vec, int relu, int is_bf16) {
  return dispatch<Rows>(-1LL, is_bf16, vec, relu, n, c, hw, channels_last != 0);
}

// dx in x's dtype and layout; dweight, dbias: [c] f32; partial: the [G, 2, c]
// f32 scratch, G from frozen_bn_partial_rows (every entry is written).
extern "C" int frozen_bn_backward(const void* x, const void* dy, void* dx, void* partial,
                                  long long partial_n, void* dweight, void* dbias, const void* w,
                                  const void* b, const void* mean, const void* var, float eps,
                                  long long n, int c, long long hw, int channels_last, int vec,
                                  int relu, int is_bf16, void* stream) {
  const Params p{static_cast<const float*>(w), static_cast<const float*>(b),
                 static_cast<const float*>(mean), static_cast<const float*>(var), eps};
  return dispatch<Backward>((int)cudaErrorInvalidValue, is_bf16, vec, relu, x, dy, dx, partial,
                            partial_n, dweight, dbias, p, n, c, hw, channels_last != 0,
                            static_cast<cudaStream_t>(stream));
}
