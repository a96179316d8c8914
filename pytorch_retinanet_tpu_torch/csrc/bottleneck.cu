// Fused identity bottleneck on the Hopper tensor cores (wgmma).
//
// Replaces pytorch_retinanet_tpu/kernels/bottleneck_pallas.py::fused_bottleneck
// (_bottleneck_kernel, pl.pallas_call at :270): one stride-1 identity ResNet
// bottleneck,
//   y1 = relu(x @ w1 * s1 + b1)            1x1, C -> mid
//   y2 = relu(conv3x3(y1, pad 1) * s2 + b2) 3x3, mid -> mid
//   out = relu(y2 @ w3 * s3 + b3 + x)      1x1, mid -> C
// on NHWC bf16, with f32 accumulation and epilogues, y1 and y2 rounded to
// bf16 and one bf16 rounding of the output. y1 is 0 at every halo position
// outside the image, so the 3x3 reads zero padding there. (The TPU kernel
// zero-pads the block's INPUT rows and runs conv1 over them, so above the
// first and below the last image row its 3x3 reads relu(b1): its output rows
// 0 and H-1 differ from the composition it fuses. That is not copied.)
//
// What bounds it on an H100: operations. A block at batch 32 does 34 * mid^2
// multiply-adds per pixel: 299.5 GFLOP at every R50 stage of the 800x1344
// bucket, 0.30 ms at the 989 TFLOP/s dense bf16 peak, against 1.10 GB of x
// and output at layer2 (0.33 ms at 3.35 TB/s), 0.55 GB at layer3 and 0.28 GB
// at layer4. The 10 fused blocks of an R50 forward: 3.11 ms.
//
// What held the earlier design back (one CTA of 8 warps per image and 8x8
// output tile, mma.sync fed by ldmatrix, 32-deep cp.async double buffers):
//   - every CTA streamed all 34 * mid^2 bytes of weights from L2 for 64
//     output pixels: 4.9 / 5.5 / 6.8 GB through L2 per block at mid 128 /
//     256 / 512 (8736 / 2464 / 768 CTAs at batch 32), against 1.10 / 0.55 /
//     0.28 GB of HBM traffic; conv1 restaged the x halo once per 128-channel
//     N chunk;
//   - each 32-deep K step ended in two __syncthreads with all 256 threads
//     copying, and at mid >= 256 one CTA filled the SM's shared memory, so
//     nothing hid the loads (1088 steps per CTA at mid 512);
//   - mma.sync cannot reach the dense rate that wgmma gives: ~13-15% of peak;
//   - 8x8 tiles over 25x42 (layer4) computed 1.46x the pixels.
//
// Design:
//   - One CTA per (image, TH x TW output tile): 10x12 at mid 128 and 256
//     (120 pixels in two m64 row tiles; 100x168 and 50x84 are covered 1.07x),
//     5x12 at mid 512 (60 pixels in one m64 tile; 25x42 is covered 1.14x,
//     1.22x in wgmma rows). Any H and W: the ragged edge is masked.
//   - 384 threads: warps 0-7 are two consumer warpgroups (224 registers each
//     after setmaxnreg), warps 8-11 the producer warpgroup (56). The producer
//     fills a ring of S slots (4 at mid 128 and 512, 3 at mid 256): for each
//     64-deep K step one 1-D bulk copy (cp.async.bulk ...
//     mbarrier::complete_tx) of the step's weight tile; in conv1 also the
//     step's 64 channels of the x halo, and after each conv3 chunk that
//     chunk's residual rows, by cp.async from all 128 producer threads. At
//     the start it prefetches the tile's x halo from HBM into L2 (one bulk
//     prefetch per image row). Each slot has a "full" mbarrier (one arrive
//     with the byte count, plus one cp.async arrive per producer thread) and
//     an "empty" one (one arrive per consumer warp once its wgmma have
//     completed). No __syncthreads in the K loops. With 4 slots a warpgroup
//     keeps one wgmma group in flight across K steps (wait_group 1); with 3
//     it waits for each, so that the producer keeps two slots in flight.
//   - The wrapper packs w1, w2 and w3 once per call (kernels/bottleneck.py
//     pack_bottleneck_weights) into the producer's order, each tile N rows of
//     64 K values (128 bytes) with the 128-byte swizzle already applied, so a
//     tile is one contiguous copy that lands in the layout the wgmma matrix
//     descriptor reads (K-major, SWIZZLE_128B, 8-row groups 1024 bytes apart).
//   - conv1 (M = the halo padded to 64 rows, K = C, N = mid in 128-channel
//     chunks): wgmma with A (the x halo) and B from the slot. With two halo
//     m64 tiles (mid 512) the warpgroups split them (n128); with three they
//     split N (n64 over all three), so that no wgmma sits on a branch. y1
//     lands in shared memory as bf16 (same swizzle), 0 outside the image.
//   - conv2 (M = the tile's pixels, K = 9 taps x mid, N = mid): wgmma with A
//     from registers: each lane hands ldmatrix the y1 row of its own output
//     pixel shifted by the tap (no im2col), B from the slot. At mid 128 and
//     256 the warpgroups split M (one m64 tile each, N = mid); at mid 512
//     they split N (256 channels each, a K step spans two slots). All of N
//     at once, so y1 is dead afterwards and y2 overwrites it.
//   - conv3 (M = the pixels, K = mid, N = C in 256-channel chunks): wgmma with
//     A (y2) and B from shared memory; split M at mid 128 and 256 (n256),
//     split N at mid 512 (n128). The epilogue reads the residual from its
//     slot, writes each output over its residual, and the warpgroup then
//     copies whole rows out, 16 bytes a lane.
//   - Epilogues round like the plain version: y * s, + b and + x each
//     rounded in f32, one bf16 rounding.
//   - Weight bytes through L2 per block at batch 32: 4480 / 1120 / 640 CTAs
//     x 34 mid^2 = 2.5 / 2.5 / 5.7 GB at mid 128 / 256 / 512.
//   - A 2-CTA cluster multicasting each weight tile into both CTAs' slots was
//     built and measured slower at every stage (PERF.md): the ring's depth,
//     not L2's bandwidth, limits the weight supply, so it is not kept.
//   - An optional phase trace (Params::trace) records per CTA when conv1,
//     conv2 and conv3 end, the epilogues' time and the cycles spent waiting
//     for slots (tools/torch_bottleneck_stages.py prints it).
//
// Shared memory (bytes), from a 1024-aligned base: y1 (later y2) + S slots
// + 2 S mbarriers:
//   mid 128: y1 2 x 168 rows x 128 = 43008, slots 4 x 40960 (x halo 24576 +
//            w1 tile 16384; conv2 16384; conv3 32768; residual 32768): 206912;
//   mid 256: y1 86016, slots 3 x 40960: 208944;
//   mid 512: y1 8 x 98 rows x 128 = 100352, slots 4 x 32768 (x halo 16384 +
//            w1 tile 16384; conv2, conv3 and residual 32768): 231488.
// One CTA per SM at every width.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kConsumers = 256;             // two consumer warpgroups, warps 0-7
constexpr int kThreads = kConsumers + 128;  // plus the producer warpgroup, warps 8-11
// Registers after setmaxnreg: the producer gives up what the consumers take
// (384 x 168 at launch = 128 x 56 + 256 x 224).
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
constexpr int kSmemLimit = 232448;

constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int MID>
struct Tile;
template <>
struct Tile<128> { static constexpr int TH = 10, TW = 12, S = 4; };
template <>
struct Tile<256> { static constexpr int TH = 10, TW = 12, S = 3; };
template <>
struct Tile<512> { static constexpr int TH = 5, TW = 12, S = 4; };

template <int MID>
struct Geo {
  static constexpr int TH = Tile<MID>::TH, TW = Tile<MID>::TW, S = Tile<MID>::S;
  static constexpr int C = 4 * MID;
  static constexpr int HW = TW + 2, HALO = (TH + 2) * HW;
  static constexpr int P = TH * TW;
  static constexpr int MT = (P + 63) / 64;      // m64 row tiles of conv2 and conv3
  static constexpr int MT1 = (HALO + 63) / 64;  // of conv1
  static constexpr int HRS = HALO;               // y1 rows kept
  static constexpr int KB = MID / 64;           // 64-channel blocks of mid
  static constexpr int N1 = 128;                // conv1 N chunk, 64 per warpgroup
  static constexpr bool SPLIT_M = MT == 2;      // conv2 and conv3: warpgroups split M, else N
  static constexpr int N2 = SPLIT_M ? MID : 256;  // conv2: N of a slot and of a warpgroup
  static constexpr int SLOTS2 = SPLIT_M ? 1 : 2;  // slots per conv2 K step
  static constexpr int N3 = 256;                  // conv3: N of a slot
  static constexpr int N3W = SPLIT_M ? 256 : 128;  // conv3: N of a warpgroup
  static constexpr int RES_SLOTS = SPLIT_M ? 2 : 1;  // residual slots per conv3 chunk
  static constexpr int XTILE = MT1 * 64 * 128;     // conv1's x halo in a slot
  static constexpr int SLOT = cmax(XTILE + N1 * 128, cmax(N2 * 128, N3 * 128));
  static_assert(64 * N3 * 2 <= SLOT, "a residual slot holds 64 rows of a conv3 chunk");
  static constexpr int Y1 = KB * HRS * 128;
  static constexpr int Y2 = KB * MT * 64 * 128;
  static constexpr int SMEM = Y1 + S * SLOT + 2 * S * 8;
  static_assert(MT <= 2 && (SPLIT_M || MT == 1), "two warpgroups cover at most two m64 tiles");
  static_assert(Y2 <= Y1 && Y1 % 1024 == 0 && SLOT % 1024 == 0 && XTILE % 1024 == 0, "layout");
  static_assert(SMEM <= kSmemLimit, "shared memory");
};

struct Params {
  const bf16* x;
  const bf16* wpack;  // w1, w2, w3 tiles in the producer's order (pack_bottleneck_weights)
  const float* s1;
  const float* b1;
  const float* s2;
  const float* b2;
  const float* s3;
  const float* b3;
  bf16* out;
  unsigned long long* trace;  // null, or kTrace values per CTA (see the kernel)
  int h, w, tiles_w, tiles;  // tile columns, tiles per image
};

constexpr int kTrace = 11;

template <int S>
struct Ring {
  int slot = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++slot == S) {
      slot = 0;
      phase ^= 1;
    }
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of the given parity to complete. A wait that outlasts
// 2^32 cycles (about 2 s) can only be a fault in the slot schedule: trap, so
// that the launch reports an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity)) {
    if (clock64() - t0 > (1ll << 32)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// One contiguous global -> shared copy that completes `bytes` on the mbarrier.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}


__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Barrier of one consumer warpgroup's 128 threads.
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

__device__ __forceinline__ void bulk_prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

// Arrive on the mbarrier once this thread's earlier cp.async have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier of the 256 consumer threads alone (the producer warp keeps going).
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

__device__ __forceinline__ void ldsm_x4(unsigned* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Matrix descriptor of a K-major tile with the 128-byte swizzle: rows of 64
// bf16 (128 bytes), 8-row groups 1024 bytes apart, the tile 1024-aligned; a
// k16 step within the 64 advances the start by 32 bytes.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across wgmma.
template <int N>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Keep an A fragment's registers live (unchanged) up to this point: the
// wgmma group that reads them has completed only here.
__device__ __forceinline__ void fence_frag(unsigned (&a)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

// wgmma.mma_async m64nNk16, bf16 in, f32 accumulate (d += a * b): "ss" reads
// A and B through descriptors, "rs" takes A from registers (the m16n8k16
// A fragment of the warp's 16 rows) and B through a descriptor.
__device__ __forceinline__ void wgmma_ss_n64(float* d, const uint64_t da, const uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n128(float* d, const uint64_t da, const uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n256(float* d, const uint64_t da, const uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float* d, const unsigned* a, const uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n256(float* d, const unsigned* a, const uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int N>
__device__ __forceinline__ void mma_ss(float* d, uint64_t a, uint64_t b);
template <>
__device__ __forceinline__ void mma_ss<64>(float* d, uint64_t a, uint64_t b) { wgmma_ss_n64(d, a, b); }
template <>
__device__ __forceinline__ void mma_ss<128>(float* d, uint64_t a, uint64_t b) { wgmma_ss_n128(d, a, b); }
template <>
__device__ __forceinline__ void mma_ss<256>(float* d, uint64_t a, uint64_t b) { wgmma_ss_n256(d, a, b); }

template <int N>
__device__ __forceinline__ void mma_rs(float* d, const unsigned* a, uint64_t b);
template <>
__device__ __forceinline__ void mma_rs<128>(float* d, const unsigned* a, uint64_t b) { wgmma_rs_n128(d, a, b); }
template <>
__device__ __forceinline__ void mma_rs<256>(float* d, const unsigned* a, uint64_t b) { wgmma_rs_n256(d, a, b); }

__device__ __forceinline__ float bn(float acc, float s, float b) {
  return __fadd_rn(__fmul_rn(acc, s), b);
}

__device__ __forceinline__ __nv_bfloat162 pack(float lo, float hi) {
  __nv_bfloat162 v;
  v.x = __float2bfloat16_rn(lo);
  v.y = __float2bfloat16_rn(hi);
  return v;
}

// Byte offset of (row, col) in a [mid / 64][rows][128 B] tile with the
// 128-byte swizzle: the 16-byte chunk c of a row sits at c ^ (row % 8).
__device__ __forceinline__ uint32_t swz(int rows, int row, int col) {
  return (col >> 6) * rows * 128 + row * 128 + (((((col & 63) >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

template <int MID>
__global__ void __launch_bounds__(kThreads, 1) bottleneck_kernel(Params p) {
  using G = Geo<MID>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ys = raw;  // y1, later y2
  unsigned char* ysg = smem_raw;
  const uint32_t slots = ys + G::Y1;
  const uint32_t full = slots + G::S * G::SLOT;
  const uint32_t empty = full + G::S * 8;
  const int tid = threadIdx.x;
  if (tid == 0) {
    // The swizzled tiles need a 1024-aligned base, which the dynamic shared
    // memory of a CTA has on this card (its 1 KB reserved part comes first).
    if ((raw & 1023) != 0) __trap();
    for (int s = 0; s < G::S; ++s) {
      mbar_init(full + 8 * s, 129);  // the producer's arrive (with the byte count) + 128 cp.async arrives
      mbar_init(empty + 8 * s, 8);   // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int tile = blockIdx.x % p.tiles;
  const int h0 = (tile / p.tiles_w) * G::TH, w0 = (tile % p.tiles_w) * G::TW;
  const size_t img = (size_t)(blockIdx.x / p.tiles) * p.h * p.w * G::C;
  const bf16* xb = p.x + img;
  const int lane = tid & 31;
  Ring<G::S> q;

  if (tid >= kConsumers) {
    // ---- producer warpgroup: weight tiles by bulk copy, conv1's x halo by cp.async ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int ptid = tid - kConsumers;
    const unsigned char* src = reinterpret_cast<const unsigned char*>(p.wpack);
    auto begin = [&](uint32_t bytes, uint32_t offset) {
      mbar_wait(empty + 8 * q.slot, q.phase ^ 1);
      const uint32_t sb = slots + q.slot * G::SLOT;
      if (ptid == 0 && bytes == 0) {
        mbar_arrive(full + 8 * q.slot);
      } else if (ptid == 0) {
        mbar_expect_tx(full + 8 * q.slot, bytes);
        bulk_copy(sb + offset, src, bytes, full + 8 * q.slot);
      }
      src += bytes;
      return sb;
    };
    auto end = [&]() {
      cp_async_arrive(full + 8 * q.slot);
      q.next();
    };
    // Bring the tile's x halo from HBM into L2 at once, one bulk prefetch per
    // image row of it: conv1's slots then copy it from L2.
    if (ptid < G::TH + 2) {
      const int hh = h0 - 1 + ptid, wa = max(w0 - 1, 0), wb = min(w0 + G::TW + 1, p.w);
      if (hh >= 0 && hh < p.h && wb > wa) {
        bulk_prefetch_l2(xb + ((size_t)hh * p.w + wa) * G::C, (uint32_t)(wb - wa) * G::C * 2);
      }
    }
    for (int n0 = 0; n0 < MID; n0 += G::N1) {
      for (int k0 = 0; k0 < G::C; k0 += 64) {
        const uint32_t sb = begin(G::N1 * 128, G::XTILE);
        for (int i = ptid; i < G::HALO * 8; i += 128) {
          const int r = i >> 3, c16 = i & 7;
          const int hh = h0 - 1 + r / G::HW, ww = w0 - 1 + r % G::HW;
          if (hh >= 0 && hh < p.h && ww >= 0 && ww < p.w) {
            cp_async16(sb + r * 128 + ((c16 ^ (r & 7)) << 4),
                       xb + ((size_t)hh * p.w + ww) * G::C + k0 + c16 * 8);
          }
        }
        end();
      }
    }
    for (int s = 0; s < 9 * G::KB * G::SLOTS2; ++s) {
      begin(G::N2 * 128, 0);
      end();
    }
    for (int n0 = 0; n0 < G::C; n0 += G::N3) {
      for (int b = 0; b < G::KB; ++b) {
        begin(G::N3 * 128, 0);
        end();
      }
      // The chunk's residual, 64 pixel rows x N3 columns per slot, each row's
      // 16-byte chunk c at c ^ (row % 8) within its 128 bytes.
      for (int m = 0; m < G::RES_SLOTS; ++m) {
        const uint32_t sb = begin(0, 0);
        for (int i = ptid; i < 64 * (G::N3 / 8); i += 128) {
          const int r = i / (G::N3 / 8), c16 = i % (G::N3 / 8);
          const int px = m * 64 + r;
          const int hh = h0 + px / G::TW, ww = w0 + px % G::TW;
          if (px < G::P && hh < p.h && ww < p.w) {
            cp_async16(sb + r * (G::N3 * 2) + ((c16 & ~7) << 4) + (((c16 ^ r) & 7) << 4),
                       xb + ((size_t)hh * p.w + ww) * G::C + n0 + c16 * 8);
          }
        }
        end();
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = tid >> 7, warp = (tid >> 5) & 3;
  const int g = lane >> 2, t4 = lane & 3;
  // Optional phase trace (p.trace not null), by consumer thread 0: global
  // timer stamps [0] start, [1] conv1 done, [2] conv2's wgmma done, [3] y2
  // written, [4] end; [5] cycles spent waiting for full slots, [6] of them in
  // conv1; [7] the SM; [8] ns in conv3's epilogues, [9] in conv1's; [10]
  // the CTA's cycles.
  const bool tracing = p.trace != nullptr && tid == 0;
  unsigned long long* trace = tracing ? p.trace + (size_t)blockIdx.x * kTrace : nullptr;
  long long stall = 0;
  unsigned long long epi_ns = 0;
  auto wait_full = [&](int slot, uint32_t phase) {
    const long long t0 = tracing ? clock64() : 0;
    mbar_wait(full + 8 * slot, phase);
    if (tracing) stall += clock64() - t0;
  };
  const long long cycles0 = tracing ? clock64() : 0;
  if (tracing) trace[0] = global_ns();
  auto release = [&](int slot) {
    if (lane == 0) mbar_arrive(empty + 8 * slot);
  };
  // After a K step's wgmma group is committed: with 4 slots, keep it running
  // and free the previous step's slot once that step's group has completed;
  // with 3, wait for it and free its slot at once, so that the producer keeps
  // two slots in flight. `held` is the slot still in use (-1: none).
  auto consumed = [&](int& held) {
    if (G::S >= 4) {
      wg_wait<1>();
      if (held >= 0) release(held);
      held = q.slot;
    } else {
      wg_wait<0>();
      release(q.slot);
    }
    q.next();
  };
  auto drained = [&](int held) {
    if (G::S >= 4) {
      wg_wait<0>();
      release(held);
    }
  };

  // conv1 over the halo: y1 = relu(x_halo @ w1 * s1 + b1), 0 outside the image.
  // With an even number of halo m64 tiles the warpgroups split them (n128
  // each); with an odd number they split N (n64 over every tile), so that no
  // wgmma sits on a branch.
  {
    constexpr bool kSplitM = G::MT1 % 2 == 0;
    constexpr int NW = kSplitM ? G::N1 : G::N1 / 2, MW = kSplitM ? G::MT1 / 2 : G::MT1;
    const int ncol1 = kSplitM ? 0 : wg * NW;
    for (int n0 = 0; n0 < MID; n0 += G::N1) {
      float acc[MW][NW / 2];
#pragma unroll
      for (int i = 0; i < MW; ++i) {
#pragma unroll
        for (int e = 0; e < NW / 2; ++e) acc[i][e] = 0.0f;
        fence_acc<NW / 2>(acc[i]);
      }
      int held = -1;  // the slot whose wgmma group may still run
      for (int k0 = 0; k0 < G::C; k0 += 64) {
        wait_full(q.slot, q.phase);
        fence_async_smem();  // the x halo arrived through cp.async
        const uint32_t sb = slots + q.slot * G::SLOT;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t db = desc(sb + G::XTILE + ncol1 * 128 + kk * 32);
#pragma unroll
          for (int i = 0; i < MW; ++i) {
            const int m = kSplitM ? 2 * i + wg : i;
            mma_ss<NW>(acc[i], desc(sb + m * 8192 + kk * 32), db);
          }
        }
        wg_commit();
        consumed(held);
      }
      drained(held);
      const unsigned long long e0 = tracing ? global_ns() : 0;
#pragma unroll
      for (int i = 0; i < MW; ++i) {
        fence_acc<NW / 2>(acc[i]);
        const int m = kSplitM ? 2 * i + wg : i;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = m * 64 + warp * 16 + g + half * 8;
          if (r >= G::HALO) continue;
          const int hh = h0 - 1 + r / G::HW, ww = w0 - 1 + r % G::HW;
          const bool inside = hh >= 0 && hh < p.h && ww >= 0 && ww < p.w;
#pragma unroll
          for (int jj = 0; jj < NW / 8; ++jj) {
            const int col = n0 + ncol1 + jj * 8 + t4 * 2;
            float v0 = 0.0f, v1 = 0.0f;
            if (inside) {
              const float2 sc = __ldg(reinterpret_cast<const float2*>(p.s1 + col));
              const float2 bi = __ldg(reinterpret_cast<const float2*>(p.b1 + col));
              v0 = fmaxf(bn(acc[i][jj * 4 + half * 2], sc.x, bi.x), 0.0f);
              v1 = fmaxf(bn(acc[i][jj * 4 + half * 2 + 1], sc.y, bi.y), 0.0f);
            }
            *reinterpret_cast<__nv_bfloat162*>(ysg + swz(G::HRS, r, col)) = pack(v0, v1);
          }
        }
      }
      if (tracing) epi_ns += global_ns() - e0;
    }
  }
  if (tracing) {
    trace[1] = global_ns();
    trace[6] = stall;
    trace[9] = epi_ns;
    epi_ns = 0;
  }
  consumers_sync();

  // conv2: y2 = relu(sum_taps y1[pixel + tap] @ w2[tap] * s2 + b2), then y2
  // overwrites y1.
  {
    constexpr int NW = G::N2;
    const int mt = G::SPLIT_M ? wg : 0;
    float acc[NW / 2];
#pragma unroll
    for (int e = 0; e < NW / 2; ++e) acc[e] = 0.0f;
    fence_acc<NW / 2>(acc);
    int px = mt * 64 + warp * 16 + (lane & 15);  // this lane's ldmatrix row
    if (px >= G::P) px = 0;                      // a padding row: any valid pixel
    const int hrow = (px / G::TW) * G::HW + px % G::TW;
    const int kc = lane >> 4;
    // Steps in pairs, so that each has its own A fragment: with 4 slots (mid
    // 128) a step's group runs on while the next step issues (its slot and
    // its fragment are freed one step later); with 3 every step waits, as
    // `consumed` does.
    constexpr bool kOverlap = G::SLOTS2 == 1 && G::S >= 4;
    static_assert((9 * G::KB) % 2 == 0, "steps in pairs");
    unsigned a[2][4][4];
    int held = -1;
    for (int st0 = 0; st0 < 9 * G::KB; st0 += 2) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int st = st0 + u, tap = st / G::KB, b = st - tap * G::KB;
        const int row = hrow + (tap / 3) * G::HW + tap % 3;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          ldsm_x4(a[u][kk], ys + b * G::HRS * 128 + row * 128 + ((((kk * 2 + kc) ^ row) & 7) << 4));
        }
        wait_full(q.slot, q.phase);
        int mine = q.slot;
        if (G::SLOTS2 == 2) {
          Ring<G::S> q2 = q;
          q2.next();
          wait_full(q2.slot, q2.phase);
          if (wg) mine = q2.slot;
        }
        const uint32_t sb = slots + mine * G::SLOT;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) mma_rs<NW>(acc, a[u][kk], desc(sb + kk * 32));
        wg_commit();
        if (kOverlap) {
          wg_wait<1>();
          fence_frag(a[u ^ 1]);
          if (held >= 0) release(held);
          held = q.slot;
          q.next();
        } else {
          wg_wait<0>();
#pragma unroll
          for (int s = 0; s < G::SLOTS2; ++s) {
            release(q.slot);
            q.next();
          }
        }
      }
    }
    if (kOverlap) {
      wg_wait<0>();
      release(held);
    }
    fence_acc<NW / 2>(acc);
    if (tracing) trace[2] = global_ns();
    consumers_sync();  // both warpgroups are done reading y1
    const int ncol0 = G::SPLIT_M ? 0 : wg * NW;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = mt * 64 + warp * 16 + g + half * 8;
#pragma unroll
      for (int jj = 0; jj < NW / 8; ++jj) {
        const int col = ncol0 + jj * 8 + t4 * 2;
        const float2 sc = __ldg(reinterpret_cast<const float2*>(p.s2 + col));
        const float2 bi = __ldg(reinterpret_cast<const float2*>(p.b2 + col));
        const float v0 = fmaxf(bn(acc[jj * 4 + half * 2], sc.x, bi.x), 0.0f);
        const float v1 = fmaxf(bn(acc[jj * 4 + half * 2 + 1], sc.y, bi.y), 0.0f);
        *reinterpret_cast<__nv_bfloat162*>(ysg + swz(G::MT * 64, r, col)) = pack(v0, v1);
      }
    }
    fence_async_smem();  // y2 is read next through wgmma descriptors
    consumers_sync();
    if (tracing) trace[3] = global_ns();
  }

  // conv3 + residual: out = relu(y2 @ w3 * s3 + b3 + x).
  {
    constexpr int NW = G::N3W;
    const int mt = G::SPLIT_M ? wg : 0;
    const int ncol0 = G::SPLIT_M ? 0 : wg * NW;
    bf16* ob = p.out + img;
    for (int n0 = 0; n0 < G::C; n0 += G::N3) {
      float acc[NW / 2];
#pragma unroll
      for (int e = 0; e < NW / 2; ++e) acc[e] = 0.0f;
      fence_acc<NW / 2>(acc);
      int held = -1;
      for (int b = 0; b < G::KB; ++b) {
        wait_full(q.slot, q.phase);
        const uint32_t sb = slots + q.slot * G::SLOT;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          mma_ss<NW>(acc, desc(ys + (b * G::MT + mt) * 8192 + kk * 32), desc(sb + ncol0 * 128 + kk * 32));
        }
        wg_commit();
        consumed(held);
      }
      drained(held);
      fence_acc<NW / 2>(acc);
      // The residual: the chunk's columns of this warpgroup's m64 rows, which
      // the producer copied into the next slot (two slots, one per warpgroup,
      // when the warpgroups split M).
      wait_full(q.slot, q.phase);
      int rslot = q.slot;
      if (G::RES_SLOTS == 2) {
        Ring<G::S> q2 = q;
        q2.next();
        wait_full(q2.slot, q2.phase);
        if (wg) rslot = q2.slot;
      }
      unsigned char* res = smem_raw + (slots + rslot * G::SLOT - raw);
      const unsigned long long e0 = tracing ? global_ns() : 0;
      bool ok[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int px = mt * 64 + warp * 16 + g + half * 8;
        const int hh = h0 + px / G::TW, ww = w0 + px % G::TW;
        ok[half] = px < G::P && hh < p.h && ww < p.w;
      }
#pragma unroll
      for (int j0 = 0; j0 < NW / 8; j0 += 8) {
        float2 sc[8], bi[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = n0 + ncol0 + (j0 + j) * 8 + t4 * 2;
          sc[j] = __ldg(reinterpret_cast<const float2*>(p.s3 + col));
          bi[j] = __ldg(reinterpret_cast<const float2*>(p.b3 + col));
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (!ok[half]) continue;
          const int r = warp * 16 + g + half * 8;  // row in the residual slot
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = ncol0 + (j0 + j) * 8 + t4 * 2, e = (j0 + j) * 4 + half * 2;
            __nv_bfloat162* xr = reinterpret_cast<__nv_bfloat162*>(
                res + r * (G::N3 * 2) + ((((c >> 3) ^ r) & 7) << 4) + ((c >> 6) << 7) + (c & 7) * 2);
            const float v0 = fmaxf(__fadd_rn(bn(acc[e], sc[j].x, bi[j].x), __bfloat162float(xr->x)), 0.0f);
            const float v1 = fmaxf(__fadd_rn(bn(acc[e + 1], sc[j].y, bi[j].y), __bfloat162float(xr->y)), 0.0f);
            *xr = pack(v0, v1);  // the output takes its residual's place
          }
        }
      }
      // Copy this warpgroup's outputs out of the slot, 16 bytes a lane: each
      // warp writes whole 512-byte (or 256-byte) runs of a pixel's channels.
      warpgroup_sync(wg);
      for (int i = tid & 127; i < 64 * (NW / 8); i += 128) {
        const int r = i / (NW / 8), c16 = ncol0 / 8 + i % (NW / 8);
        const int px_r = mt * 64 + r;
        const int hh = h0 + px_r / G::TW, ww = w0 + px_r % G::TW;
        if (px_r < G::P && hh < p.h && ww < p.w) {
          *reinterpret_cast<uint4*>(ob + ((size_t)hh * p.w + ww) * G::C + n0 + c16 * 8) =
              *reinterpret_cast<const uint4*>(res + r * (G::N3 * 2) + ((c16 & ~7) << 4) + (((c16 ^ r) & 7) << 4));
        }
      }
      __syncwarp();  // every lane's reads of the slot are done
#pragma unroll
      for (int s = 0; s < G::RES_SLOTS; ++s) {
        release(q.slot);
        q.next();
      }
      if (tracing) epi_ns += global_ns() - e0;
    }
  }
  if (tracing) {
    unsigned smid;
    asm volatile("mov.u32 %0, %%smid;\n" : "=r"(smid));
    trace[4] = global_ns();
    trace[5] = stall;
    trace[7] = smid;
    trace[8] = epi_ns;
    trace[10] = clock64() - cycles0;
  }
}

template <int MID>
Params make_params(const Params& p0) {
  Params p = p0;
  p.tiles_w = (p.w + Geo<MID>::TW - 1) / Geo<MID>::TW;
  p.tiles = ((p.h + Geo<MID>::TH - 1) / Geo<MID>::TH) * p.tiles_w;
  return p;
}

template <int MID>
int launch(const Params& p0, int batch, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(bottleneck_kernel<MID>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Geo<MID>::SMEM);
  if (err != cudaSuccess) return (int)err;
  const Params p = make_params<MID>(p0);
  bottleneck_kernel<MID><<<batch * p.tiles, kThreads, Geo<MID>::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int MID>
int config(int h, int w, int batch, int* out) {
  using G = Geo<MID>;
  cudaError_t err = cudaFuncSetAttribute(bottleneck_kernel<MID>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return (int)err;
  Params p{};
  p.h = h;
  p.w = w;
  p = make_params<MID>(p);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bottleneck_kernel<MID>, kThreads, G::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int vals[9] = {G::TH, G::TW, 1, batch * p.tiles, G::SMEM, per_sm, G::S, G::SLOT, kThreads};
  for (int i = 0; i < 9; ++i) out[i] = vals[i];
  return 0;
}

}  // namespace

// x, out [B, H, W, C] bf16 NHWC; wpack the w1, w2, w3 tiles as
// pack_bottleneck_weights lays them out (34 * mid^2 bytes); s1, b1, s2, b2
// [mid] and s3, b3 [C] f32. Every pointer 16-byte aligned; mid 128, 256 or
// 512, C == 4 * mid; trace null, or kTrace (11) uint64 per CTA for the phase
// trace. Returns the cudaError_t of the launch (0 on success).
extern "C" int bottleneck_forward(const void* x, const void* wpack, const void* s1, const void* b1,
                                  const void* s2, const void* b2, const void* s3, const void* b3,
                                  void* out, int batch, int h, int w, int c, int mid, void* trace,
                                  void* stream) {
  if (c != 4 * mid) return (int)cudaErrorInvalidValue;
  Params p{};
  p.x = static_cast<const bf16*>(x);
  p.wpack = static_cast<const bf16*>(wpack);
  p.s1 = static_cast<const float*>(s1);
  p.b1 = static_cast<const float*>(b1);
  p.s2 = static_cast<const float*>(s2);
  p.b2 = static_cast<const float*>(b2);
  p.s3 = static_cast<const float*>(s3);
  p.b3 = static_cast<const float*>(b3);
  p.out = static_cast<bf16*>(out);
  p.trace = static_cast<unsigned long long*>(trace);
  p.h = h;
  p.w = w;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mid) {
    case 128: return launch<128>(p, batch, st);
    case 256: return launch<256>(p, batch, st);
    case 512: return launch<512>(p, batch, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The launch configuration the kernel takes at mid for a [batch, h, w, 4 mid]
// input: out[0..8] = tile rows, tile columns, cluster size (1), CTAs,
// dynamic shared memory bytes, CTAs per SM, ring slots, slot bytes, threads.
extern "C" int bottleneck_config(int mid, int h, int w, int batch, int* out) {
  switch (mid) {
    case 128: return config<128>(h, w, batch, out);
    case 256: return config<256>(h, w, batch, out);
    case 512: return config<512>(h, w, batch, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
