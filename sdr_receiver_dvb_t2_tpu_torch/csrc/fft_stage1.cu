// FFT stage 1 fused with the twiddle, for Hopper (sm_90a): the port of the
// TPU kernel `s1_kernel` of tools/fft_microbench.py:147 (K6).
//
// A length n = n1*n2 FFT splits (Cooley-Tukey) into a DFT-n1 over the rows
// of each symbol reshaped to (n1, n2), a twiddle, and a DFT-n2 over the
// columns.  This kernel does the first two for every symbol:
//
//   a = W1^T . y      complex (n1 x n1) . (n1 x n2), as four real bf16
//                     products accumulated in f32
//   b = a * tw        complex elementwise in f32
//   out = bf16(b)     the only rounding to bf16
//
// y_r, y_i, out_r, out_i are (n_sym, n1, n2) bf16.  a_r and a_i are never
// rounded to bf16 and never leave the registers.
//
// What bounds it on the H100: at n = 32768 (256 x 128), F=32 frames of 60
// symbols, it moves 503 MB (read y, write b: 0.150 ms at 3.35 TB/s) and
// does 129 GFLOP on the tensor cores (4 real products of 2*256*256*128 per
// symbol: 0.130 ms at 989 TFLOP/s).  Memory and tensor cores nearly tie, so
// the loads have to run while the products do, and W1^T (256 KB with both
// planes) must not come through L2 again for every symbol.
//
// Design.  The GEMM view per symbol: M = k1 (rows of W1^T), K = n1, N = n2.
//   a_r = Wr.yr + (-1)(Wi.yi)      a_i = Wr.yi + Wi.yr
// (the -1 is the negate-A immediate of `wgmma`, exact), so one thread holds
// a_r and a_i of the same (k1, column) and the twiddle is a register
// epilogue.
//  - W1^T is cut into bands of BAND = 64 rows of k1 (the `wgmma` M); n1 =
//    32 pads its one band with zero rows, which are never stored.  Each
//    persistent CTA holds C bands (C = 2 consumer warpgroups where n1 >=
//    128, else 1) of both planes resident in shared memory, loaded once by
//    bulk copies from the packed table (`ops/fft_stage1.pack_tables`: 64 x
//    64 blocks, pre-swizzled to the 128-byte K-major layout `wgmma` reads).
//    At n1 = 256 that is 128 KB, and the two band groups of CTAs walk the
//    work items in step, so both CTAs of an item read its y tile at about
//    the same time: HBM serves it once, L2 the second time.
//  - A work item is (symbol, tile of BN = 64 columns; 32 where n2 = 32).
//    Its y arrives through a ring of `stages` shared-memory slots, each one
//    K-chunk (BK = min(n1, 64) rows of n1) of both planes, loaded by TMA
//    (`cp.async.bulk.tensor`, 2*BN-byte swizzle) by one producer thread and
//    completed on a "full" mbarrier; every consumer warp arrives on the
//    slot's "empty" mbarrier when its `wgmma` reads of the slot are done.
//  - Each consumer warpgroup runs `wgmma.mma_async` m64nBNk16 (bf16 in, f32
//    accumulators) with A from its W band and B straight from the ring slot
//    (n2 contiguous: the transpose bit, MN-major), two accumulators of BN/2
//    registers each.  One chunk's products stay in flight while the slot of
//    the chunk before is released.
//  - The item's twiddle (packed in the accumulators' own order, one 16-byte
//    load per 8 columns) is loaded into registers before the products, so
//    its latency hides behind them.  The epilogue multiplies and adds in f32
//    one operation at a time (the build has --fmad=false), rounds to bf16
//    pairs into the warpgroup's output tile in shared memory (in the TMA
//    box's swizzle: no bank conflicts), and one thread stores each plane's
//    tile with a TMA store that runs on while the next item's products do.
//
// Measured (K6 at (32, 60, 32768), NVIDIA H100 80GB HBM3, 700 W): this
// design 0.23-0.27 ms.  Builds of it that are no longer kept timed its
// parts: the loads and ring alone 0.10-0.12 ms, loads and products without
// the epilogue 0.19-0.21 ms.  Dropped: 128-column items with the output
// stored from the accumulator registers as 4-byte pairs, 0.40-0.42 ms,
// ~0.22 ms of it those scattered stores; W1^T fragments loaded to registers
// by ldmatrix, each read by two products (less shared-memory traffic),
// 0.515 ms; one consumer warpgroup and band per CTA, 0.32-0.49 ms with 4 or
// 8 stages; a 2-stage ring 0.36-0.39 ms; ping-pong (one band per CTA, its
// two warpgroups taking items in turns, each with its own "full" barriers)
// 0.25-0.27 ms; a run-time guard around the products, which made ptxas
// inject warpgroup.arrive (C7519) and cost ~30 registers.
//
// Built with -DK6_PROFILE (`tools/fft_microbench.k6_profile`), thread 0 of
// every consumer warpgroup sums the cycles it spends waiting for its W1^T
// bands, waiting on the ring's "full" barriers, in the rest of the product
// loop, and in the epilogue, and adds them to g_prof when it ends; the
// output is computed as in the regular build.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#ifdef K6_PROFILE
// cycles summed over the consumer warpgroups: W1^T wait, ring waits, the
// rest of the product loop, epilogue, whole run; and the items they took
__device__ unsigned long long g_prof[6];
#endif

constexpr int MAX_STAGES = 4;            // ring depth, fewer where shared
                                         // memory is short (`make_plan`)
constexpr int BAND = 64;                 // k1 rows per band: the wgmma M
constexpr int KCH = 64;                  // n1 values per W1^T block row
constexpr int W_BLOCK = BAND * KCH * 2;  // bytes of one swizzled W block
constexpr int SMEM_LIMIT = 232448;       // dynamic shared memory of a CTA
constexpr int ALIGN = 1024;              // the 128-byte swizzle's period

// error codes of the C interface besides cudaError_t's
constexpr int ERR_NO_ENCODE = -1;
constexpr int ERR_ENCODE = -2;
constexpr int ERR_SMEM = -3;

struct Params {
  const uint8_t* w;      // packed W1^T bands (`pack_tables`)
  const uint4* tw;       // packed twiddle, one uint4 per thread and 8 columns
  int n_sym, n1, n2;
  int groups;            // band groups: CTAs of group g hold bands g*C..
  int kc;                // chunks per item (= W blocks per band and plane)
  int stages;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// waits for the phase of `parity` to complete; a phase that never completes
// (a fault of the ring's bookkeeping) traps instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, spins = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done && ++spins < (1u << 26));
  if (!done) __trap();
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int col, int row, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle (1: 128 bytes, 2: 64 bytes)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint32_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)swizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pins the accumulators' reads and writes on this side of a wgmma fence or
// wait (the asm statements keep their order; plain code would not)
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, f32) += SA * A (64 x 16, K-major) . B (16 x N, MN-major), bf16
template <int SA>
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, %19, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1), "n"(SA));
}

template <int SA>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, %35, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1), "n"(SA));
}

template <int BN, int SA>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t a,
                                      uint64_t b) {
  if constexpr (BN == 64) wgmma_n64<SA>(d, a, b);
  else wgmma_n32<SA>(d, a, b);
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(col),
      "r"(row) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <bool READ>
__device__ __forceinline__ void bulk_wait() {
  if (READ)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// the 128 threads of consumer warpgroup `wg` (named barrier 1 + wg)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// BN: columns per work item, the wgmma N (64, or 32 where n2 = 32); every
// y box, ring slot plane and output box is BK rows of BN columns (2 * BN
// bytes, in that swizzle).  BK: rows of n1 per ring chunk, min(n1, 64).
// C: consumer warpgroups, one band each.  Threads: C warpgroups, then one
// producer warp.
template <int BN, int BK, int C>
__global__ void __launch_bounds__(128 * C + 32, 1)
stage1(const __grid_constant__ CUtensorMap map_yr,
       const __grid_constant__ CUtensorMap map_yi,
       const __grid_constant__ CUtensorMap map_br,
       const __grid_constant__ CUtensorMap map_bi, const Params p) {
  constexpr int SW = 2 * BN;                // bytes of a swizzled box row
  constexpr uint32_t SWZ = SW == 128 ? 1 : 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t w_s = (raw + ALIGN - 1) & ~(uint32_t)(ALIGN - 1);
  const uint32_t w_bytes = C * 2 * p.kc * W_BLOCK;
  constexpr uint32_t box_bytes = BK * SW;   // one plane of a chunk or tile
  const uint32_t ring = w_s + w_bytes;
  const uint32_t out_s = ring + p.stages * 2 * box_bytes;  // C x (r, i)
  const uint32_t full = out_s + C * 2 * box_bytes;          // mbarriers
  const uint32_t empty = full + 8 * p.stages;
  const uint32_t wbar = empty + 8 * p.stages;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * C);  // every consumer warp reads a slot
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int tiles = p.n2 / BN;
  const int items = p.n_sym * tiles;
  const int g = blockIdx.x % p.groups;
  const int first = blockIdx.x / p.groups;
  const int step = gridDim.x / p.groups;

  if (tid >= 128 * C) {  // the producer warp: one thread issues every load
    if (tid != 128 * C) return;
    const uint8_t* wsrc = p.w + (size_t)g * w_bytes;
    mbar_expect_tx(wbar, w_bytes);
    for (uint32_t off = 0; off < w_bytes; off += W_BLOCK)
      bulk_load(w_s + off, wsrc + off, W_BLOCK, wbar);
    int stage = 0;
    uint32_t phase = 0;
    for (int t = first; t < items; t += step) {
      const int col = (t % tiles) * BN;
      const int row0 = (t / tiles) * p.n1;
      for (int c = 0; c < p.kc; ++c) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        const uint32_t bar = full + 8 * stage;
        const uint32_t dst = ring + stage * 2 * box_bytes;
        mbar_expect_tx(bar, 2 * box_bytes);
        tma_load(dst, &map_yr, col, row0 + c * BK, bar);
        tma_load(dst + box_bytes, &map_yi, col, row0 + c * BK, bar);
        if (++stage == p.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumer warpgroup `wg` owns band g*C + wg
  const int wg = tid / 128, wtid = tid % 128, lane = tid % 32;
  const int band = g * C + wg;
  const uint32_t a_r = w_s + (2 * wg) * p.kc * W_BLOCK;
  const uint32_t a_i = a_r + p.kc * W_BLOCK;
  const uint32_t o_r = out_s + wg * 2 * box_bytes, o_i = o_r + box_bytes;
  // the packed twiddle of this thread: (band, column group, thread)
  const uint4* twp = p.tw + (size_t)band * (p.n2 / 8) * 128 + wtid;
  const int row_lo = (wtid / 32) * 16 + lane / 4;   // within the band
  constexpr int rows = BK;                          // stored rows of a band
  float acc_r[BN / 2], acc_i[BN / 2];
  uint4 twv[BN / 8];
#ifdef K6_PROFILE
  unsigned long long prof[5] = {0, 0, 0, 0, 0}, items_done = 0;
  const long long t_start = clock64();
#endif
  mbar_wait(wbar, 0);
#ifdef K6_PROFILE
  prof[0] = clock64() - t_start;
#endif

  int stage = 0;
  uint32_t phase = 0;
  for (int t = first; t < items; t += step) {
    const int sym = t / tiles, col0 = (t % tiles) * BN;
#ifdef K6_PROFILE
    const long long t_item = clock64();
    long long t_ring = 0;
#endif
    // this item's twiddle, in flight while the products run
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      twv[j] = __ldg(twp + (size_t)(col0 / 8 + j) * 128);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc_r[i] = acc_i[i] = 0.0f;
    fence_regs(acc_r);
    fence_regs(acc_i);
    int prev = -1;
    for (int c = 0; c < p.kc; ++c) {
#ifdef K6_PROFILE
      const long long t_wait = clock64();
      mbar_wait(full + 8 * stage, phase);
      t_ring += clock64() - t_wait;
#else
      mbar_wait(full + 8 * stage, phase);
#endif
      wgmma_fence();
      const uint32_t y_r = ring + stage * 2 * box_bytes;
      const uint32_t y_i = y_r + box_bytes;
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        const uint64_t dwr = desc(a_r + c * W_BLOCK + 32 * ks, 16, 1024, 1);
        const uint64_t dwi = desc(a_i + c * W_BLOCK + 32 * ks, 16, 1024, 1);
        const uint64_t dyr = desc(y_r + 16 * SW * ks, 16, 8 * SW, SWZ);
        const uint64_t dyi = desc(y_i + 16 * SW * ks, 16, 8 * SW, SWZ);
        wgmma<BN, 1>(acc_r, dwr, dyr);
        wgmma<BN, -1>(acc_r, dwi, dyi);
        wgmma<BN, 1>(acc_i, dwr, dyi);
        wgmma<BN, 1>(acc_i, dwi, dyr);
      }
      wgmma_commit();
      if (prev >= 0) {  // the chunk before is read: release its slot
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(empty + 8 * prev);
      }
      prev = stage;
      if (++stage == p.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc_r);
    fence_regs(acc_i);
    if (lane == 0) mbar_arrive(empty + 8 * prev);
#ifdef K6_PROFILE
    const long long t_epi = clock64();
    prof[1] += t_ring;
    prof[2] += t_epi - t_item - t_ring;
#endif

    // epilogue: b = a * tw in f32, one rounding to bf16, into this
    // warpgroup's output tile in shared memory (in the box's swizzle), then
    // one TMA store per plane.  The tile is free once the store before has
    // read it.
    if (wtid == 0) bulk_wait<true>();
    wg_sync(wg);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row_lo + 8 * h;
        const uint32_t wr = h ? twv[j].z : twv[j].x;
        const uint32_t wi = h ? twv[j].w : twv[j].y;
        const float2 tr = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&wr));
        const float2 ti = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&wi));
        const float ar0 = acc_r[4 * j + 2 * h], ar1 = acc_r[4 * j + 2 * h + 1];
        const float ai0 = acc_i[4 * j + 2 * h], ai1 = acc_i[4 * j + 2 * h + 1];
        const uint32_t lin = row * SW + (8 * j + 2 * (lane % 4)) * 2;
        const uint32_t off = lin ^ (((lin >> 7) & (SW / 16 - 1)) << 4);
        if (row < rows) {
          st_shared(o_r + off, pack_bf16(ar0 * tr.x - ai0 * ti.x,
                                         ar1 * tr.y - ai1 * ti.y));
          st_shared(o_i + off, pack_bf16(ar0 * ti.x + ai0 * tr.x,
                                         ar1 * ti.y + ai1 * tr.y));
        }
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wg_sync(wg);
    if (wtid == 0) {
      const int row = sym * p.n1 + band * BAND;
      tma_store(&map_br, o_r, col0, row);
      tma_store(&map_bi, o_i, col0, row);
      bulk_commit();
    }
#ifdef K6_PROFILE
    prof[3] += clock64() - t_epi;
    ++items_done;
#endif
  }
  if (wtid == 0) bulk_wait<false>();
#ifdef K6_PROFILE
  if (wtid == 0) {
    prof[4] = clock64() - t_start;
    for (int i = 0; i < 5; ++i) atomicAdd(g_prof + i, prof[i]);
    atomicAdd(g_prof + 5, items_done);
  }
#endif
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver function; the library does not link
// libcuda, so it comes through the runtime's entry-point query
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// (rows, n2) bf16 plane, boxes of (box_rows, sw / 2 columns), swizzled
int encode_plane(CUtensorMap* map, const void* y, size_t rows, int n2,
                 int box_rows, int sw) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ERR_NO_ENCODE;
  const cuuint64_t dims[2] = {(cuuint64_t)n2, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)n2 * 2};
  const cuuint32_t box[2] = {(cuuint32_t)(sw / 2), (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(y), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

// How a launch is laid out: the column tile, consumer warpgroups, chunking,
// ring depth, shared memory and persistent grid.
struct Plan {
  int bn, c, bk, kc, groups, stages, smem, ctas;
};

int make_plan(int n1, int n2, int n_sym, int sms, Plan* q) {
  q->bn = n2 < 64 ? n2 : 64;
  q->c = n1 >= 2 * BAND ? 2 : 1;
  q->bk = n1 < KCH ? n1 : KCH;
  q->kc = n1 / q->bk;
  q->groups = (n1 < BAND ? 1 : n1 / BAND) / q->c;
  const int w_bytes = q->c * 2 * q->kc * W_BLOCK;
  const int tile_bytes = 2 * q->bk * 2 * q->bn;  // both planes, BN columns
  const int per_stage = tile_bytes + 16;  // a slot, its two mbarriers
  const int room = SMEM_LIMIT - ALIGN - w_bytes - q->c * tile_bytes - 8;
  q->stages = MAX_STAGES;
  while (q->stages > 2 && q->stages * per_stage > room) --q->stages;
  q->smem = SMEM_LIMIT - room + q->stages * per_stage;
  const int items = n_sym * (n2 / q->bn);
  const int per_group = items < sms / q->groups ? items : sms / q->groups;
  q->ctas = per_group * q->groups;
  return q->smem > SMEM_LIMIT ? ERR_SMEM : 0;
}

template <int BN, int BK, int C>
int launch(const Plan& q, const void* yr, const void* yi, const void* w,
           const void* tw, void* br, void* bi, int n_sym, int n1, int n2,
           cudaStream_t st) {
  Params p;
  p.w = static_cast<const uint8_t*>(w);
  p.tw = static_cast<const uint4*>(tw);
  p.n_sym = n_sym;
  p.n1 = n1;
  p.n2 = n2;
  p.kc = q.kc;
  p.groups = q.groups;
  p.stages = q.stages;
  // y boxes are chunks of bk rows; b boxes a band's rows (bk as well)
  CUtensorMap maps[4];
  const void* planes[4] = {yr, yi, br, bi};
  for (int k = 0; k < 4; ++k) {
    const int e = encode_plane(&maps[k], planes[k], (size_t)n_sym * n1, n2,
                               BK, 2 * BN);
    if (e != 0) return e;
  }
  const cudaError_t ce = cudaFuncSetAttribute(
      stage1<BN, BK, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, q.smem);
  if (ce != cudaSuccess) return (int)ce;
  stage1<BN, BK, C><<<q.ctas, 128 * C + 32, q.smem, st>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  return (int)cudaGetLastError();
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)e;
}

}  // namespace

extern "C" {

const char* fft_stage1_error_string(int err) {
  switch (err) {
    case ERR_NO_ENCODE:
      return "cuTensorMapEncodeTiled is not available from the driver";
    case ERR_ENCODE:
      return "cuTensorMapEncodeTiled refused the tensor map of y";
    case ERR_SMEM:
      return "the resident W1^T bands and the ring do not fit shared memory";
    default:
      return cudaGetErrorString((cudaError_t)err);
  }
}

// 0 if (n1, n2) is a shape the kernel takes: n1 in {32, 64, 128, 256}, n2
// in {32, 64, 128} (every factor pair of ops/mxu_fft.py's _FACTORS).
int fft_stage1_supported(int n1, int n2) {
  const bool ok1 = n1 == 32 || n1 == 64 || n1 == 128 || n1 == 256;
  const bool ok2 = n2 == 32 || n2 == 64 || n2 == 128;
  return ok1 && ok2 ? 0 : 1;
}

// The launch `fft_stage1` makes for these sizes on the current device:
// out = {column tile, consumer warpgroups, ring stages, dynamic shared
// memory bytes, CTAs}.  -> 0 or an error code.
int fft_stage1_plan(int n1, int n2, int n_sym, int* out) {
  if (fft_stage1_supported(n1, n2) != 0 || n_sym < 1)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  const int e = sm_count(&sms);
  if (e != 0) return e;
  Plan q;
  const int r = make_plan(n1, n2, n_sym, sms, &q);
  out[0] = q.bn;
  out[1] = q.c;
  out[2] = q.stages;
  out[3] = q.smem;
  out[4] = q.ctas;
  return r;
}

// y_r, y_i (n_sym, n1, n2) -> b_r, b_i (n_sym, n1, n2), all bf16, 16-byte
// aligned and contiguous; w and tw the tables of `pack_tables` (n1, n2).
int fft_stage1(const void* yr, const void* yi, const void* w, const void* tw,
               void* br, void* bi, int n_sym, int n1, int n2, void* stream) {
  if (fft_stage1_supported(n1, n2) != 0 || n_sym < 1 ||
      (size_t)n_sym * n1 > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  int e = sm_count(&sms);
  Plan q;
  if (e == 0) e = make_plan(n1, n2, n_sym, sms, &q);
  if (e != 0) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K6_LAUNCH(BN, BK)                                              \
  (q.c == 2 ? launch<BN, BK, 2>(q, yr, yi, w, tw, br, bi, n_sym, n1, n2, st) \
            : launch<BN, BK, 1>(q, yr, yi, w, tw, br, bi, n_sym, n1, n2, st))
  if (q.bk == 32) return q.bn == 64 ? K6_LAUNCH(64, 32) : K6_LAUNCH(32, 32);
  return q.bn == 64 ? K6_LAUNCH(64, 64) : K6_LAUNCH(32, 64);
#undef K6_LAUNCH
}

#ifdef K6_PROFILE
// Read and clear the profile (see g_prof): out[6].  -> 0 or an error code.
int fft_stage1_profile(unsigned long long* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  const unsigned long long zero[6] = {0, 0, 0, 0, 0, 0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_prof, zero, sizeof(zero));
  return (int)e;
}
#endif

}  // extern "C"
