// One PLP's max-log LLR tail in one pass, for Hopper (sm_90a): K7.
//
// It replaces no TPU kernel.  The JAX package leaves this tail
// (`MultiFramePath._make_tail`) to XLA, which fuses the cell gather, the
// rotation, the level loop and the bit-deinterleave gather into a few
// passes.  Eager PyTorch cannot fuse: `ops/llr_tail.LLRTail.plain` runs
// ~200 element-wise passes a step over (cpf, nb, F) planes (104.7 M cells,
// 209 MB a bf16 plane, at the UK HD mode's 8100 x 202 x 64), ~125 GB of
// device memory traffic.  This kernel computes the same values, bit for
// bit, from one read of the cells and one write of the LLRs.
//
// What it computes, for each cell (c, b) of the PLP (cell c of FEC block
// b, flattened cell-major as i = c*nb + b) and each frame f:
//   re = both[comp[i]][f],  im = both[comp[i']][F + f]
//   with i' = i, or on a rotated PLP the cyclic Q-delay within the block,
//   cell (c + 1) % cpf: i' = (i + nb) mod (cpf*nb);
//   rotated: re, im = re*cos - im*sin, re*sin + im*cos;
//   per axis x and level word w: d_w = (x - level[w])^2;
//   per bit b of the axis: LLR = (min_{w: bit 1} d_w - min_{w: bit 0} d_w)
//   * inv_nvar, bit b of the axis being bit (half - 1 - b) of the word w;
//   written to out[rows[plane * cpf + c]][b][f], plane = b for the I axis
//   and half + b for Q (the bit deinterleave, inverted on the host).
// Where the caller asks for them, the two per-axis planes of the least
// distance, min_w d_w, are written as (cpf*nb, F) rows (the EVM).
//
// Same numbers as the plain version.  Every operation rounds to the LLR
// dtype as PyTorch's eager kernels do (compute in float, round once):
// `x - level` and the rotation's products in float, then rounded; the
// square, the rotation's sum and difference, `acc1 - acc0` and the product
// with inv_nvar on two values of the LLR dtype.  For bf16 the last group
// runs as Hopper's packed bf16x2 instructions (`mul.rn`, `sub.rn`,
// `add.rn`), which round the exact result once: for +, - and x of two
// bf16 values the float result rounded again to bf16 is the same value,
// as float's 24 bits exceed 2 x 8 + 2.  The minimum propagates NaN
// (`min.NaN`), as `torch.minimum` does.  The build has --fmad=false and
// the float steps are __f*_rn intrinsics.  The distances are squares, so
// never -0, and the minimum's order does not matter: the per-bit minima
// come from a tree over the words (36 minima an axis at 16 levels, not 56),
// the same values.
//
// What bounds it on the H100: bytes.  At 8100 x 202 cells x 64 frames it
// reads the paired cells once (0.42 GB) and writes the LLRs once (1.68
// GB): 0.63 ms at 3.35 TB/s.  Its arithmetic is ~110 instructions per
// cell and frame with two values to a register (0.4 ms at 132 SMs x 4 warp
// instructions a cycle), so the loads and the stores have to be coalesced
// and the arithmetic packed.
//
// Design.  A CTA takes a tile of `ti` consecutive cells i (128 at F = 64
// in bf16; more at small F, fewer in f32: 32 KB of staged rows) and up to
// 64 frames (grid.y covers larger F).
//  - Reads.  The tile stages the re halves of its cells' rows and the im
//    halves of their partners' rows (i' above: each half row is read once
//    over the grid) into shared memory, 16 bytes a thread, neighbouring
//    threads on neighbouring addresses of one half row.  A staged half row
//    holds `rc` 16-byte chunks; chunk j lies at j XOR swizzle(cell), so the
//    compute's 16-byte reads by 8 consecutive lanes hit 8 distinct bank
//    groups.
//  - Compute.  A warp unit is 32 pairs of consecutive cells (A = i, B =
//    i + 1) x 8 frames; a thread takes one pair and its octet of frames,
//    two frames a turn of a loop that is not unrolled, the two cells'
//    values in one bf16x2 (or float2) register: both axes' 2 x 16
//    distances, the tree's minima and the LLRs stay in registers.
//  - Writes.  A and B are neighbouring blocks of one cell c almost always
//    (with an even nb and an even i, always), so they share each output row
//    and one 4-byte (f32: 8-byte) store writes both.  For each plane and
//    frame the 32 lanes write 64 consecutive cells: one 128-byte run along
//    the row's contiguous B axis of the frame-major (F, N, B) layout the
//    caller allocates.  Other strides, and a pair that straddles two cells,
//    take one store per value.  The EVM planes, where asked for, take one
//    16-byte store per cell and octet.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; 8100 x 202 cells, F = 64, bf16):
// 2.09-2.11 ms a step, 30% of the bytes bound's rate; 3.97 ms with the EVM
// planes; the plain version 43.6-43.7 ms.  Builds no longer kept split it:
// the arithmetic without the LLR stores 0.88 ms, the stores without the
// arithmetic 2.21 ms.  The stores set the time: an output row of 202 bf16
// is 404 bytes, so most 128-byte runs start mid-sector, and the rows'
// first and last sectors are shared with rows that other cells write.  At
// nb = 192 (rows of whole 128-byte lines) the kernel took 1.10 ms; with the
// rows in cell order 1.44-1.46 ms.  Dropped: one cell per register with a
// pair of frames and 2-byte stores (4.2 ms, with the tree's arrays in local
// memory: a loop bound taken from the enclosing loop did not unroll); a
// host order of the cells that writes neighbouring rows close together in
// time (1.92 ms: 8% for a table and a heuristic).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CTA_FRAMES = 64;         // frames of one CTA (grid.y beyond)
constexpr int MAX_LEVELS = 16;         // 256QAM: 16 levels an axis

struct Params {
  const void* both;        // (total, 2F) rows [re of F frames | im]
  const long long* comp;   // (n_points,) the row of cell i = c*nb + b
  const int* rows;         // (m * cpf,) (plane, cell) -> output row
  void* out;               // LLR of (row r, block b, frame f) at
  long long sr, sb, sf;    //   r*sr + b*sb + f*sf elements
  void* evm_i;             // (n_points, F) least distances or null
  void* evm_q;
  const void* inv;         // inv_nvar, one value of the LLR dtype
  int n_points, nb, cpf, frames;
  int q_shift;             // nb on a rotated PLP (the Q-delay), else 0
  int ti;                  // cells of a CTA: a multiple of 32
  int rc;                  // 16-byte chunks per staged half row: 2^k
  int vec;                 // 16-byte global loads (aligned rows)
  int pair_ok;             // two cells of a row in one store (sb = 1, sr
                           // and sf even, `out` aligned to two values)
  int rotated;
  float rot_re, rot_im;
  float levels[MAX_LEVELS];
};

// bf16: the values of two cells at one frame are one bf16x2 word, cell A
// (the lower address) low
struct Bf16 {
  using T = uint16_t;
  using P = uint32_t;
  static constexpr int CHUNKS = 1;    // 16-byte chunks per 8 frames
  __device__ static __forceinline__ float lo(P p) {
    return __uint_as_float(p << 16);
  }
  __device__ static __forceinline__ float hi(P p) {
    return __uint_as_float(p & 0xFFFF0000u);
  }
  __device__ static __forceinline__ P pack(float l, float h) {
    P r;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(h), "f"(l));
    return r;
  }
  __device__ static __forceinline__ P mul(P a, P b) {
    P r;
    asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
  }
  __device__ static __forceinline__ P sub(P a, P b) {
    P r;
    asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
  }
  __device__ static __forceinline__ P add(P a, P b) {
    P r;
    asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
  }
  __device__ static __forceinline__ P min(P a, P b) {
    P r;
    asm("min.NaN.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
  }
  __device__ static __forceinline__ P splat(const void* v) {
    const uint32_t h = *static_cast<const uint16_t*>(v);
    return h | (h << 16);
  }
  // frame e (0 or 1) of the octet's current pair of frames (chunk word
  // 0): cell A's value (from a) low, cell B's (from b) high
  __device__ static __forceinline__ P first(const uint4* a, const uint4* b,
                                            int e) {
    return __byte_perm(a[0].x, b[0].x, e ? 0x7632 : 0x5410);
  }
  // the next pair of frames to word 0
  __device__ static __forceinline__ void advance(uint4* a) {
    a[0] = make_uint4(a[0].y, a[0].z, a[0].w, a[0].x);
  }
  // one cell's values at a pair of frames (v0, v1) pushed into an octet
  __device__ static __forceinline__ void push(uint4* acc, P v0, P v1,
                                              int cell) {
    const uint32_t w = __byte_perm(v0, v1, cell ? 0x7632 : 0x5410);
    acc[0] = make_uint4(acc[0].y, acc[0].z, acc[0].w, w);
  }
  __device__ static __forceinline__ void put(T* dst, P p, int cell) {
    *dst = static_cast<T>(cell ? p >> 16 : p);
  }
  // both cells at dst, dst + 1 (4-byte aligned)
  __device__ static __forceinline__ void put2(T* dst, P p) {
    *reinterpret_cast<P*>(dst) = p;
  }
  // a full octet at dst (16-byte aligned)
  __device__ static __forceinline__ void put_octet(T* dst, const uint4* x) {
    *reinterpret_cast<uint4*>(dst) = x[0];
  }
};

// f32: the values of two cells at one frame are a float2, cell A in x
struct F32 {
  using T = float;
  using P = float2;
  static constexpr int CHUNKS = 2;
  __device__ static __forceinline__ float lo(P p) { return p.x; }
  __device__ static __forceinline__ float hi(P p) { return p.y; }
  __device__ static __forceinline__ P pack(float l, float h) {
    return make_float2(l, h);
  }
  __device__ static __forceinline__ P mul(P a, P b) {
    return make_float2(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y));
  }
  __device__ static __forceinline__ P sub(P a, P b) {
    return make_float2(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y));
  }
  __device__ static __forceinline__ P add(P a, P b) {
    return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
  }
  __device__ static __forceinline__ float min1(float a, float b) {
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
  }
  __device__ static __forceinline__ P min(P a, P b) {
    return make_float2(min1(a.x, b.x), min1(a.y, b.y));
  }
  __device__ static __forceinline__ P splat(const void* v) {
    const float f = *static_cast<const float*>(v);
    return make_float2(f, f);
  }
  __device__ static __forceinline__ P first(const uint4* a, const uint4* b,
                                            int e) {
    return make_float2(__uint_as_float(e ? a[0].y : a[0].x),
                       __uint_as_float(e ? b[0].y : b[0].x));
  }
  __device__ static __forceinline__ void advance(uint4* a) {
    const uint4 a0 = a[0];
    a[0] = make_uint4(a0.z, a0.w, a[1].x, a[1].y);
    a[1] = make_uint4(a[1].z, a[1].w, a0.x, a0.y);
  }
  __device__ static __forceinline__ void push(uint4* acc, P v0, P v1,
                                              int cell) {
    acc[0] = make_uint4(acc[0].z, acc[0].w, acc[1].x, acc[1].y);
    acc[1] = make_uint4(acc[1].z, acc[1].w,
                        __float_as_uint(cell ? v0.y : v0.x),
                        __float_as_uint(cell ? v1.y : v1.x));
  }
  __device__ static __forceinline__ void put(T* dst, P p, int cell) {
    *dst = cell ? p.y : p.x;
  }
  __device__ static __forceinline__ void put2(T* dst, P p) {
    *reinterpret_cast<P*>(dst) = p;
  }
  __device__ static __forceinline__ void put_octet(T* dst, const uint4* x) {
    reinterpret_cast<uint4*>(dst)[0] = x[0];
    reinterpret_cast<uint4*>(dst)[1] = x[1];
  }
};

// where chunk j of staged half row k lies: j ^ swizzle(k, rc), so that the
// reads of one logical chunk by 8 consecutive lanes (rows 2j or 2j + 1)
// hit 8 distinct bank groups where a row has 8 chunks or more
__device__ __forceinline__ int swizzle(int k, int rc) {
  return rc >= 8 ? (k >> 1) & 7 : (((k >> 1) * rc) >> 3) & (rc - 1);
}

// One level of the tree of minima over N distances (N = 2^(B+1)): bit B of
// the axis splits the words into even and odd; the minima of pairs of
// words serve every earlier bit.  A template per level, so that every
// array has a size known to the compiler and stays in registers.
template <class Tr, int B, int N>
__device__ __forceinline__ void tree(const typename Tr::P (&cur)[N],
                                     typename Tr::P inv, typename Tr::P* llr,
                                     typename Tr::P& least) {
  using P = typename Tr::P;
  P a0 = cur[0], a1 = cur[1];
#pragma unroll
  for (int j = 1; j < N / 2; ++j) {
    a0 = Tr::min(a0, cur[2 * j]);
    a1 = Tr::min(a1, cur[2 * j + 1]);
  }
  llr[B] = Tr::mul(Tr::sub(a1, a0), inv);
  if constexpr (B == 0) {
    least = Tr::min(a0, a1);
  } else {
    P next[N / 2];
#pragma unroll
    for (int j = 0; j < N / 2; ++j)
      next[j] = Tr::min(cur[2 * j], cur[2 * j + 1]);
    tree<Tr, B - 1, N / 2>(next, inv, llr, least);
  }
}

// One axis of two cells: llr[b] for its HALF bits and the least distance,
// bit b of the axis being bit HALF - 1 - b of the level's word.
template <class Tr, int HALF>
__device__ __forceinline__ void axis(typename Tr::P x, const float* levels,
                                     typename Tr::P inv, typename Tr::P* llr,
                                     typename Tr::P& least) {
  using P = typename Tr::P;
  constexpr int L = 1 << HALF;
  const float xl = Tr::lo(x), xh = Tr::hi(x);
  P cur[L];
#pragma unroll
  for (int w = 0; w < L; ++w) {
    const P d = Tr::pack(__fsub_rn(xl, levels[w]), __fsub_rn(xh, levels[w]));
    cur[w] = Tr::mul(d, d);
  }
  tree<Tr, HALF - 1, L>(cur, inv, llr, least);
}

template <class Tr, int HALF, bool EVM>
__global__ void __launch_bounds__(THREADS)
llr_tail_kernel(const __grid_constant__ Params p) {
  using T = typename Tr::T;
  using P = typename Tr::P;
  constexpr int M = 2 * HALF;             // planes: bits per cell
  constexpr int EPC = 16 / sizeof(T);     // elements per 16-byte chunk
  constexpr int C = Tr::CHUNKS;
  extern __shared__ uint4 smem[];         // [2][ti][rc]: re, then im halves

  const int f0 = blockIdx.y * CTA_FRAMES;
  const int fc = min(p.frames - f0, CTA_FRAMES);
  const int i0 = blockIdx.x * p.ti;
  const long long row_len = 2LL * p.frames;
  const T* both = static_cast<const T*>(p.both);

  // stage: half h of cell k's row (h = 1: the im half of its partner)
  if (p.vec) {
    const int cv = fc / EPC;              // 16-byte chunks per half row
    const int total = 2 * p.ti * cv;
    for (int s = threadIdx.x; s < total; s += THREADS) {
      const int j = s % cv, k = (s / cv) % p.ti, h = s / (cv * p.ti);
      const int i = i0 + k;
      if (i >= p.n_points) continue;
      int src = i;
      if (h) {
        src += p.q_shift;
        if (src >= p.n_points) src -= p.n_points;
      }
      const uint4* g = reinterpret_cast<const uint4*>(
          both + p.comp[src] * row_len + h * p.frames + f0) + j;
      smem[(h * p.ti + k) * p.rc + (j ^ swizzle(k, p.rc))] = __ldg(g);
    }
  } else {
    const int total = 2 * p.ti * fc;
    for (int s = threadIdx.x; s < total; s += THREADS) {
      const int e = s % fc, k = (s / fc) % p.ti, h = s / (fc * p.ti);
      const int i = i0 + k;
      if (i >= p.n_points) continue;
      int src = i;
      if (h) {
        src += p.q_shift;
        if (src >= p.n_points) src -= p.n_points;
      }
      T* dst = reinterpret_cast<T*>(smem + (h * p.ti + k) * p.rc);
      dst[((e / EPC) ^ swizzle(k, p.rc)) * EPC + e % EPC] =
          both[p.comp[src] * row_len + h * p.frames + f0 + e];
    }
  }
  __syncthreads();

  // a warp unit: 32 pairs of cells (A = i, B = i + 1) x 8 frames
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int octets = (fc + 7) / 8;
  const int units = (p.ti / 64) * octets;
  const P inv = Tr::splat(p.inv);
  T* const out = static_cast<T*>(p.out);
  for (int u = warp; u < units; u += WARPS) {
    const int g = u / octets, o = u % octets;
    const int ka = 2 * (g * 32 + lane);
    const int ia = i0 + ka;
    if (ia >= p.n_points) continue;
    const bool has_b = ia + 1 < p.n_points;
    const int ca = ia / p.nb, ba = ia - ca * p.nb;
    const int cb = ba + 1 < p.nb ? ca : ca + 1;
    const int bb = ba + 1 < p.nb ? ba + 1 : 0;
    // both cells in one 4- or 8-byte store: one output row, B after A
    const bool paired = has_b && cb == ca && (ba & 1) == 0 && p.pair_ok;
    const int n = min(fc - o * 8, 8);     // frames of this octet
    const bool ev_vec = p.vec && n == 8;  // the EVM octets as one store
    const int sw = swizzle(ka, p.rc);
    uint4 re_a[C], re_b[C], im_a[C], im_b[C], ev[EVM ? 4 : 1][C];
#pragma unroll
    for (int t = 0; t < C; ++t) {
      const int j = (o * C + t) ^ sw;
      re_a[t] = smem[ka * p.rc + j];
      re_b[t] = smem[(ka + 1) * p.rc + j];
      im_a[t] = smem[(p.ti + ka) * p.rc + j];
      im_b[t] = smem[(p.ti + ka + 1) * p.rc + j];
    }
    int off[M];                           // A's place in each plane's row
#pragma unroll
    for (int q = 0; q < M; ++q)
      off[q] = p.rows[q * p.cpf + ca] * p.sr + ba * p.sb;
    const long long e_a = (long long)ia * p.frames + f0 + o * 8;
    T* const evm_i = static_cast<T*>(p.evm_i);
    T* const evm_q = static_cast<T*>(p.evm_q);
#pragma unroll 1
    for (int t = 0; t < n; t += 2) {      // the octet's pairs of frames
      P least[2][2];                      // [frame][axis]
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (t + e >= n) break;
        P x = Tr::first(re_a, re_b, e), y = Tr::first(im_a, im_b, e);
        if (p.rotated) {
          const float xl = Tr::lo(x), xh = Tr::hi(x);
          const float yl = Tr::lo(y), yh = Tr::hi(y);
          const P t1 =
              Tr::pack(__fmul_rn(xl, p.rot_re), __fmul_rn(xh, p.rot_re));
          const P t2 =
              Tr::pack(__fmul_rn(yl, p.rot_im), __fmul_rn(yh, p.rot_im));
          const P t3 =
              Tr::pack(__fmul_rn(xl, p.rot_im), __fmul_rn(xh, p.rot_im));
          const P t4 =
              Tr::pack(__fmul_rn(yl, p.rot_re), __fmul_rn(yh, p.rot_re));
          x = Tr::sub(t1, t2);
          y = Tr::add(t3, t4);
        }
        P llr[M];
        axis<Tr, HALF>(x, p.levels, inv, llr, least[e][0]);
        axis<Tr, HALF>(y, p.levels, inv, llr + HALF, least[e][1]);
        const int f = f0 + o * 8 + t + e;
        T* const row = out + (long long)f * p.sf;
        if (paired) {
#pragma unroll
          for (int q = 0; q < M; ++q) Tr::put2(row + off[q], llr[q]);
        } else {
#pragma unroll
          for (int q = 0; q < M; ++q) {
            Tr::put(row + off[q], llr[q], 0);
            if (has_b)
              Tr::put(row + p.rows[q * p.cpf + cb] * p.sr + bb * p.sb,
                      llr[q], 1);
          }
        }
        if (EVM && !ev_vec) {
          const long long ef = e_a + t + e;
          Tr::put(evm_i + ef, least[e][0], 0);
          Tr::put(evm_q + ef, least[e][1], 0);
          if (has_b) {
            Tr::put(evm_i + ef + p.frames, least[e][0], 1);
            Tr::put(evm_q + ef + p.frames, least[e][1], 1);
          }
        }
      }
      if constexpr (EVM) {
        if (ev_vec) {
#pragma unroll
          for (int ax = 0; ax < 2; ++ax)
#pragma unroll
            for (int cell = 0; cell < 2; ++cell)
              Tr::push(ev[2 * ax + cell], least[0][ax], least[1][ax], cell);
        }
      }
      Tr::advance(re_a);
      Tr::advance(re_b);
      Tr::advance(im_a);
      Tr::advance(im_b);
    }
    if constexpr (EVM) {
      // a cell's 8 frames of the octet are contiguous in an EVM plane
      if (ev_vec) {
        Tr::put_octet(evm_i + e_a, ev[0]);
        Tr::put_octet(evm_q + e_a, ev[2]);
        if (has_b) {
          Tr::put_octet(evm_i + e_a + p.frames, ev[1]);
          Tr::put_octet(evm_q + e_a + p.frames, ev[3]);
        }
      }
    }
  }
}

// the launch's cells per CTA (a multiple of 64, at most 32 KB of staged
// rows) and staged chunks per half row
void plan(int frames, int elem, int* ti, int* rc) {
  const int octets = (std::min(frames, CTA_FRAMES) + 7) / 8;
  const int per_octet = elem == 2 ? Bf16::CHUNKS : F32::CHUNKS;
  int r = 1;
  while (r < octets * per_octet) r <<= 1;
  *rc = r;
  const int cap = std::max(64, (32768 / (32 * r)) / 64 * 64);
  *ti = std::min(64 * std::max(2, 16 / octets), cap);
}

template <class Tr, bool EVM>
void launch_half(const Params& p, int half, dim3 grid, size_t smem,
                 cudaStream_t st) {
  switch (half) {
    case 1: llr_tail_kernel<Tr, 1, EVM><<<grid, THREADS, smem, st>>>(p); break;
    case 2: llr_tail_kernel<Tr, 2, EVM><<<grid, THREADS, smem, st>>>(p); break;
    case 3: llr_tail_kernel<Tr, 3, EVM><<<grid, THREADS, smem, st>>>(p); break;
    default: llr_tail_kernel<Tr, 4, EVM><<<grid, THREADS, smem, st>>>(p); break;
  }
}

template <class Tr>
int launch(Params& p, int half, cudaStream_t st) {
  plan(p.frames, sizeof(typename Tr::T), &p.ti, &p.rc);
  const dim3 grid((p.n_points + p.ti - 1) / p.ti,
                  (p.frames + CTA_FRAMES - 1) / CTA_FRAMES);
  const size_t smem = 2ull * p.ti * p.rc * 16;
  if (p.evm_i != nullptr)
    launch_half<Tr, true>(p, half, grid, smem, st);
  else
    launch_half<Tr, false>(p, half, grid, smem, st);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* llr_tail_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// both (total, 2F) rows of `elem`-byte floats (2: bf16, 4: f32); comp
// (cpf*nb,) int64 rows of the cells, cell-major; rows (bits*cpf,) int32
// output rows of (plane, cell); levels (2^(bits/2),) floats; out and the
// optional evm planes (cpf*nb, F) in the same dtype; inv one value of it.
// -> 0 or a cudaError_t.
int llr_tail(const void* both, const void* comp, const void* rows,
             void* out, void* evm_i, void* evm_q, const void* inv,
             const float* levels, long long sr, long long sb, long long sf,
             int n_points, int nb, int cpf, int frames, int bits,
             int rotated, float rot_re, float rot_im, int elem, int vec,
             void* stream) {
  const int half = bits / 2;
  if ((elem != 2 && elem != 4) || bits < 2 || bits > 8 || bits % 2 ||
      frames < 1 || nb < 1 || cpf < 1 ||
      (long long)nb * cpf != n_points || n_points > 0x7FFFFF00 ||
      (long long)(bits * cpf - 1) * sr + (long long)(nb - 1) * sb >
          0x7FFFFFFF ||
      (evm_i == nullptr) != (evm_q == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.both = both;
  p.comp = static_cast<const long long*>(comp);
  p.rows = static_cast<const int*>(rows);
  p.out = out;
  p.sr = sr;
  p.sb = sb;
  p.sf = sf;
  p.evm_i = evm_i;
  p.evm_q = evm_q;
  p.inv = inv;
  p.n_points = n_points;
  p.nb = nb;
  p.cpf = cpf;
  p.frames = frames;
  p.q_shift = rotated ? nb : 0;
  p.vec = vec;
  p.pair_ok = sb == 1 && sr % 2 == 0 && sf % 2 == 0 &&
              reinterpret_cast<uintptr_t>(out) % (2 * elem) == 0;
  p.rotated = rotated;
  p.rot_re = rot_re;
  p.rot_im = rot_im;
  for (int w = 0; w < MAX_LEVELS; ++w)
    p.levels[w] = w < (1 << half) ? levels[w] : 0.0f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return elem == 2 ? launch<Bf16>(p, half, st) : launch<F32>(p, half, st);
}

}  // extern "C"
