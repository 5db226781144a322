// Layered offset-min-sum QC-LDPC decoders for the DVB-T2 codes, for Hopper
// (sm_90a).  One kernel body, five compile-time instantiations, each
// replacing one TPU kernel of sdr_receiver_dvb_t2_tpu/ops/ldpc_pallas.py:
//
//   K1 make_pallas_layered_vmem_adaptive_io: bf16 LLRs staged in, bf16 c2v,
//      batch-lockstep adaptive exit (front door
//      make_adaptive_decoder_nb_fused_io);
//   K2 make_pallas_layered_vmem_adaptive: f32 totals in, bf16 c2v, the same
//      adaptive exit (front door make_adaptive_decoder_nb_fused);
//   K3 make_pallas_layered_vmem: f32 totals in, bf16 c2v, exactly `iters`
//      sweeps in natural layer order, no syndrome check;
//   K4 make_pallas_layered: f32 totals in, f32 c2v, fixed sweeps in natural
//      order; its leave-one-out minimum goes to the argmin of the strict-<
//      scan (its +BIG messages in the unused info slots change neither
//      minimum, so the scan skips them);
//   K5 make_decoder_nb_fused_io: K3 with the LLRs staged in as bf16 (K1's
//      input stage): the totals start from bf16-rounded LLRs.
//
// Same arithmetic as the TPU kernels, operation for operation: f32 totals
// and messages, new c2v rounded to bf16 (K1-K3, K5: round to nearest even)
// or kept in f32 (K4), the stored value fed to the totals, offset 0.5, edges
// of one info group written back in table order.  Built with --fmad=false so
// no multiply-add contraction changes a rounding.
//
// Device-memory layout:
//   llr  (n, B)           bf16 or f32, as the caller holds it
//   ti   (B, G, 360)      f32  info-group totals
//   tp   (B, q, 360)      f32  parity totals, tp[t][u] = bit k + t + q*u
//   c2v  (B, q, 360)      one row of 8 bytes (bf16 c2v) or 16 (f32) per
//                              check (t, u): the two magnitudes its
//                              messages take, their sign bits and which
//                              edge holds the second magnitude (struct Row);
//                              edge j < deg is info edge j, edge deg the
//                              parity self edge, deg+1 the parity-prev edge
//   bits (n, B)           u8
//   ctl  (6 + 3*chunks,)  i32  done flag, sweep count, bad-check sum, CTAs
//                              arrived at the exit vote, the lockstep
//                              counters (B x the sweep count, and the
//                              sweeps run on codewords found clean at the
//                              vote before them); then per chunk's vote a
//                              triple: the (sum, arrivals) pair of the
//                              resident launch, and the codewords whose
//                              own syndrome failed (both paths; 0 where no
//                              vote ran).  A fixed exit uses the first 4.
//   tables                i32  one row of 4 + 2*degmax words per layer in
//                              visiting order (`pack_tables` in
//                              ops/ldpc_layered.py): t; deg | phases << 8
//                              | edge phases 16.. << 16; where this layer's
//                              two parity totals come from; edge phases
//                              0..15 (2 bits each); and per info edge the
//                              pair (4*(g*360 - shift), shift)
//
// What bounds it on the H100: instruction throughput of one SM, along the
// dependent chain of the layers; not bytes and not f32 throughput.  The q
// layers of a sweep run one after another (each reads the totals the one
// before wrote), and a codeword's info totals (up to 216 KB) fill one SM's
// shared memory, so one CTA on one SM runs gather -> two-minimum scan ->
// barrier -> write-back -> barrier q times per sweep, and nothing else can
// share that SM.  A layer at NORMAL C2/3 is ~435 instructions per thread,
// most of them integer, select and compare instructions that run at half
// the f32 rate; 12 warps of them take ~1 us (PERF.md has the measured
// split).  The bytes of one sweep would take ~0.01 ms at 3.35 TB/s.  What
// the design does about it:
//   - one CTA of 384 threads per codeword, thread u owns check row u of
//     every layer; the info totals live in shared memory for a whole launch;
//   - a code whose layers all have one row degree (every NORMAL code) runs
//     a kernel compiled for that degree, so every edge loop is straight-line
//     code of deg + 2 bodies and the registers fit (no spill); the codes
//     with mixed degrees share one kernel that calls, per layer, the body
//     of that layer's degree (LDPC_DEGREES) out of line;
//   - the tables sit in shared memory, two words per edge, scaled so that
//     an edge's address costs a compare, a select and one add;
//   - a check's messages are stored as what min-sum makes of them: two
//     magnitudes, the sign bits and one index (8 bytes for bf16 where the
//     messages themselves take 20 at NORMAL C2/3), so the c2v of a whole
//     batch of 128 stays in the 50 MB L2; only the check's own thread ever
//     reads or writes its row, so the next layer's row is loaded into
//     registers a layer ahead, with no barrier and no staging buffer;
//   - the parity totals of the next layer are loaded a layer ahead too, or
//     kept in a register where this thread has just produced them; the
//     table says which, and falls back to a load behind the barrier where
//     the next layer reads a row this one writes across threads (the t = 0
//     seam, or an explicit permutation);
//   - the first sweep reads no c2v at all (every old message is 0.0 and
//     x - 0.0f is x), so nothing clears the c2v scratch;
//   - write-backs to one info group keep table order only where a group
//     repeats within the layer: the edges carry a phase number (how many
//     earlier edges of the layer hit the same group) and one barrier
//     separates two phases, instead of one barrier per edge;
//   - the adaptive exit keeps the batch resident (below);
//   - LLRs come in and bits go out in the caller's (n, B) layout through
//     tiled transposes in shared memory.
// Measured and dropped (PERF.md has the numbers): one kernel with every
// degree's body inlined (168 registers and spills, 1 us more per layer); a
// slot-major slab of bf16 messages per layer fetched by cp.async into a
// two-stage ring in shared memory (10 two-byte loads and stores per thread,
// a barrier before the ring is read); the messages of a check as one padded
// 32-byte row (177 MB per sweep at B=128: the card's memory rate showed);
// two threads to a check row, 736 threads, minima combined by shuffles
// (more warps, but more instructions in all: slower at the uniform codes).
//
// Adaptive exit (K1, K2), without reading anything back to the host: after
// every check_every sweeps, once the sweep count reaches the floor
// max(min_it, min_iters), every CTA counts its codeword's failed checks and
// the batch stops when the total is 0 (integer atomics: exact in any
// order).  Where the card holds the whole batch at once (B <= 132 CTAs on
// an H100) one cooperative launch runs all chunks, the totals stay in shared
// memory and the CTAs meet at a barrier of atomics after each chunk.  A
// larger batch takes one launch per chunk: a launch returns at once when
// the done flag is set, and the last CTA to arrive at the vote sets it.
// The counting build (COUNT, launched while the host traces) also keeps
// the lockstep counters: a CTA whose count is not 0 adds one to the vote's
// failing codewords, and one thread turns them into the sweeps run on
// codewords found clean.  The build without them is the hot path's kernel
// unchanged: a decode that is not traced pays nothing for them.
// Fixed exit (K3, K4, K5): one launch runs all sweeps and checks nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr int NU = 360;       // rows of a QC tile (checks per layer)
constexpr int THREADS = 384;  // NU rounded up to whole warps
constexpr int HDR = 4;        // header words of a table row
constexpr int CTL_HDR = 6;    // header words of ctl, before the votes
constexpr int CTL_VOTE = 3;   // words of one vote in ctl
constexpr int MAX_EDGES = 24;  // sign bits of a stored row, below its index
constexpr int PHASE_LO_EDGES = 16;  // edges whose phase sits in word 3
constexpr int SMEM_LIMIT = 232448;  // bytes one CTA may use on sm_90
// of them, kept for the static variables (the profiling build has more)
constexpr int SMEM_STATIC = 128;
constexpr float BIG = 1e9f;
// where a layer's parity total comes from (table word 2, 4 bits each)
constexpr int SRC_EARLY = 0;       // loaded one layer ahead
constexpr int SRC_CARRY_SELF = 1;  // the self total this thread just wrote
constexpr int SRC_CARRY_PREV = 2;  // the prev total this thread just wrote
constexpr int SRC_LATE = 3;        // loaded behind the last layer's barrier

// the row degrees of the codes whose layers differ in degree (SHORT C1/4,
// C1/2, C3/4, C4/5, C5/6), and the degrees of the uniform codes
#define LDPC_DEGREES(X) \
  X(1) X(2) X(3) X(4) X(5) X(7) X(8) X(9) X(10) X(11) X(14) X(15) X(16) X(17)
#define LDPC_UNIFORM(X) X(5) X(7) X(8) X(9) X(12) X(16) X(20)

struct Dims {
  int q, degmax, G;
};

// Built with -DLDPC_PROFILE, thread 0 of every CTA notes its clock at the
// end of the four barrier-delimited parts of a layer: pass 1 (gather, scan,
// message and parity stores), the wait at the barrier behind it, the
// write-back, and the closing barrier.  sweep_chunk sums the parts' cycles
// in registers after each layer, and CTA 0 adds its sums to g_prof when it
// ends.
#ifdef LDPC_PROFILE
__device__ unsigned long long g_prof[5];
__shared__ unsigned s_stamp[4];
#define PROF_MARK(i)                                      \
  do {                                                    \
    if (threadIdx.x == 0) s_stamp[i] = (unsigned)clock(); \
  } while (0)
#else
#define PROF_MARK(i)
#endif

__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load(const float* p) { return *p; }

// One check's stored messages.  The new messages of a row take only two
// magnitudes (the leave-one-out minimum at one edge, the minimum at all
// others), so a row is stored as those two magnitudes in the storage type,
// the edges' sign bits and the index of the edge that holds the second
// one: 8 bytes (bf16) or 16 (f32) whatever the degree, and every stored
// message comes back bit for bit.
template <typename C2V>
struct Row;
template <>
struct Row<__nv_bfloat16> {
  uint2 v;  // mag1 | mag2 << 16 (bf16 bits); signs | index << 24
  __device__ __forceinline__ void clear() { v = make_uint2(0u, 0u); }
  __device__ __forceinline__ void load(const void* p) {
    v = __ldcg(static_cast<const uint2*>(p));
  }
  __device__ __forceinline__ void store(void* p) const {
    __stcg(static_cast<uint2*>(p), v);
  }
  __device__ __forceinline__ unsigned mag1() const { return v.x << 16; }
  __device__ __forceinline__ unsigned mag2() const {
    return v.x & 0xffff0000u;
  }
  __device__ __forceinline__ unsigned meta() const { return v.y; }
  // Round the two magnitudes to bf16 (nearest even) and keep them.
  __device__ __forceinline__ void set_mags(float m1, float m2) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(m1, m2);
    v.x = *reinterpret_cast<const unsigned*>(&h);
  }
  __device__ __forceinline__ void set_meta(unsigned meta) { v.y = meta; }
};
template <>
struct Row<float> {
  uint4 v;  // mag1, mag2 (f32 bits), signs | index << 24, 0
  __device__ __forceinline__ void clear() { v = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void load(const void* p) {
    v = __ldcg(static_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void store(void* p) const {
    __stcg(static_cast<uint4*>(p), v);
  }
  __device__ __forceinline__ unsigned mag1() const { return v.x; }
  __device__ __forceinline__ unsigned mag2() const { return v.y; }
  __device__ __forceinline__ unsigned meta() const { return v.z; }
  __device__ __forceinline__ void set_mags(float m1, float m2) {
    v = make_uint4(__float_as_uint(m1), __float_as_uint(m2), 0u, 0u);
  }
  __device__ __forceinline__ void set_meta(unsigned meta) { v.z = meta; }
};

// Stored message of edge j (a constant after unrolling) of a row.
template <typename C2V>
__device__ __forceinline__ float message(const Row<C2V>& r, int j) {
  const unsigned mag = (int)(r.meta() >> 24) == j ? r.mag2() : r.mag1();
  return __uint_as_float(mag | ((r.meta() << (31 - j)) & 0x80000000u));
}

// The total an info edge reads and updates for check row u.  `ti_u` is the
// totals' base advanced by u floats; the table pair holds the byte offset
// 4*(g*360 - shift) and the shift, and the roll wraps at 360 rows.
__device__ __forceinline__ float* edge_total(char* ti_u, const int2 w,
                                             int u) {
  return reinterpret_cast<float*>(ti_u + w.x + (u < w.y ? NU * 4 : 0));
}

// Phase of edge j (a constant after unrolling) from the layer's header: 2
// bits per edge, edges 0..15 in word 3, edges 16.. in the upper half of
// word 1.
__device__ __forceinline__ int edge_phase(const int* sw, int j) {
  return j < PHASE_LO_EDGES
             ? ((unsigned)sw[3] >> (2 * j)) & 3
             : ((unsigned)sw[1] >> (16 + 2 * (j - PHASE_LO_EDGES))) & 3;
}

// One check layer t of the layered schedule for this CTA's codeword, row
// degree DEG, for check row u (`active`: u < 360).  `old` holds the check's
// stored messages (all zero in the first sweep), `cv` is where its new row
// goes.  self_p / prev_p are the layer's two parity totals before the
// update; the updated ones come back in c_self / c_prev and go to tp_u, the
// parity totals' base advanced by u.
template <typename C2V, bool ARGMIN, int DEG>
__device__ __forceinline__ void layer(const int* __restrict__ sw, int t,
                                      int q, int nph, float offset,
                                      float self_p, float prev_p, int u,
                                      bool active, char* ti_u,
                                      const Row<C2V>& old, void* cv,
                                      float* tp_u, float& c_self,
                                      float& c_prev) {
  constexpr int E = DEG + 2;
  const int2* ew = reinterpret_cast<const int2*>(sw + HDR);
  float m[E], d[E];
  float* p[DEG];
  if (active) {
#pragma unroll
    for (int j = 0; j < DEG; ++j) p[j] = edge_total(ti_u, ew[j], u);
    // pass 1: v2c messages (pre-layer totals minus the old c2v)
#pragma unroll
    for (int j = 0; j < E; ++j) d[j] = message(old, j);
#pragma unroll
    for (int j = 0; j < DEG; ++j) m[j] = *p[j] - d[j];
    m[DEG] = self_p - d[DEG];
    {
      float v = prev_p - d[DEG + 1];
      // check 0 has no previous parity: +BIG on u == 0 at t == 0
      if (t == 0) v = v + (u == 0 ? BIG : 0.0f);
      m[DEG + 1] = v;
    }
    // two minima (min2 counts multiplicity) and the parity of the negative
    // messages
    float min1 = fabsf(m[0]);
    float min2 = BIG;
    bool odd = m[0] < 0.0f;
    int amin = 0;
#pragma unroll
    for (int j = 1; j < E; ++j) {
      const float a = fabsf(m[j]);
      if (ARGMIN) {
        const bool is_new = a < min1;
        min2 = is_new ? min1 : fminf(min2, a);
        min1 = is_new ? a : min1;
        amin = is_new ? j : amin;
      } else {
        // the same two values as the strict-< scan, without its selects
        min2 = fminf(min2, fmaxf(min1, a));
        min1 = fminf(min1, a);
      }
      odd ^= m[j] < 0.0f;
    }
    // new c2v: sign(product of the other signs) * max(min_loo - offset, 0),
    // in the storage type.  The leave-one-out minimum is min2 at K4's
    // argmin, or at every edge with |m| == min1 (then a tie makes min2 ==
    // min1, so one such edge stands for all in the stored row).  Negating
    // a magnitude >= +0 is multiplying it by -1.
    Row<C2V> out;
    out.set_mags(fmaxf(min1 - offset, 0.0f), fmaxf(min2 - offset, 0.0f));
    const float r1 = __uint_as_float(out.mag1());
    const float r2 = __uint_as_float(out.mag2());
    const float a1 = odd ? -r1 : r1;
    const float a2 = odd ? -r2 : r2;
    unsigned signs = 0u;
#pragma unroll
    for (int j = E - 1; j >= 0; --j) {
      const bool hot = ARGMIN ? amin == j : fabsf(m[j]) <= min1;
      if (!ARGMIN) amin = hot ? j : amin;
      const float x = hot ? a2 : a1;
      const float nw = m[j] < 0.0f ? -x : x;  // the stored value
      // edge j's sign bit ends up at bit j
      signs = __funnelshift_l(__float_as_uint(nw), signs, 1);
      if (j < DEG) {
        d[j] = nw - d[j];
      } else if (j == DEG) {
        c_self = m[j] + nw;
      } else {
        c_prev = m[j] + nw;
      }
    }
    out.set_meta(signs | (unsigned)amin << 24);
    out.store(cv);
    tp_u[t * NU] = c_self;
    if (t > 0) {
      tp_u[(t - 1) * NU] = c_prev;
    } else if (u > 0) {
      // aligned slot u is parity bit (q-1, u-1); u == 0 is the masked
      // non-edge, so tp[q-1][359] keeps its value
      tp_u[(q - 1) * NU - 1] = c_prev - 0.0f;
    }
  }
  PROF_MARK(0);
  __syncthreads();  // every pass-1 read of the totals is done
  PROF_MARK(1);
  // pass 2: additive write-back through the inverse roll.  Within a phase
  // the addresses are distinct, so all loads go first and none waits for a
  // store; a barrier separates two phases where an info group repeats.
  if (nph == 1) {
    if (active) {
#pragma unroll
      for (int j = 0; j < DEG; ++j) m[j] = *p[j];
#pragma unroll
      for (int j = 0; j < DEG; ++j) *p[j] = m[j] + d[j];
    }
  } else {
    for (int ph = 0; ph < nph; ++ph) {
      if (ph > 0) __syncthreads();
      if (active) {
#pragma unroll
        for (int j = 0; j < DEG; ++j)
          if (edge_phase(sw, j) == ph) m[j] = *p[j];
#pragma unroll
        for (int j = 0; j < DEG; ++j)
          if (edge_phase(sw, j) == ph) *p[j] = m[j] + d[j];
      }
    }
  }
  PROF_MARK(2);
}

// The layer body as a function of its own, for the kernel of the
// mixed-degree codes: with every degree's body inlined into one kernel the
// registers run out and the compiler spills.
template <typename C2V, bool ARGMIN, int DEG>
__device__ __noinline__ void layer_call(const int* __restrict__ sw, int t,
                                        int q, int nph, float offset,
                                        float self_p, float prev_p, int u,
                                        bool active, char* ti_u,
                                        const Row<C2V>& old, void* cv,
                                        float* tp_u, float& c_self,
                                        float& c_prev) {
  layer<C2V, ARGMIN, DEG>(sw, t, q, nph, offset, self_p, prev_p, u, active,
                          ti_u, old, cv, tp_u, c_self, c_prev);
}

// Failed parity checks of check row u of every layer (reduced later).  The
// hard decisions of the row's q parity bits are gathered first, with
// independent loads, into a bit mask (q <= 96); the layers then read only
// shared memory.  UDEG as in sweep_chunk.
template <int UDEG>
__device__ int syndrome(const Dims& dm, const int* s_tab, char* ti_u,
                        const float* tp_u, int u) {
  if (u >= NU) return 0;
  const int W = HDR + 2 * dm.degmax;
  const int q = dm.q;
  unsigned hard[3] = {0u, 0u, 0u};  // bit t: tp[t][u] < 0
#pragma unroll
  for (int w = 0; w < 3; ++w) {
    const int n = min(32, q - 32 * w);
#pragma unroll 8
    for (int i = 0; i < n; ++i)
      hard[w] |= (tp_u[(32 * w + i) * NU] < 0.0f ? 1u : 0u) << i;
  }
  // check (0, u) sees parity bit (q-1, u-1); check (0, 0) has none
  const unsigned seam = u > 0 && tp_u[(q - 1) * NU - 1] < 0.0f;
  int bad = 0;
  for (int li = 0; li < q; ++li) {
    const int* sw = s_tab + li * W;
    const int t = sw[0];
    const int2* ew = reinterpret_cast<const int2*>(sw + HDR);
    const unsigned lo = t < 32 ? hard[0] : t < 64 ? hard[1] : hard[2];
    const unsigned pl = t - 1 < 32 ? hard[0] : t - 1 < 64 ? hard[1] : hard[2];
    unsigned acc = (lo >> (t & 31)) + (t > 0 ? pl >> ((t - 1) & 31) : seam);
    if (UDEG) {
#pragma unroll
      for (int j = 0; j < UDEG; ++j)
        acc += *edge_total(ti_u, ew[j], u) < 0.0f;
    } else {
      const int deg = sw[1] & 255;
      for (int j = 0; j < deg; ++j)
        acc += *edge_total(ti_u, ew[j], u) < 0.0f;
    }
    bad += acc & 1u;
  }
  return bad;
}

// Sum of `v` over the CTA, valid in thread 0 (s_red: one int per warp).
__device__ int block_sum(int v, int* s_red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();  // s_red may still be read from the vote before
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  int tot = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < THREADS / 32; ++w) tot += s_red[w];
  return tot;
}

// (n, B) LLRs (bf16 for K1 and K5, f32 for K2-K4) -> f32 totals
// ti (B, G, 360) and tp (B, q, 360): a transpose in 32 x 32 tiles.  Tile
// column x < info_tiles covers info bits 32x..32x+31; the others cover 32
// consecutive u of one parity layer t (bits k + t + q*u).
template <typename In>
__global__ void __launch_bounds__(256)
stage_in(const In* __restrict__ llr, float* ti, float* tp, int* ctl, Dims dm,
         int batch, int k, int info_tiles, int max_iters, int ctl_words) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int b0 = blockIdx.y * 32;
  const int x = blockIdx.x;
  const bool info = x < info_tiles;
  const int pt = info ? 0 : (x - info_tiles) / 12;
  const int c0 = info ? x * 32 : ((x - info_tiles) % 12) * 32;
  const int lim = info ? k : NU;  // columns of this row of tiles
  for (int r = ty; r < 32; r += 8) {
    const int c = c0 + r;
    if (c < lim && b0 + tx < batch) {
      const size_t row = info ? (size_t)c : (size_t)k + pt + (size_t)dm.q * c;
      tile[r][tx] = load(llr + row * batch + b0 + tx);
    }
  }
  __syncthreads();
  for (int r = ty; r < 32; r += 8) {
    const int b = b0 + r, c = c0 + tx;
    if (c < lim && b < batch) {
      if (info) {
        ti[(size_t)b * k + c] = tile[tx][r];
      } else {
        tp[((size_t)b * dm.q + pt) * NU + c] = tile[tx][r];
      }
    }
  }
  if (blockIdx.x == 0 && blockIdx.y == 0 && ty == 0) {
    for (int i = tx; i < ctl_words; i += 32)
      ctl[i] = i == 1 ? max_iters : i == 4 ? batch * max_iters : 0;
  }
}

// Totals -> hard decisions (n, B) u8, through the same tiles.
__global__ void __launch_bounds__(256)
stage_out(const float* __restrict__ ti, const float* __restrict__ tp,
          uint8_t* bits, Dims dm, int batch, int k, int info_tiles) {
  __shared__ uint8_t tile[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int b0 = blockIdx.y * 32;
  const int x = blockIdx.x;
  const bool info = x < info_tiles;
  const int pt = info ? 0 : (x - info_tiles) / 12;
  const int c0 = info ? x * 32 : ((x - info_tiles) % 12) * 32;
  const int lim = info ? k : NU;
  for (int r = ty; r < 32; r += 8) {
    const int b = b0 + r, c = c0 + tx;
    if (c < lim && b < batch) {
      const float v = info ? ti[(size_t)b * k + c]
                           : tp[((size_t)b * dm.q + pt) * NU + c];
      tile[r][tx] = v < 0.0f;
    }
  }
  __syncthreads();
  for (int r = ty; r < 32; r += 8) {
    const int c = c0 + r;
    if (c < lim && b0 + tx < batch) {
      const size_t row = info ? (size_t)c : (size_t)k + pt + (size_t)dm.q * c;
      bits[row * batch + b0 + tx] = tile[tx][r];
    }
  }
}

// `n_chunks` chunks of `n_sweeps` sweeps over one codeword per CTA, after
// `it0` sweeps of earlier launches.  UDEG is the code's row degree where
// all its layers share one, 0 for the mixed-degree codes.  Dynamic shared
// memory: the tables, then the info totals.  `first`: the launch starts
// with the decode's first sweep (no stored messages yet).  `check`: the
// adaptive exit.  With `resident` (every CTA of the grid is on the card at
// once: a cooperative launch) one launch runs all chunks and the CTAs vote
// after each through a barrier across the grid; without it a launch runs
// one chunk, returns at once if the batch has converged, and the last CTA
// to arrive at the vote sets the flag for the next launch.  COUNT: keep
// the lockstep counters in ctl.
template <typename C2V, bool ARGMIN, int UDEG, bool COUNT>
__global__ void __launch_bounds__(THREADS, 1)
sweep_chunk(float* ti, float* tp, Row<C2V>* c2v, int* ctl,
            const int* __restrict__ tables, Dims dm, int n_sweeps,
            int n_chunks, int it0, const int* min_it, int min_iters,
            int check, int resident, int first, float offset) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_red[THREADS / 32];
  __shared__ int s_last;
  if (*(volatile int*)ctl != 0) return;  // batch already converged
  const int q = dm.q;
  const int W = HDR + 2 * dm.degmax;
  const int tab_words = (q * W + 3) & ~3;
  int* s_tab = reinterpret_cast<int*>(smem);
  float* s_ti = reinterpret_cast<float*>(smem) + tab_words;
  const int u = threadIdx.x;
  const int b = blockIdx.x;
  float* tib = ti + (size_t)b * dm.G * NU;
  float* tpb = tp + (size_t)b * q * NU;
  // this thread's check row in layer 0 of the messages, the parity totals
  // and the info totals (the idle threads stay inside the arrays)
  const bool active = u < NU;
  Row<C2V>* cvb = c2v + (size_t)b * q * NU + (active ? u : 0);
  float* tp_u = tpb + (active ? u : 0);
  char* ti_u = reinterpret_cast<char*>(s_ti + (active ? u : 0));
  const int left = u == 0 ? NU - 1 : -1;  // the column one to the left

  for (int i = u; i < q * W; i += THREADS) s_tab[i] = tables[i];
  {
    const float4* src = reinterpret_cast<const float4*>(tib);
    float4* dst = reinterpret_cast<float4*>(s_ti);
    for (int i = u; i < dm.G * (NU / 4); i += THREADS) dst[i] = src[i];
  }
  __syncthreads();

  float c_self = 0.0f, c_prev = 0.0f, pre_self = 0.0f, pre_prev = 0.0f;
  Row<C2V> cur, nxt;
  nxt.clear();  // the first sweep's old messages are all 0.0
  if (!first && active) nxt.load(cvb + s_tab[0] * NU);
  int gstep = 0;
#ifdef LDPC_PROFILE
  unsigned long long prof[4] = {0, 0, 0, 0};
  unsigned prof_t = (unsigned)clock();
#endif
  const int total = n_chunks * n_sweeps;
  const int floor_it = check ? max(*min_it, min_iters) : 0;
  for (int it = 0; it < total; ++it) {
    const bool fs = first && it == 0;
    for (int li = 0; li < q; ++li, ++gstep) {
      const int* sw = s_tab + li * W;
      const int t = sw[0];
      const int nph = (sw[1] >> 8) & 255;
      const int src = gstep == 0 ? (SRC_LATE | SRC_LATE << 4) : sw[2];
      const int ss = src & 15, sp = src >> 4;
      float self_p = 0.0f, prev_p = 0.0f;
      if (active) {
        self_p = ss == SRC_EARLY ? pre_self
                 : ss == SRC_CARRY_SELF ? c_self
                 : ss == SRC_CARRY_PREV ? c_prev : tp_u[t * NU];
        if (sp == SRC_LATE) {
          prev_p = t > 0 ? tp_u[(t - 1) * NU] : tp_u[(q - 1) * NU + left];
        } else {
          prev_p = sp == SRC_EARLY ? pre_prev
                   : sp == SRC_CARRY_SELF ? c_self : c_prev;
        }
      }
      cur = nxt;
      // what the next layer needs and this one does not write: its parity
      // totals where the table allows, and its stored messages unless it
      // still belongs to the first sweep
      const bool has_next = !(it == total - 1 && li == q - 1);
      if (has_next && active) {
        const int nli = li + 1 == q ? 0 : li + 1;
        const int nt = s_tab[nli * W];
        const int nsrc = s_tab[nli * W + 2];
        if ((nsrc & 15) == SRC_EARLY) pre_self = tp_u[nt * NU];
        if ((nsrc >> 4) == SRC_EARLY)
          pre_prev = nt > 0 ? tp_u[(nt - 1) * NU]
                            : tp_u[(q - 1) * NU + left];
        if (!(fs && li + 1 < q)) nxt.load(cvb + nt * NU);
      }
      Row<C2V>* cv = cvb + t * NU;
      if (UDEG) {
        layer<C2V, ARGMIN, UDEG ? UDEG : 1>(
            sw, t, q, nph, offset, self_p, prev_p, u, active, ti_u, cur, cv,
            tp_u, c_self, c_prev);
      } else {
        switch (sw[1] & 255) {
#define LDPC_CASE(D)                                                       \
  case D:                                                                  \
    layer_call<C2V, ARGMIN, D>(sw, t, q, nph, offset, self_p, prev_p, u,   \
                               active, ti_u, cur, cv, tp_u, c_self,        \
                               c_prev);                                    \
    break;
          LDPC_DEGREES(LDPC_CASE)
#undef LDPC_CASE
          default:
            __trap();  // the host refuses such a code before any launch
        }
      }
      __syncthreads();  // the write-backs are in place
      PROF_MARK(3);
#ifdef LDPC_PROFILE
      if (u == 0) {
        for (int i = 0; i < 4; ++i) {
          prof[i] += s_stamp[i] - prof_t;  // modulo 2^32
          prof_t = s_stamp[i];
        }
      }
#endif
    }
    if (resident && check && (it + 1) % n_sweeps == 0 &&
        it0 + it + 1 >= floor_it) {
      // the vote of the chunk that just ended: every CTA adds its failed
      // checks to the chunk's own counter, then waits for all to arrive
      int* slot = ctl + CTL_HDR + CTL_VOTE * (it / n_sweeps);
      const int bad =
          block_sum(syndrome<UDEG>(dm, s_tab, ti_u, tp_u, u), s_red);
      if (threadIdx.x == 0) {
        if (COUNT && bad != 0) atomicAdd(slot + 2, 1);
        atomicAdd(slot, bad);
        __threadfence();
        atomicAdd(slot + 1, 1);
        while (*(volatile int*)(slot + 1) < (int)gridDim.x) __nanosleep(32);
        __threadfence();
        s_last = *(volatile int*)slot;
      }
      __syncthreads();
      if (s_last == 0) {  // the same total in every CTA
        if (b == 0 && threadIdx.x == 0) {
          ctl[0] = 1;
          ctl[1] = it0 + it + 1;
          if (COUNT) ctl[4] = (int)gridDim.x * (it0 + it + 1);
        }
        break;
      }
      // the next chunk's sweeps on the codewords this vote found clean
      if (COUNT && b == 0 && threadIdx.x == 0 && it + 1 < total)
        ctl[5] += ((int)gridDim.x - *(volatile int*)(slot + 2)) * n_sweeps;
    }
  }
#ifdef LDPC_PROFILE
  if (b == 0 && u == 0) {
    for (int i = 0; i < 4; ++i) atomicAdd(g_prof + i, prof[i]);
    atomicAdd(g_prof + 4, (unsigned long long)gstep);
  }
#endif
  {
    const float4* src = reinterpret_cast<const float4*>(s_ti);
    float4* dst = reinterpret_cast<float4*>(tib);
    for (int i = u; i < dm.G * (NU / 4); i += THREADS) dst[i] = src[i];
  }
  const int it_now = it0 + total;
  if (!check || resident || it_now < floor_it) return;
  const int bad = block_sum(syndrome<UDEG>(dm, s_tab, ti_u, tp_u, u), s_red);
  // this launch ran the chunk of sweeps it0 .. it_now - 1
  int* failing = ctl + CTL_HDR + CTL_VOTE * (it0 / n_sweeps) + 2;
  if (threadIdx.x == 0) {
    if (COUNT && bad != 0) atomicAdd(failing, 1);
    atomicAdd(ctl + 2, bad);
    __threadfence();
    s_last = atomicAdd(ctl + 3, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (s_last && threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(ctl + 2, 0) == 0) {
      ctl[0] = 1;
      ctl[1] = it_now;
      if (COUNT) ctl[4] = (int)gridDim.x * it_now;
    } else if (COUNT && it_now < ctl[1]) {
      // a launch follows (ctl[1] holds max_iters until the batch stops):
      // its sweeps on the codewords this vote found clean
      ctl[5] += ((int)gridDim.x - *(volatile int*)failing) * n_sweeps;
    }
    ctl[2] = 0;
    ctl[3] = 0;
  }
}

bool has_degree(int deg) {
  switch (deg) {
#define LDPC_CASE(D) case D:
    LDPC_DEGREES(LDPC_CASE)
#undef LDPC_CASE
    return true;
    default:
      return false;
  }
}

bool has_uniform(int deg) {
  switch (deg) {
#define LDPC_CASE(D) case D:
    LDPC_UNIFORM(LDPC_CASE)
#undef LDPC_CASE
    return true;
    default:
      return false;
  }
}

// Prepare sweep_chunk<C2V, ARGMIN, UDEG, COUNT> for launches with `smem`
// bytes of dynamic shared memory and give the most CTAs of it the card
// holds at once (0 if it cannot launch cooperatively): up to that batch
// the adaptive exit runs as one resident launch.  The CUDA runtime is asked once per device
// and size; later decodes read the answer here.
template <typename C2V, bool ARGMIN, int UDEG, bool COUNT>
cudaError_t configure(size_t smem, int* resident) {
  static std::mutex mu;
  static std::map<std::pair<int, size_t>, int> known;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  auto it = known.find({dev, smem});
  if (it == known.end()) {
    int sms = 0, coop = 0, per_sm = 0;
    // the most any code may ask for, so that one setting serves every size
    e = cudaFuncSetAttribute(sweep_chunk<C2V, ARGMIN, UDEG, COUNT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_LIMIT - SMEM_STATIC);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, sweep_chunk<C2V, ARGMIN, UDEG, COUNT>, THREADS, smem);
    if (e != cudaSuccess) return e;
    it = known.emplace(std::make_pair(dev, smem), coop ? per_sm * sms : 0)
             .first;
  }
  *resident = it->second;
  return cudaSuccess;
}

// The sweep launches of one decode with the kernel for `UDEG` and COUNT.
template <typename C2V, bool ARGMIN, int UDEG, bool COUNT>
cudaError_t launches(float* ti, float* tp, Row<C2V>* c2v, int* ctl,
                     const int* tab, Dims dm, const int* min_it, int batch,
                     int max_iters, int check_every, int min_iters,
                     bool adaptive, size_t smem, float offset,
                     cudaStream_t st) {
  int resident_batch = 0;
  cudaError_t e = configure<C2V, ARGMIN, UDEG, COUNT>(smem, &resident_batch);
  if (e != cudaSuccess) return e;
  if (adaptive) {
    int n_chunks = (max_iters + check_every - 1) / check_every;
    if (batch <= resident_batch) {
      int it0 = 0, check = 1, resident = 1, first = 1;
      void* args[] = {&ti,      &tp,       &c2v,      &ctl,   &tab,
                      &dm,      &check_every, &n_chunks, &it0, &min_it,
                      &min_iters, &check,  &resident, &first, &offset};
      return cudaLaunchCooperativeKernel(
          reinterpret_cast<const void*>(
              sweep_chunk<C2V, ARGMIN, UDEG, COUNT>),
          dim3(batch), dim3(THREADS), args, smem, st);
    }
    for (int ci = 0; ci < n_chunks; ++ci) {
      sweep_chunk<C2V, ARGMIN, UDEG, COUNT><<<batch, THREADS, smem, st>>>(
          ti, tp, c2v, ctl, tab, dm, check_every, 1, ci * check_every,
          min_it, min_iters, 1, 0, ci == 0, offset);
    }
  } else if (max_iters > 0) {
    sweep_chunk<C2V, ARGMIN, UDEG, COUNT><<<batch, THREADS, smem, st>>>(
        ti, tp, c2v, ctl, tab, dm, max_iters, 1, 0, nullptr, 0, 0, 0, 1,
        offset);
  }
  return cudaSuccess;
}

// The sweep launches of one decode; `count` (an adaptive exit only) takes
// the counting build.
template <typename C2V, bool ARGMIN, int UDEG>
cudaError_t sweeps(float* ti, float* tp, Row<C2V>* c2v, int* ctl,
                   const int* tab, Dims dm, const int* min_it, int batch,
                   int max_iters, int check_every, int min_iters,
                   bool adaptive, bool count, size_t smem, float offset,
                   cudaStream_t st) {
  if constexpr (!ARGMIN) {
    if (adaptive && count)
      return launches<C2V, ARGMIN, UDEG, true>(
          ti, tp, c2v, ctl, tab, dm, min_it, batch, max_iters, check_every,
          min_iters, adaptive, smem, offset, st);
  }
  return launches<C2V, ARGMIN, UDEG, false>(
      ti, tp, c2v, ctl, tab, dm, min_it, batch, max_iters, check_every,
      min_iters, adaptive, smem, offset, st);
}

// Decode B codewords: llr (n, B) -> bits (n, B) uint8 and, for the adaptive
// exit, the batch sweep count in ctl[1].  Scratch ti/tp/c2v/ctl and
// `tables` as laid out above; `udeg` is the code's row degree if all its
// layers share it and a kernel exists for it, else 0.  max_iters is the
// fixed sweep count when !adaptive; `count` launches the counting build.
template <typename In, typename C2V, bool ARGMIN>
int decode(const void* llr, void* bits, void* ti, void* tp, void* c2v,
           void* ctl, const void* tables, const void* min_it, int batch,
           int n, int k, int n_groups, int q, int degmax, int max_iters,
           int check_every, int min_iters, bool adaptive, bool count,
           int udeg, float offset, void* stream) {
  Dims dm;
  dm.q = q;
  dm.degmax = degmax;
  dm.G = n_groups;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tab_words = (q * (HDR + 2 * degmax) + 3) & ~3;
  const size_t smem = (size_t)tab_words * 4 + (size_t)n_groups * NU * 4;
  if (smem + SMEM_STATIC > SMEM_LIMIT || k != n_groups * NU ||
      n - k != q * NU || batch < 1 || q < 2 || q > 96 ||
      degmax + 2 > MAX_EDGES || check_every < 1 || (udeg && udeg != degmax))
    return (int)cudaErrorInvalidValue;
  float* tif = static_cast<float*>(ti);
  float* tpf = static_cast<float*>(tp);
  Row<C2V>* cv = static_cast<Row<C2V>*>(c2v);
  int* c = static_cast<int*>(ctl);
  const int* tab = static_cast<const int*>(tables);
  const int* mi = static_cast<const int*>(min_it);
  const int info_tiles = (k + 31) / 32;
  const dim3 tiles(info_tiles + q * 12, (batch + 31) / 32);
  const dim3 tile_threads(32, 8);
  stage_in<In><<<tiles, tile_threads, 0, st>>>(
      static_cast<const In*>(llr), tif, tpf, c, dm, batch, k, info_tiles,
      max_iters,
      adaptive ? CTL_HDR + CTL_VOTE * ((max_iters + check_every - 1) /
                                       check_every)
               : 4);
  cudaError_t e = cudaErrorInvalidValue;
  switch (udeg) {
#define LDPC_CASE(D)                                                        \
  case D:                                                                   \
    e = sweeps<C2V, ARGMIN, D>(tif, tpf, cv, c, tab, dm, mi, batch,         \
                               max_iters, check_every, min_iters, adaptive, \
                               count, smem, offset, st);                    \
    break;
    LDPC_CASE(0)
    LDPC_UNIFORM(LDPC_CASE)
#undef LDPC_CASE
    default:
      break;
  }
  if (e != cudaSuccess) return (int)e;
  stage_out<<<tiles, tile_threads, 0, st>>>(
      tif, tpf, static_cast<uint8_t*>(bits), dm, batch, k, info_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA may use (tables + totals).
int ldpc_layered_smem_limit(void) { return SMEM_LIMIT - SMEM_STATIC; }

// The table layout this source was compiled with, for the packer to hold
// its own constants against.
void ldpc_layered_layout(int* out) {
  const int layout[] = {HDR,      SRC_EARLY, SRC_CARRY_SELF, SRC_CARRY_PREV,
                        SRC_LATE, MAX_EDGES, PHASE_LO_EDGES};
  for (int i = 0; i < 7; ++i) out[i] = layout[i];
}

// 1 if the mixed-degree kernel has a layer body for this row degree.
int ldpc_layered_has_degree(int deg) { return has_degree(deg) ? 1 : 0; }

// 1 if a kernel is compiled for codes whose layers all have this degree.
int ldpc_layered_has_uniform(int deg) { return has_uniform(deg) ? 1 : 0; }

// Bytes of one check's stored messages for 2- or 4-byte c2v.
int ldpc_layered_row_bytes(int c2v_bytes) {
  return c2v_bytes == 2 ? (int)sizeof(Row<__nv_bfloat16>)
                        : (int)sizeof(Row<float>);
}

#ifdef LDPC_PROFILE
// Read and clear the profile: cycles of CTA 0's thread 0 in the four parts
// of a layer, and the layers it ran.
int ldpc_layered_profile(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[5] = {0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(g_prof, zero, sizeof(zero));
}
#endif

const char* ldpc_layered_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K1: llr (n, B) bf16, bf16 c2v, adaptive exit; `count`: the lockstep
// counters in ctl.
int ldpc_k1_decode(const void* llr, void* bits, void* ti, void* tp,
                   void* c2v, void* ctl, const void* tables,
                   const void* min_it, int batch, int n, int k, int n_groups,
                   int q, int degmax, int max_iters, int check_every,
                   int min_iters, int udeg, int count, float offset,
                   void* stream) {
  return decode<__nv_bfloat16, __nv_bfloat16, false>(
      llr, bits, ti, tp, c2v, ctl, tables, min_it, batch, n, k, n_groups, q,
      degmax, max_iters, check_every, min_iters, true, count != 0, udeg,
      offset, stream);
}

// K2: llr (n, B) f32, bf16 c2v, adaptive exit; `count` as K1's.
int ldpc_k2_decode(const void* llr, void* bits, void* ti, void* tp,
                   void* c2v, void* ctl, const void* tables,
                   const void* min_it, int batch, int n, int k, int n_groups,
                   int q, int degmax, int max_iters, int check_every,
                   int min_iters, int udeg, int count, float offset,
                   void* stream) {
  return decode<float, __nv_bfloat16, false>(
      llr, bits, ti, tp, c2v, ctl, tables, min_it, batch, n, k, n_groups, q,
      degmax, max_iters, check_every, min_iters, true, count != 0, udeg,
      offset, stream);
}

// K3: llr (n, B) f32, bf16 c2v, `iters` sweeps.
int ldpc_k3_decode(const void* llr, void* bits, void* ti, void* tp,
                   void* c2v, void* ctl, const void* tables, int batch, int n,
                   int k, int n_groups, int q, int degmax, int iters,
                   int udeg, float offset, void* stream) {
  return decode<float, __nv_bfloat16, false>(
      llr, bits, ti, tp, c2v, ctl, tables, nullptr, batch, n, k, n_groups, q,
      degmax, iters, 1, 0, false, false, udeg, offset, stream);
}

// K5: llr (n, B) bf16, bf16 c2v, `iters` sweeps.
int ldpc_k5_decode(const void* llr, void* bits, void* ti, void* tp,
                   void* c2v, void* ctl, const void* tables, int batch, int n,
                   int k, int n_groups, int q, int degmax, int iters,
                   int udeg, float offset, void* stream) {
  return decode<__nv_bfloat16, __nv_bfloat16, false>(
      llr, bits, ti, tp, c2v, ctl, tables, nullptr, batch, n, k, n_groups, q,
      degmax, iters, 1, 0, false, false, udeg, offset, stream);
}

// K4: llr (n, B) f32, f32 c2v, `iters` sweeps, the argmin leave-one-out.
int ldpc_k4_decode(const void* llr, void* bits, void* ti, void* tp,
                   void* c2v, void* ctl, const void* tables, int batch, int n,
                   int k, int n_groups, int q, int degmax, int iters,
                   int udeg, float offset, void* stream) {
  return decode<float, float, true>(
      llr, bits, ti, tp, c2v, ctl, tables, nullptr, batch, n, k, n_groups,
      q, degmax, iters, 1, 0, false, false, udeg, offset, stream);
}

}  // extern "C"
