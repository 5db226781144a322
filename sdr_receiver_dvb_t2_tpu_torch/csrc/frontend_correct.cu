// The front end's slice corrector in one pass, for Hopper (sm_90a): K8.
//
// It replaces no TPU kernel.  The JAX package writes the corrector
// (its `ops/frontend_device._make_slice_corrector`) as element-wise array
// code and XLA fuses it.  Eager PyTorch cannot fuse:
// `ops/frontend_device.SliceCorrector.plain` materialises (F, M,
// slice_len) f32 tensors, 503 MB each at the UK HD mode's 64 frames x 60
// symbols x 32786 samples, and makes over 90 passes over them a step (two
// gathers, the DC/IQ apply, the NCO rotation, a product and a sum per
// plane for each of the 17 taps, the casts), over 100 GB of traffic.  This
// kernel computes the same values, bit for bit, from one read of the raw
// planes and one write of the symbol planes.
//
// What it computes, for frame f, window m and output sample l < out_len:
//   raw index of window position j: e = starts[m] + j, with starts[m]
//   already clamped by the caller (`_window_starts`); x, y = the two raw
//   planes at e, or 0 where e >= n_in (what the plain version's zero pad
//   holds there);
//   i = x - dc_i[f];  q = ((y - dc_q[f]) * g[f] - c[f] * i) * rs[f];
//   cm = cb[f,m]*cr[j] - sb[f,m]*sr[j];  sm = sb[f,m]*cr[j] + cb[f,m]*sr[j];
//   ir = i*cm + q*sm;  qr = q*cm - i*sm;
//   w_t = Horner of tap t's 8 coefficients at mu[m, l] (highest first);
//   out_r[f,m,l] = sum over t = 0..16, in order, of ir[l + t] * w_t, and
//   out_i likewise from qr; stored as f32, or rounded to bf16 (nearest,
//   ties to even).
// cos and sin never run here: cb, sb (per frame and window) and cr, sr
// (per window position) come from the caller, computed by PyTorch.
//
// Same numbers as the plain version.  Every step is one f32 operation in
// the plain version's order (__f*_rn intrinsics; the build has
// --fmad=false, so no multiply-add is contracted); the sum's first term is
// the product itself, as the plain version's first tap is.
//
// What bounds it on the H100: bytes.  At F = 64 frames of 60 windows of
// 32786 raw samples it reads the two f32 raw planes once (1.01 GB) and
// writes the two bf16 symbol planes once (0.50 GB): 0.45 ms a step at
// 3.35 TB/s.  Its arithmetic is ~85 f32 operations per output sample and
// frame (68 for the two 17-tap sums, the DC/IQ apply and the rotation
// once per raw sample), 10.7 G a step: 0.32 ms at 132 SMs x 128 lanes a
// cycle.  The two nearly tie, so the loads have to stay in flight while
// the sums run, and nothing may be computed twice per frame that does not
// depend on the frame.
//
// Design.  A CTA takes one window m and a tile of TL = 1024 output samples
// (4 consecutive ones a thread) and loops over every frame:
//  - the 17 Horner weights of its 4 outputs depend on mu alone, the same
//    for every frame: each thread evaluates them once into 68 registers;
//  - cr and sr of the tile's span (TL + 16 window positions) go to shared
//    memory once;
//  - per frame, each thread holds its 5 raw samples of each plane (span
//    position tid + 256 r), loaded as coalesced 4-byte reads (any element
//    stride, so the interleaved (F, n, 2) input of `make_frontend` reads
//    in place), applies DC/IQ and the rotation once per raw sample and
//    writes ir, qr to shared memory; it then loads the next frame's
//    samples, which stay in flight while the sums run;
//  - each thread reads its 20 rotated values of a plane as five 16-byte
//    shared-memory reads (a warp's reads are conflict-free) and sums each
//    output's taps 0..16 in order; two buffers of rotated values, so one
//    barrier a frame;
//  - 4 outputs are stored at once (8 bytes in bf16, 16 in f32), a warp
//    writing 256 or 512 consecutive bytes of a row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER = 4;                         // outputs of a thread
constexpr int TL = THREADS * PER;              // outputs of a CTA
constexpr int TAPS = 17;                       // the Farrow stencil
constexpr int NC = 8;                          // coefficients a tap
constexpr int SPAN = TL + TAPS - 1;            // window positions a tile reads
constexpr int R = (SPAN + THREADS - 1) / THREADS;  // positions a thread stages
constexpr int CHUNKS = (PER + TAPS - 1) / 4;   // 16-byte reads a plane
static_assert(SPAN % 4 == 0 && (PER + TAPS - 1) % 4 == 0, "16-byte reads");

struct Params {
  const float* xr;          // raw planes: sample e of frame f at
  const float* xi;          //   f*sf + e*se elements
  long long sf, se;
  long long n_in;
  const long long* starts;  // (M,) clamped window starts
  const float* mu;          // (M, out_len)
  const float* dc_i;        // (F,) each
  const float* dc_q;
  const float* g;
  const float* c;
  const float* rs;
  const float* cb;          // (F, M) each
  const float* sb;
  const float* cr;          // (slice_len,) each
  const float* sr;
  void* out_r;              // (F, M, out_len) each, f32 or bf16
  void* out_i;
  int frames, windows, out_len, slice_len, tiles;
  int bf16;                 // store bf16, else f32
  int vec;                  // 4 outputs in one store (aligned rows)
  float coef[TAPS][NC];     // Horner coefficients, highest degree first
};

struct Frame {              // one frame's raw samples and constants
  float x[R], y[R];
  float dci, dcq, g, c, rs, cb, sb;
};

__device__ __forceinline__ void load_frame(const Params& p, int f, int m,
                                           long long e0, Frame& fr) {
  const long long row = (long long)f * p.sf;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = threadIdx.x + THREADS * r;
    const long long e = e0 + j;
    const bool ok = j < SPAN && e < p.n_in;
    fr.x[r] = ok ? __ldg(p.xr + row + e * p.se) : 0.0f;
    fr.y[r] = ok ? __ldg(p.xi + row + e * p.se) : 0.0f;
  }
  fr.dci = __ldg(p.dc_i + f);
  fr.dcq = __ldg(p.dc_q + f);
  fr.g = __ldg(p.g + f);
  fr.c = __ldg(p.c + f);
  fr.rs = __ldg(p.rs + f);
  fr.cb = __ldg(p.cb + (long long)f * p.windows + m);
  fr.sb = __ldg(p.sb + (long long)f * p.windows + m);
}

__device__ __forceinline__ void store4(const Params& p, void* base,
                                       long long at, int l, const float* v) {
  if (p.vec && l + PER <= p.out_len) {
    if (p.bf16) {
      const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
      uint2 w;
      w.x = *reinterpret_cast<const uint32_t*>(&a);
      w.y = *reinterpret_cast<const uint32_t*>(&b);
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(base) + at) = w;
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(base) + at) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    if (l + k >= p.out_len) break;
    if (p.bf16)
      static_cast<__nv_bfloat16*>(base)[at + k] = __float2bfloat16_rn(v[k]);
    else
      static_cast<float*>(base)[at + k] = v[k];
  }
}

__global__ void __launch_bounds__(THREADS, 2)
frontend_correct_kernel(const __grid_constant__ Params p) {
  __shared__ __align__(16) float rot[2][2][SPAN];   // [buffer][plane][pos]
  __shared__ float ncr[SPAN], nsr[SPAN];

  const int tile = blockIdx.x % p.tiles, m = blockIdx.x / p.tiles;
  const int l0 = tile * TL;
  const int tid = threadIdx.x;
  const long long e0 = p.starts[m] + l0;

  for (int j = tid; j < SPAN; j += THREADS) {
    const bool ok = l0 + j < p.slice_len;
    ncr[j] = ok ? p.cr[l0 + j] : 0.0f;
    nsr[j] = ok ? p.sr[l0 + j] : 0.0f;
  }

  // the 17 weights of each of the thread's outputs, once for all frames
  const int l = l0 + PER * tid;
  float w[PER][TAPS];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const float mu =
        l + k < p.out_len ? p.mu[(long long)m * p.out_len + l + k] : 0.0f;
#pragma unroll
    for (int t = 0; t < TAPS; ++t) {
      float v = p.coef[t][0];
#pragma unroll
      for (int d = 1; d < NC; ++d) v = __fadd_rn(__fmul_rn(v, mu), p.coef[t][d]);
      w[k][t] = v;
    }
  }

  Frame fr;
  load_frame(p, 0, m, e0, fr);
  __syncthreads();                                  // ncr, nsr

  for (int f = 0; f < p.frames; ++f) {
    const int buf = f & 1;
    // DC/IQ apply and the rotation, once per raw sample
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = tid + THREADS * r;
      if (j >= SPAN) break;
      const float i = __fsub_rn(fr.x[r], fr.dci);
      const float q = __fmul_rn(
          __fsub_rn(__fmul_rn(__fsub_rn(fr.y[r], fr.dcq), fr.g),
                    __fmul_rn(fr.c, i)),
          fr.rs);
      const float cr = ncr[j], sr = nsr[j];
      const float cm = __fsub_rn(__fmul_rn(fr.cb, cr), __fmul_rn(fr.sb, sr));
      const float sm = __fadd_rn(__fmul_rn(fr.sb, cr), __fmul_rn(fr.cb, sr));
      rot[buf][0][j] = __fadd_rn(__fmul_rn(i, cm), __fmul_rn(q, sm));
      rot[buf][1][j] = __fsub_rn(__fmul_rn(q, cm), __fmul_rn(i, sm));
    }
    // the next frame's samples load while this frame's sums run
    if (f + 1 < p.frames) load_frame(p, f + 1, m, e0, fr);
    __syncthreads();

    const long long at = ((long long)f * p.windows + m) * p.out_len + l;
#pragma unroll
    for (int plane = 0; plane < 2; ++plane) {
      const float4* src =
          reinterpret_cast<const float4*>(&rot[buf][plane][PER * tid]);
      float acc[PER] = {};
      // chunk ch holds positions 4ch..4ch+3 of the thread's 20: output k
      // takes position 4ch + jj as its tap 4ch + jj - k, so the taps of
      // every output come in order 0..16
#pragma unroll
      for (int ch = 0; ch < CHUNKS; ++ch) {
        const float4 v4 = src[ch];
        const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
          for (int k = 0; k < PER; ++k) {
            const int t = 4 * ch + jj - k;
            if (t < 0 || t >= TAPS) continue;
            const float prod = __fmul_rn(v[jj], w[k][t]);
            acc[k] = t == 0 ? prod : __fadd_rn(acc[k], prod);
          }
        }
      }
      if (l < p.out_len) store4(p, plane ? p.out_i : p.out_r, at, l, acc);
    }
  }
}

}  // namespace

extern "C" {

const char* frontend_correct_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// xr, xi: the raw f32 planes, sample e of frame f at f*sf + e*se; starts
// (windows,) int64 window starts, clamped into [0, n - slice_len] of the
// zero-padded length n; mu (windows, out_len); dc_i, dc_q, g, c, rs
// (frames,); cb, sb (frames, windows); cr, sr (slice_len,); all f32 but
// the starts.  out_r, out_i (frames, windows, out_len) contiguous, `elem`
// bytes a value (2: bf16, 4: f32); coef (taps, deg + 1) floats.
// -> 0 or a cudaError_t.
int frontend_correct(const float* xr, const float* xi, long long sf,
                     long long se, long long n_in, const long long* starts,
                     const float* mu, const float* dc_i, const float* dc_q,
                     const float* g, const float* c, const float* rs,
                     const float* cb, const float* sb, const float* cr,
                     const float* sr, void* out_r, void* out_i, int frames,
                     int windows, int out_len, int slice_len,
                     const float* coef, int taps, int deg, int elem,
                     void* stream) {
  if (taps != TAPS || deg + 1 != NC || (elem != 2 && elem != 4) ||
      frames < 1 || windows < 1 || out_len < 1 ||
      slice_len < out_len + TAPS - 1 || n_in < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.xr = xr;
  p.xi = xi;
  p.sf = sf;
  p.se = se;
  p.n_in = n_in;
  p.starts = starts;
  p.mu = mu;
  p.dc_i = dc_i;
  p.dc_q = dc_q;
  p.g = g;
  p.c = c;
  p.rs = rs;
  p.cb = cb;
  p.sb = sb;
  p.cr = cr;
  p.sr = sr;
  p.out_r = out_r;
  p.out_i = out_i;
  p.frames = frames;
  p.windows = windows;
  p.out_len = out_len;
  p.slice_len = slice_len;
  p.tiles = (out_len + TL - 1) / TL;
  p.bf16 = elem == 2;
  p.vec = out_len % PER == 0 &&
          reinterpret_cast<uintptr_t>(out_r) % (PER * elem) == 0 &&
          reinterpret_cast<uintptr_t>(out_i) % (PER * elem) == 0;
  for (int t = 0; t < TAPS; ++t)
    for (int d = 0; d < NC; ++d) p.coef[t][d] = coef[t * NC + d];
  const long long ctas = (long long)p.tiles * windows;
  if (ctas > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  frontend_correct_kernel<<<(unsigned)ctas, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
