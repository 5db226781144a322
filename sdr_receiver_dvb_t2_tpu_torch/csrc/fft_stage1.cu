// FFT stage 1 fused with the twiddle, for Hopper (sm_90a): the port of the
// TPU kernel `s1_kernel` of tools/fft_microbench.py (K6).
//
// A length n = n1*n2 FFT splits (Cooley-Tukey) into a DFT-n1 over the rows
// of each symbol reshaped to (n1, n2), a twiddle, and a DFT-n2 over the
// columns.  This kernel does the first two for every symbol (f, s):
//
//   a = W1^T . y      complex (n1 x n1) . (n1 x n2), as four real bf16
//                     products accumulated in f32
//   b = a * tw        complex elementwise in f32
//   out = bf16(b)     the only rounding to bf16
//
// y_r, y_i, out_r, out_i are (F*S, n1, n2) bf16; W1^T r/i (n1, n1) bf16,
// row k1, column n1; tw r/i (n1, n2) bf16.  a_r and a_i are never rounded
// to bf16 and never leave the SM.
//
// What bounds it on the H100: at n = 32768 (256 x 128) a symbol takes
// 4 * 2 * 256 * 256 * 128 = 67 MFLOP and moves 256 KB (read y, write b), so
// 262 FLOP per byte: just under the card's 295 FLOP per byte, memory and
// tensor cores tie (about 0.6 ms each for 7680 symbols).  Design: one CTA
// per (symbol, block of BN columns), 16 warps, each holding one 32 x 32
// tile of a_r and a_i as f32 tensor-core accumulators (bf16 16x16x16 MMA
// through nvcuda::wmma; Wi is negated in registers, which is exact, so
// a_r = Wr.yr + (-Wi).yi needs one accumulator).  The y tile (all n1 rows of
// the column block) is loaded to shared memory once; W1^T, which every CTA
// reads whole and which stays in L2, streams through shared memory in
// chunks of 32 columns.  The epilogue passes each accumulator fragment
// through a per-warp shared scratch, applies the twiddle in f32 (separate
// multiplies and subtract/add: the build has --fmad=false) and writes bf16.
// Loads are synchronous and single-buffered: no cp.async, TMA or wgmma yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr int KC = 32;         // columns of W1^T staged per step
constexpr int W_LD = KC + 8;   // padded leading dimensions (bank conflicts)
constexpr int PAD = 8;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// Copy `rows` rows of `row_vec` 16-byte vectors from global (row stride
// g_ld elements) to shared (row stride s_ld elements), all threads.
__device__ __forceinline__ void copy_rows(const __nv_bfloat16* g, int g_ld,
                                          __nv_bfloat16* s, int s_ld,
                                          int rows, int row_vec) {
  for (int i = threadIdx.x; i < rows * row_vec; i += THREADS) {
    const int r = i / row_vec, v = i % row_vec;
    *reinterpret_cast<uint4*>(s + r * s_ld + v * 8) =
        *reinterpret_cast<const uint4*>(g + (size_t)r * g_ld + v * 8);
  }
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
stage1(const __nv_bfloat16* __restrict__ yr, const __nv_bfloat16* __restrict__ yi,
       const __nv_bfloat16* __restrict__ w1r, const __nv_bfloat16* __restrict__ w1i,
       const __nv_bfloat16* __restrict__ twr, const __nv_bfloat16* __restrict__ twi,
       __nv_bfloat16* __restrict__ br, __nv_bfloat16* __restrict__ bi,
       int n1, int n2) {
  constexpr int Y_LD = BN + PAD;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* s_yr = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_yi = s_yr + n1 * Y_LD;
  __nv_bfloat16* s_wr = s_yi + n1 * Y_LD;
  __nv_bfloat16* s_wi = s_wr + n1 * W_LD;
  float* s_out = reinterpret_cast<float*>(s_wi + n1 * W_LD);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t sym = blockIdx.x;
  const int col0 = blockIdx.y * BN;
  const __nv_bfloat16* gyr = yr + sym * n1 * n2 + col0;
  const __nv_bfloat16* gyi = yi + sym * n1 * n2 + col0;

  // this warp's 32 x 32 tile of the (n1, BN) CTA tile, if it has one
  constexpr int COL_TILES = BN / 32;
  const int n_tiles = (n1 / 32) * COL_TILES;
  const bool has_tile = warp < n_tiles;
  const int row_w = (warp / COL_TILES) * 32;
  const int col_w = (warp % COL_TILES) * 32;

  FragC acc_r[2][2], acc_i[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(acc_r[i][j], 0.0f);
      wmma::fill_fragment(acc_i[i][j], 0.0f);
    }

  copy_rows(gyr, n2, s_yr, Y_LD, n1, BN / 8);
  copy_rows(gyi, n2, s_yi, Y_LD, n1, BN / 8);

  for (int k0 = 0; k0 < n1; k0 += KC) {
    __syncthreads();  // the previous chunk's fragments are loaded
    copy_rows(w1r + k0, n1, s_wr, W_LD, n1, KC / 8);
    copy_rows(w1i + k0, n1, s_wi, W_LD, n1, KC / 8);
    __syncthreads();
    if (has_tile) {
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        FragA wr[2], wi[2], nwi[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          wmma::load_matrix_sync(wr[i], s_wr + (row_w + 16 * i) * W_LD + kk,
                                 W_LD);
          wmma::load_matrix_sync(wi[i], s_wi + (row_w + 16 * i) * W_LD + kk,
                                 W_LD);
#pragma unroll
          for (int e = 0; e < wi[i].num_elements; ++e)
            nwi[i].x[e] = __hneg(wi[i].x[e]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          FragB fr, fi;
          const int off = (k0 + kk) * Y_LD + col_w + 16 * j;
          wmma::load_matrix_sync(fr, s_yr + off, Y_LD);
          wmma::load_matrix_sync(fi, s_yi + off, Y_LD);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            wmma::mma_sync(acc_r[i][j], wr[i], fr, acc_r[i][j]);
            wmma::mma_sync(acc_r[i][j], nwi[i], fi, acc_r[i][j]);
            wmma::mma_sync(acc_i[i][j], wr[i], fi, acc_i[i][j]);
            wmma::mma_sync(acc_i[i][j], wi[i], fr, acc_i[i][j]);
          }
        }
      }
    }
  }
  if (!has_tile) return;

  // epilogue: fragment -> per-warp scratch -> twiddle in f32 -> bf16
  float* sr = s_out + warp * 512;
  float* si = sr + 256;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(sr, acc_r[i][j], 16, wmma::mem_row_major);
      wmma::store_matrix_sync(si, acc_i[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = row_w + 16 * i + (e >> 4);
        const int col = col0 + col_w + 16 * j + (e & 15);
        const float ar = sr[e], ai = si[e];
        const float tr = __bfloat162float(twr[row * n2 + col]);
        const float ti = __bfloat162float(twi[row * n2 + col]);
        const size_t o = (sym * n1 + row) * n2 + col;
        br[o] = __float2bfloat16_rn(ar * tr - ai * ti);
        bi[o] = __float2bfloat16_rn(ar * ti + ai * tr);
      }
      __syncwarp();
    }
}

template <int BN>
int launch(const void* yr, const void* yi, const void* w1r, const void* w1i,
           const void* twr, const void* twi, void* br, void* bi, int n_sym,
           int n1, int n2, cudaStream_t st) {
  const size_t smem = (size_t)2 * n1 * (BN + PAD) * sizeof(__nv_bfloat16) +
                      (size_t)2 * n1 * W_LD * sizeof(__nv_bfloat16) +
                      (size_t)WARPS * 512 * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      stage1<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  typedef const __nv_bfloat16* P;
  stage1<BN><<<dim3(n_sym, n2 / BN), THREADS, smem, st>>>(
      static_cast<P>(yr), static_cast<P>(yi), static_cast<P>(w1r),
      static_cast<P>(w1i), static_cast<P>(twr), static_cast<P>(twi),
      static_cast<__nv_bfloat16*>(br), static_cast<__nv_bfloat16*>(bi), n1,
      n2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* fft_stage1_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// 0 if (n1, n2) is a shape the kernel takes: n1 a multiple of 32 up to 256
// with at most 16 warp tiles, n2 a multiple of 32.
int fft_stage1_supported(int n1, int n2) {
  if (n1 < 32 || n1 > 256 || n1 % 32 || n2 < 32 || n2 % 32) return 1;
  return 0;
}

// y_r, y_i (n_sym, n1, n2) -> b_r, b_i (n_sym, n1, n2), all bf16, 16-byte
// aligned and contiguous; W1^T r/i (n1, n1), tw r/i (n1, n2) bf16.
int fft_stage1(const void* yr, const void* yi, const void* w1r,
               const void* w1i, const void* twr, const void* twi, void* br,
               void* bi, int n_sym, int n1, int n2, void* stream) {
  if (fft_stage1_supported(n1, n2) != 0 || n_sym < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n2 % 64 == 0)
    return launch<64>(yr, yi, w1r, w1i, twr, twi, br, bi, n_sym, n1, n2, st);
  return launch<32>(yr, yi, w1r, w1i, twr, twi, br, bi, n_sym, n1, n2, st);
}

}  // extern "C"
