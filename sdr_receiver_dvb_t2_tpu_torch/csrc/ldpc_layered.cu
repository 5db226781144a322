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
//      order; its two-minimum scan runs over degmax + 2 slots with +BIG
//      messages in the unused info slots and takes the leave-one-out
//      minimum through the argmin of the strict-< scan;
//   K5 make_decoder_nb_fused_io: K3 with the LLRs staged in as bf16 (K1's
//      input stage): the totals start from bf16-rounded LLRs.
//
// Same arithmetic as the TPU kernels, operation for operation: f32 totals
// and messages, new c2v rounded to bf16 (K1-K3, __float2bfloat16_rn) or kept
// in f32 (K4), the stored value fed to the totals, offset 0.5, edges written
// back in table order.  Built with --fmad=false so no multiply-add
// contraction changes a rounding.
//
// Layout (codeword-major, so threads along the check index u read
// contiguous addresses):
//   ti  (B, G, 360)     f32  info-group totals (staged in shared memory)
//   tp  (B, q, 360)     f32  parity totals, tp[t][u] = bit k + t + q*u
//   c2v (B, q, E, 360)  bf16 or f32 messages; slot j < deg is info edge j
//                            of layer t, slot deg the parity self edge,
//                            deg+1 the parity-prev edge (E = degmax + 2)
//   ctl (4,)            i32  done flag, sweep count, bad-check sum, CTAs
//                            arrived at the exit vote
//
// What bounds it on the H100: device-memory traffic.  At the bench code
// (NORMAL C2/3, q=60, G=120, E=10) one codeword holds 173 KB of info
// totals, 86 KB of parity totals and 432 KB of bf16 c2v (864 KB in f32);
// at B=128 that is 88 MB (K4 at NORMAL C3/5: 146 MB of f32 c2v), more than
// one SM's 227 KB of shared memory and more than the 50 MB L2.  Design: one
// CTA per codeword (384 threads, thread u owns check row u of every layer).
// The info totals, which every edge reads through a cyclic roll and updates
// read-modify-write, live in the CTA's shared memory for a whole sweep
// chunk; c2v and the parity totals stream from device memory with coalesced
// row accesses.  Layers run in the static layer order inside the kernel;
// edges of one layer that hit the same group are separated by a barrier so
// the additive write-backs keep their order.
//
// Adaptive exit (K1, K2): the host enqueues ceil(max_iters / check_every)
// chunk launches without reading anything back.  A chunk launch returns
// immediately when the done flag is set; otherwise it runs check_every
// sweeps and, once the sweep count reaches the floor max(min_it,
// min_iters), counts its codeword's failed checks.  The last CTA to arrive
// sets done when the batch total is 0 (threadfence reduction: integer
// atomics, exact in any order).  Fixed exit (K3, K4, K5): one launch runs
// all sweeps and checks nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NU = 360;       // rows of a QC tile (checks per layer)
constexpr int THREADS = 384;  // NU rounded up to whole warps
constexpr int EMAX = 24;      // >= degmax + 2 of every DVB-T2 code (22)
constexpr float BIG = 1e9f;

struct Tables {
  const int* deg;    // (q,)
  const int* eg;     // (q, degmax) group of each info edge
  const int* es;     // (q, degmax) shift of each info edge
  const int* order;  // (q,) layer visitation order
  const int* dup;    // (q,) 1 if a group repeats within the layer
  int q, degmax, E, G;
};

__device__ __forceinline__ int wrap(int v) { return v < 0 ? v + NU : v; }

__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load(const float* p) { return *p; }

// Store a new message in the c2v storage type; returns the stored value,
// which is what feeds the totals.
__device__ __forceinline__ float store(__nv_bfloat16* p, float v) {
  const __nv_bfloat16 s = __float2bfloat16_rn(v);
  *p = s;
  return __bfloat162float(s);
}
__device__ __forceinline__ float store(float* p, float v) {
  *p = v;
  return v;
}

// One check layer t of the layered schedule for this CTA's codeword.
// ARGMIN selects K4's scan (see the header).
template <typename C2V, bool ARGMIN>
__device__ void layer(const Tables& tb, int t, float offset, float* s_ti,
                      float* tp, C2V* c2v) {
  const int u = threadIdx.x;
  const bool active = u < NU;
  const int deg = __ldg(tb.deg + t);
  const int et = deg + 2;
  const int* eg = tb.eg + t * tb.degmax;
  const int* es = tb.es + t * tb.degmax;
  C2V* cv = c2v + (size_t)t * tb.E * NU;
  const int q = tb.q;

  float m[EMAX], old[EMAX], nw[EMAX];
  if (active) {
    // pass 1: v2c messages (pre-layer totals minus the old c2v)
    const float self_p = tp[t * NU + u];
    const float prev_p = t > 0 ? tp[(t - 1) * NU + u]
                               : tp[(q - 1) * NU + (u == 0 ? NU - 1 : u - 1)];
    float m_self = 0.0f, m_prev = 0.0f;
#pragma unroll
    for (int j = 0; j < EMAX; ++j) {
      if (j < et) {
        old[j] = load(cv + j * NU + u);
        if (j < deg) {
          m[j] = s_ti[__ldg(eg + j) * NU + wrap(u - __ldg(es + j))] - old[j];
        } else if (j == deg) {
          m[j] = self_p - old[j];
          m_self = m[j];
        } else {
          float v = prev_p - old[j];
          // check 0 has no previous parity: +BIG on u == 0 at t == 0
          if (t == 0) v = v + (u == 0 ? BIG : 0.0f);
          m[j] = v;
          m_prev = v;
        }
      }
    }
    // two minima and the sign parity across the row
    float min1 = fabsf(m[0]);
    float min2 = BIG;
    int nneg = m[0] < 0.0f;
    int amin = 0;
    if (ARGMIN) {
      // K4's scan positions: info edges 0..deg-1, +BIG at deg..degmax-1,
      // parity self at degmax, parity prev at degmax+1
#pragma unroll
      for (int p = 1; p < EMAX; ++p) {
        if (p < tb.E) {
          const float v = p < deg ? m[p]
                          : p < tb.degmax ? BIG
                          : p == tb.degmax ? m_self : m_prev;
          const float a = fabsf(v);
          const bool is_new = a < min1;
          min2 = is_new ? min1 : fminf(min2, a);
          min1 = is_new ? a : min1;
          amin = is_new ? p : amin;
          nneg += v < 0.0f;
        }
      }
    } else {
#pragma unroll
      for (int j = 1; j < EMAX; ++j) {
        if (j < et) {
          const float a = fabsf(m[j]);
          const bool is_new = a < min1;
          min2 = is_new ? min1 : fminf(min2, a);
          min1 = is_new ? a : min1;
          nneg += m[j] < 0.0f;
        }
      }
    }
    const float sign_all = (nneg & 1) ? -1.0f : 1.0f;
    const float mag1 = fmaxf(min1 - offset, 0.0f);
    const float mag2 = fmaxf(min2 - offset, 0.0f);
    // new c2v, leave-one-out: K4 gives min2 to the argmin position; K1-K3
    // give it to every edge with |m| == min1 (ties make min2 == min1, so
    // no argmin is needed)
#pragma unroll
    for (int j = 0; j < EMAX; ++j) {
      if (j < et) {
        float loo;
        if (ARGMIN) {
          const int pos = j < deg ? j : tb.degmax + (j - deg);
          loo = amin == pos ? mag2 : mag1;
        } else {
          loo = fabsf(m[j]) <= min1 ? mag2 : mag1;
        }
        const float sg = m[j] < 0.0f ? -sign_all : sign_all;
        nw[j] = store(cv + j * NU + u, sg * loo);
      }
    }
  }
  __syncthreads();  // every pass-1 read of s_ti precedes the write-backs
  // pass 2: additive write-back through the inverse roll, edge by edge
  const bool dup = __ldg(tb.dup + t) != 0;
#pragma unroll
  for (int j = 0; j < EMAX; ++j) {
    if (j < deg) {
      if (active) {
        float* p = s_ti + __ldg(eg + j) * NU + wrap(u - __ldg(es + j));
        *p = *p + (nw[j] - old[j]);
      }
      if (dup) __syncthreads();  // same group again later in this layer
    }
  }
  if (active) {
#pragma unroll
    for (int j = 0; j < EMAX; ++j) {
      if (j == deg) tp[t * NU + u] = m[j] + nw[j];
      if (j == deg + 1) {
        const float pn = m[j] + nw[j];
        if (t > 0) {
          tp[(t - 1) * NU + u] = pn;
        } else if (u > 0) {
          // aligned slot u is parity bit (q-1, u-1); u == 0 is the masked
          // non-edge, so tp[q-1][359] keeps its value
          tp[(q - 1) * NU + u - 1] = pn - 0.0f;
        }
      }
    }
  }
  __syncthreads();
}

// Failed parity checks of this CTA's codeword (per thread; reduced later).
__device__ int syndrome(const Tables& tb, const float* s_ti, const float* tp) {
  const int u = threadIdx.x;
  if (u >= NU) return 0;
  int bad = 0;
  for (int t = 0; t < tb.q; ++t) {
    int acc = tp[t * NU + u] < 0.0f;
    const int deg = __ldg(tb.deg + t);
    for (int j = 0; j < deg; ++j) {
      const int g = __ldg(tb.eg + t * tb.degmax + j);
      const int s = __ldg(tb.es + t * tb.degmax + j);
      acc += s_ti[g * NU + wrap(u - s)] < 0.0f;
    }
    if (t > 0) {
      acc += tp[(t - 1) * NU + u] < 0.0f;
    } else if (u > 0) {
      acc += tp[(tb.q - 1) * NU + u - 1] < 0.0f;
    }
    bad += acc & 1;
  }
  return bad;
}

// (B, n) LLRs (bf16 for K1 and K5, f32 for K2-K4) -> f32 totals.
template <typename In>
__global__ void __launch_bounds__(THREADS)
stage_in(const In* __restrict__ llr, float* ti, float* tp, int* ctl,
         Tables tb, int n, int k, int max_iters) {
  const int b = blockIdx.x;
  const In* x = llr + (size_t)b * n;
  float* tib = ti + (size_t)b * tb.G * NU;
  float* tpb = tp + (size_t)b * tb.q * NU;
  for (int i = threadIdx.x; i < tb.G * NU; i += blockDim.x)
    tib[i] = load(x + i);
  for (int i = threadIdx.x; i < tb.q * NU; i += blockDim.x) {
    const int t = i / NU, u = i % NU;
    tpb[i] = load(x + k + t + tb.q * u);
  }
  if (b == 0 && threadIdx.x == 0) {
    ctl[0] = 0;
    ctl[1] = max_iters;
    ctl[2] = 0;
    ctl[3] = 0;
  }
}

template <typename C2V, bool ARGMIN>
__global__ void __launch_bounds__(THREADS, 1)
sweep_chunk(float* ti, float* tp, C2V* c2v, int* ctl, Tables tb,
            int n_sweeps, int it_now, const int* min_it, int min_iters,
            int check, float offset) {
  extern __shared__ float s_ti[];
  __shared__ int s_red[THREADS / 32];
  __shared__ int s_last;
  if (*(volatile int*)ctl != 0) return;  // batch already converged
  const int b = blockIdx.x;
  float* tib = ti + (size_t)b * tb.G * NU;
  float* tpb = tp + (size_t)b * tb.q * NU;
  C2V* cvb = c2v + (size_t)b * tb.q * tb.E * NU;
  for (int i = threadIdx.x; i < tb.G * NU; i += blockDim.x) s_ti[i] = tib[i];
  __syncthreads();
  for (int it = 0; it < n_sweeps; ++it)
    for (int li = 0; li < tb.q; ++li)
      layer<C2V, ARGMIN>(tb, __ldg(tb.order + li), offset, s_ti, tpb, cvb);
  for (int i = threadIdx.x; i < tb.G * NU; i += blockDim.x) tib[i] = s_ti[i];
  if (!check) return;

  const int floor_it = max(*min_it, min_iters);
  if (it_now < floor_it) return;
  int bad = syndrome(tb, s_ti, tpb);
  for (int o = 16; o > 0; o >>= 1)
    bad += __shfl_down_sync(0xffffffffu, bad, o);
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = bad;
  __syncthreads();
  if (threadIdx.x == 0) {
    int tot = 0;
    for (int w = 0; w < THREADS / 32; ++w) tot += s_red[w];
    atomicAdd(ctl + 2, tot);
    __threadfence();
    s_last = atomicAdd(ctl + 3, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (s_last && threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(ctl + 2, 0) == 0) {
      ctl[0] = 1;
      ctl[1] = it_now;
    }
    ctl[2] = 0;
    ctl[3] = 0;
  }
}

__global__ void __launch_bounds__(THREADS)
stage_out(const float* ti, const float* tp, uint8_t* bits, Tables tb, int n,
          int k) {
  const int b = blockIdx.x;
  const float* tib = ti + (size_t)b * tb.G * NU;
  const float* tpb = tp + (size_t)b * tb.q * NU;
  uint8_t* o = bits + (size_t)b * n;
  for (int i = threadIdx.x; i < tb.G * NU; i += blockDim.x)
    o[i] = tib[i] < 0.0f;
  for (int i = threadIdx.x; i < tb.q * NU; i += blockDim.x) {
    const int t = i / NU, u = i % NU;
    o[k + t + tb.q * u] = tpb[i] < 0.0f;
  }
}

// Decode B codewords: llr (B, n) -> bits (B, n) uint8 and, for the
// adaptive exit, the batch sweep count in ctl[1].  Scratch ti/tp/c2v/ctl as
// laid out above; `tables` packs deg | eg | es | order | dup as int32 on the
// device.  max_iters is the fixed sweep count when !adaptive.
template <typename In, typename C2V, bool ARGMIN>
int decode(const void* llr, void* bits, void* ti, void* tp, void* c2v,
           void* ctl, const void* tables, const void* min_it, int batch,
           int n, int k, int n_groups, int q, int degmax, int max_iters,
           int check_every, int min_iters, bool adaptive, float offset,
           void* stream) {
  const int* tab = static_cast<const int*>(tables);
  Tables tb;
  tb.deg = tab;
  tb.eg = tab + q;
  tb.es = tab + q + q * degmax;
  tb.order = tab + q + 2 * q * degmax;
  tb.dup = tab + 2 * q + 2 * q * degmax;
  tb.q = q;
  tb.degmax = degmax;
  tb.E = degmax + 2;
  tb.G = n_groups;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)n_groups * NU * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      sweep_chunk<C2V, ARGMIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  float* tif = static_cast<float*>(ti);
  float* tpf = static_cast<float*>(tp);
  C2V* cv = static_cast<C2V*>(c2v);
  int* c = static_cast<int*>(ctl);
  e = cudaMemsetAsync(c2v, 0, (size_t)batch * q * tb.E * NU * sizeof(C2V),
                      st);
  if (e != cudaSuccess) return (int)e;
  stage_in<In><<<batch, THREADS, 0, st>>>(static_cast<const In*>(llr), tif,
                                          tpf, c, tb, n, k, max_iters);
  if (adaptive) {
    const int n_chunks = (max_iters + check_every - 1) / check_every;
    for (int ci = 0; ci < n_chunks; ++ci) {
      sweep_chunk<C2V, ARGMIN><<<batch, THREADS, smem, st>>>(
          tif, tpf, cv, c, tb, check_every, (ci + 1) * check_every,
          static_cast<const int*>(min_it), min_iters, 1, offset);
    }
  } else if (max_iters > 0) {
    sweep_chunk<C2V, ARGMIN><<<batch, THREADS, smem, st>>>(
        tif, tpf, cv, c, tb, max_iters, max_iters, nullptr, 0, 0, offset);
  }
  stage_out<<<batch, THREADS, 0, st>>>(tif, tpf, static_cast<uint8_t*>(bits),
                                       tb, n, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Max info groups whose totals fit this kernel's shared memory.
int ldpc_layered_max_groups(void) { return (227 * 1024) / (NU * 4); }

int ldpc_layered_emax(void) { return EMAX; }

const char* ldpc_layered_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K1: llr (B, n) bf16, bf16 c2v, adaptive exit.
int ldpc_k1_decode(const void* llr, void* bits, void* ti, void* tp,
                   void* c2v, void* ctl, const void* tables,
                   const void* min_it, int batch, int n, int k, int n_groups,
                   int q, int degmax, int max_iters, int check_every,
                   int min_iters, float offset, void* stream) {
  return decode<__nv_bfloat16, __nv_bfloat16, false>(
      llr, bits, ti, tp, c2v, ctl, tables, min_it, batch, n, k, n_groups, q,
      degmax, max_iters, check_every, min_iters, true, offset, stream);
}

// K2: llr (B, n) f32, bf16 c2v, adaptive exit.
int ldpc_k2_decode(const void* llr, void* bits, void* ti, void* tp,
                   void* c2v, void* ctl, const void* tables,
                   const void* min_it, int batch, int n, int k, int n_groups,
                   int q, int degmax, int max_iters, int check_every,
                   int min_iters, float offset, void* stream) {
  return decode<float, __nv_bfloat16, false>(
      llr, bits, ti, tp, c2v, ctl, tables, min_it, batch, n, k, n_groups, q,
      degmax, max_iters, check_every, min_iters, true, offset, stream);
}

// K3: llr (B, n) f32, bf16 c2v, `iters` sweeps.
int ldpc_k3_decode(const void* llr, void* bits, void* ti, void* tp,
                   void* c2v, void* ctl, const void* tables, int batch, int n,
                   int k, int n_groups, int q, int degmax, int iters,
                   float offset, void* stream) {
  return decode<float, __nv_bfloat16, false>(
      llr, bits, ti, tp, c2v, ctl, tables, nullptr, batch, n, k, n_groups, q,
      degmax, iters, 1, 0, false, offset, stream);
}

// K5: llr (B, n) bf16, bf16 c2v, `iters` sweeps.
int ldpc_k5_decode(const void* llr, void* bits, void* ti, void* tp,
                   void* c2v, void* ctl, const void* tables, int batch, int n,
                   int k, int n_groups, int q, int degmax, int iters,
                   float offset, void* stream) {
  return decode<__nv_bfloat16, __nv_bfloat16, false>(
      llr, bits, ti, tp, c2v, ctl, tables, nullptr, batch, n, k, n_groups, q,
      degmax, iters, 1, 0, false, offset, stream);
}

// K4: llr (B, n) f32, f32 c2v, `iters` sweeps, the padded argmin scan.
int ldpc_k4_decode(const void* llr, void* bits, void* ti, void* tp,
                   void* c2v, void* ctl, const void* tables, int batch, int n,
                   int k, int n_groups, int q, int degmax, int iters,
                   float offset, void* stream) {
  return decode<float, float, true>(
      llr, bits, ti, tp, c2v, ctl, tables, nullptr, batch, n, k, n_groups,
      q, degmax, iters, 1, 0, false, offset, stream);
}

}  // extern "C"
