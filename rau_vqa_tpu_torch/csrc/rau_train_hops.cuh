// Device code of the training hop loop's forward kernel
// (rau_train_hops_fwd.cu): the block's float32 tile GEMM, the small vector
// products, the shared-memory layout, and one training hop's forward
// (_hop_fwd_core, rau_vqa_tpu/ops/rau_train_hops.py:104-167).  The backward
// (rau_train_hops_bwd.cu) takes the weight order, Dims, Dropout and the warp
// reductions from here; it rematerializes each hop with its own batch-wide
// phases (tile_gemm.cuh), which sum in another order than hop_forward does.
//
// Everything is templated on T, the products' operand type (JAX's dot_dtype,
// :299): float, or __nv_bfloat16 for compute_dtype "bfloat16".  q, feats and
// the weights arrive in T.  Every product reads its operands through rnd<T>
// (round to T, back to float) or ldf (T to float) and sums them with float32
// FMAs: a product of two bf16 values is exact in float32, so this is JAX's
// bf16 x bf16 -> f32 dot up to the order of the sums.  Operands are rounded
// where they are loaded for a product, never where they are stored: the
// workspace, the carries and the shared vectors keep float32 values, which
// the pooling, the softmax and the elementwise math read unrounded.  With
// T = float, rnd and ldf are plain loads and the code is the float32 kernel.
//
// One block owns one batch row.  A row's [S, *] activations (ifeat and
// addfeat) do not fit in shared memory (one ifeat row alone is 196 x 512 x 4
// = 401 KB), so they live in a per-block workspace in device memory, which
// stays in L2 while the block works on it; only vectors of length Q, M, F, S,
// 4R and the GEMM tiles are in shared memory.  Weights stream from L2.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "maskgen.cuh"

namespace rth {

constexpr int NT = 256;  // threads per block
constexpr int NWARP = NT / 32;

// weight order of rau_vqa_tpu/ops/rau_train_hops.py _FWD_WEIGHTS (:53-65)
enum {
  Q_W, Q_B, H_W, H_B, I_W, I_B, AQ_W, AQ_B, AI_W, AI_B, AS_W, AS_B, AM_W, AM_B,
  AP_W, AP_B, L_WI, L_BI, L_WH, L_BH, MG_W, MG_B, CLS_W, CLS_B, DP_W, DP_B,
  NWEIGHTS
};

template <class T>
struct Weights {
  const T* p[NWEIGHTS];
};

// an operand of type T as float32
__device__ __forceinline__ float ldf(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
// a float32 value rounded to T (round to nearest even, as JAX's astype)
template <class T>
__device__ __forceinline__ float rnd(float x) { return x; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ void stf(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void stf(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

struct Dims {
  int B, Q, S, Dc, M, F, R, A, H;
};

// the hop loop's dropout: one seed, one rate for all three sites
struct Dropout {
  uint32_t seed, thresh;
  float scale;
  bool on;
  __device__ maskgen::Site site(int hop, int which) const {
    return {maskgen::site_salt(seed, hop, which), thresh, scale, on};
  }
};

__device__ __forceinline__ float sigm(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// Shared memory: float vectors, 16-byte aligned segments
// ---------------------------------------------------------------------------

constexpr int BM = 64, BN = 64, BK = 16;  // GEMM tile; 16 x 16 threads of 4 x 4
constexpr int TILE_LD = BM + 4;           // padded row of a k-slice

struct Smem {
  float *qd, *qfeat, *qatt, *sc, *join, *gates, *c, *h, *cn, *hn, *merge, *As, *Bs;

  // Lays the segments out from `base` (nullptr on the host just counts);
  // returns the float count.
  __host__ __device__ static float* take(float* base, size_t& off, size_t n) {
    float* p = base ? base + off : nullptr;
    off += (n + 3) & ~size_t(3);
    return p;
  }
  __host__ __device__ static size_t carve(float* base, const Dims& d, Smem* s) {
    size_t off = 0;
    s->qd = take(base, off, d.Q);
    s->qfeat = take(base, off, d.M);
    s->qatt = take(base, off, d.F);
    s->sc = take(base, off, d.S);
    s->join = take(base, off, d.M);
    s->gates = take(base, off, 4 * d.R);
    s->c = take(base, off, d.R);
    s->h = take(base, off, d.R);
    s->cn = take(base, off, d.R);
    s->hn = take(base, off, d.R);
    s->merge = take(base, off, d.M);
    s->As = take(base, off, BK * TILE_LD);
    s->Bs = take(base, off, BK * TILE_LD);
    return off;
  }
};

// ---------------------------------------------------------------------------
// Block GEMM: for every (m, n) of [Mdim, Ndim], epi(m, n, sum_k a(m,k) b(k,n))
// with the sum in float32 in ascending k.  A_KC: a's k index is the
// contiguous one in memory (else m is); B_NC: b's n index is (else k is).
// The loaders pick the thread layout that reads memory coalesced.
// ---------------------------------------------------------------------------

template <bool A_KC, bool B_NC, class LA, class LB, class EPI>
__device__ void block_gemm(int Mdim, int Ndim, int Kdim, LA a, LB b, EPI epi,
                           float* As, float* Bs) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int mt = (Mdim + BM - 1) / BM, nt = (Ndim + BN - 1) / BN;
  for (int tile = 0; tile < mt * nt; ++tile) {
    const int m0 = (tile / nt) * BM, n0 = (tile % nt) * BN;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < Kdim; k0 += BK) {
#pragma unroll
      for (int i = 0; i < (BM * BK) / NT; ++i) {
        const int e = tid + NT * i;
        const int kk = A_KC ? e % BK : e / BM;
        const int mm = A_KC ? e / BK : e % BM;
        const int m = m0 + mm, k = k0 + kk;
        As[kk * TILE_LD + mm] = (m < Mdim && k < Kdim) ? a(m, k) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < (BN * BK) / NT; ++i) {
        const int e = tid + NT * i;
        const int kk = B_NC ? e / BN : e % BK;
        const int nn = B_NC ? e % BN : e / BK;
        const int n = n0 + nn, k = k0 + kk;
        Bs[kk * TILE_LD + nn] = (n < Ndim && k < Kdim) ? b(k, n) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 av = *reinterpret_cast<const float4*>(As + kk * TILE_LD + ty * 4);
        const float4 bv = *reinterpret_cast<const float4*>(Bs + kk * TILE_LD + tx * 4);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = m0 + ty * 4 + i, n = n0 + tx * 4 + j;
        if (m < Mdim && n < Ndim) epi(m, n, acc[i][j]);
      }
  }
  __syncthreads();
}

// x[K] (shared) @ W[K, N] column n, ascending k, x rounded to T.
template <class T>
__device__ __forceinline__ float dot_col(const float* x, int K, const T* w, int N,
                                         int n) {
  float acc = 0.f;
  for (int k = 0; k < K; ++k) acc = fmaf(rnd<T>(x[k]), ldf(w, (size_t)k * N + n), acc);
  return acc;
}

// x[K] (shared) @ W[N, K]^T row n, x rounded to T, one warp (lane-strided,
// then a warp sum).
template <class T>
__device__ __forceinline__ float dot_row_warp(const float* x, int K, const T* w, int n) {
  const int lane = threadIdx.x % 32;
  const size_t row = (size_t)n * K;
  float acc = 0.f;
  for (int k = lane; k < K; k += 32) acc = fmaf(rnd<T>(x[k]), ldf(w, row + k), acc);
  return warp_sum(acc);
}

// ---------------------------------------------------------------------------
// One training hop for row b (_hop_fwd_core), from the carry in s.c / s.h.
// Leaves in shared memory: qd, qfeat, qatt, sc = attprob, join, gates = the
// activated gates [i, g, f, o], cn / hn = the new carry, merge = merge_d; in
// the workspace: ifeat [S, M] and addfeat [S, F].  Ends synchronized.
// ---------------------------------------------------------------------------

template <class T>
__device__ void hop_forward(const Dims& d, const Weights<T>& W, const Dropout& dr,
                            int b, int hop, const T* __restrict__ q_row,
                            const T* __restrict__ feats_row, float* ifeat,
                            float* addfeat, const Smem& s) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int Q = d.Q, S = d.S, Dc = d.Dc, M = d.M, F = d.F, R = d.R;
  const maskgen::Site fm = dr.site(hop, maskgen::SITE_FEATS);
  const maskgen::Site qm = dr.site(hop, maskgen::SITE_Q);
  const maskgen::Site mm = dr.site(hop, maskgen::SITE_MERGE);

  // q_d = q * qmask
  for (int k = tid; k < Q; k += NT) s.qd[k] = qm.apply(ldf(q_row, k), (uint32_t)b * Q + k);
  __syncthreads();
  // qfeat = tanh(q_d Wq + bq + h Wh + bh)
  for (int n = tid; n < M; n += NT) {
    const float a = dot_col(s.qd, Q, W.p[Q_W], M, n);
    const float c = dot_col(s.h, R, W.p[H_W], M, n);
    s.qfeat[n] = tanhf(((a + ldf(W.p[Q_B], n)) + c) + ldf(W.p[H_B], n));
  }
  __syncthreads();
  // qatt = qfeat Waq + baq;  memory score h Wmem (its biases come later)
  for (int n = tid; n < F; n += NT)
    s.qatt[n] = dot_col(s.qfeat, M, W.p[AQ_W], F, n) + ldf(W.p[AQ_B], n);
  for (int n = tid; n < S; n += NT) s.sc[n] = dot_col(s.h, R, W.p[AM_W], S, n);
  __syncthreads();

  // ifeat = tanh((feats * fmask) Wi + bi)            [S, Dc] x [Dc, M]
  {
    const T* wi = W.p[I_W];
    const T* bi = W.p[I_B];
    const uint32_t base = (uint32_t)b * (uint32_t)(S * Dc);
    block_gemm<true, true>(
        S, M, Dc,
        [&](int m, int k) {
          const int e = m * Dc + k;
          return rnd<T>(fm.apply(ldf(feats_row, e), base + (uint32_t)e));
        },
        [&](int k, int n) { return ldf(wi, (size_t)k * M + n); },
        [&](int m, int n, float acc) { ifeat[(size_t)m * M + n] = tanhf(acc + ldf(bi, n)); },
        s.As, s.Bs);
  }
  // addfeat = tanh((ifeat Wa + ba) + qatt)           [S, M] x [M, F]
  {
    const T* wa = W.p[AI_W];
    const T* ba = W.p[AI_B];
    const float* qatt = s.qatt;
    block_gemm<true, true>(
        S, F, M, [&](int m, int k) { return rnd<T>(ifeat[(size_t)m * M + k]); },
        [&](int k, int n) { return ldf(wa, (size_t)k * F + n); },
        [&](int m, int n, float acc) {
          addfeat[(size_t)m * F + n] = tanhf((acc + ldf(ba, n)) + qatt[n]);
        },
        s.As, s.Bs);
  }
  // attention score: ((addfeat w_score + b_score) + h Wmem) + b_mem, warp per cell
  {
    const T* ws = W.p[AS_W];
    const float b_score = ldf(W.p[AS_B], 0);
    for (int cell = warp; cell < S; cell += NWARP) {
      const float* row = addfeat + (size_t)cell * F;
      float acc = 0.f;
      for (int f = lane; f < F; f += 32) acc = fmaf(rnd<T>(row[f]), ldf(ws, f), acc);
      acc = warp_sum(acc);
      if (lane == 0) s.sc[cell] = ((acc + b_score) + s.sc[cell]) + ldf(W.p[AM_B], cell);
    }
  }
  __syncthreads();
  // softmax over S, one warp
  if (warp == 0) {
    float mx = __int_as_float(0xff800000);  // -inf
    for (int i = lane; i < S; i += 32) mx = fmaxf(mx, s.sc[i]);
    mx = warp_max(mx);
    float den = 0.f;
    for (int i = lane; i < S; i += 32) {
      const float e = expf(s.sc[i] - mx);
      s.sc[i] = e;
      den += e;
    }
    den = warp_sum(den);
    for (int i = lane; i < S; i += 32) s.sc[i] = s.sc[i] / den;
  }
  __syncthreads();
  // join = ((qfeat + sum_s ifeat p_s) + p Wp) + bp
  for (int n = tid; n < M; n += NT) {
    float pool = 0.f;
    for (int i = 0; i < S; ++i) pool = fmaf(ifeat[(size_t)i * M + n], s.sc[i], pool);
    const float proj = dot_col(s.sc, S, W.p[AP_W], M, n);
    s.join[n] = ((s.qfeat[n] + pool) + proj) + ldf(W.p[AP_B], n);
  }
  __syncthreads();
  // ATTLSTM gates = ((join Wi + bi) + h Wh) + bh
  for (int n = tid; n < 4 * R; n += NT) {
    const float a = dot_col(s.join, M, W.p[L_WI], 4 * R, n);
    const float c = dot_col(s.h, R, W.p[L_WH], 4 * R, n);
    s.gates[n] = ((a + ldf(W.p[L_BI], n)) + c) + ldf(W.p[L_BH], n);
  }
  __syncthreads();
  // cell update, gate layout [i, g, f, o]; gates keep their activations
  for (int j = tid; j < R; j += NT) {
    const float ig = sigm(s.gates[j]);
    const float gt = tanhf(s.gates[R + j]);
    const float fg = sigm(s.gates[2 * R + j]);
    const float og = sigm(s.gates[3 * R + j]);
    const float c = fg * s.c[j] + ig * gt;
    s.cn[j] = c;
    s.hn[j] = og * tanhf(c);
    s.gates[j] = ig;
    s.gates[R + j] = gt;
    s.gates[2 * R + j] = fg;
    s.gates[3 * R + j] = og;
  }
  __syncthreads();
  // merge_d = ((join + h' Wmg) + bmg) * mmask
  for (int n = tid; n < M; n += NT) {
    const float pre = (s.join[n] + dot_col(s.hn, R, W.p[MG_W], M, n)) + ldf(W.p[MG_B], n);
    s.merge[n] = mm.apply(pre, (uint32_t)b * M + n);
  }
  __syncthreads();
}

}  // namespace rth
