// Device helpers of the training hop loop's two kernels
// (rau_train_hops_fwd.cu, rau_train_hops_bwd.cu): the weight order, the
// dimensions, the dropout sites, the conversions between the products'
// operand type T and float32, and the warp reductions.  The hop's forward
// phases, which both kernels enqueue, are in rau_train_hops_phases.cuh.
//
// T is the products' operand type (JAX's dot_dtype, rau_vqa_tpu/ops/
// rau_train_hops.py:299): float, or __nv_bfloat16 for compute_dtype
// "bfloat16".  q, feats and the weights arrive in T.  A value is rounded to
// T where a product reads it (rnd, or a copy in T written once by its
// producer), never where it is kept: the workspace, the carries and the
// vectors of the row kernels stay float32, which the pooling, the softmax
// and the elementwise math read unrounded.  With T = float, rnd and ldf are
// plain loads.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "maskgen.cuh"

namespace rth {

constexpr int NT = 256;  // threads a CTA of the row and elementwise kernels
constexpr int NWARP = NT / 32;

// weight order of rau_vqa_tpu/ops/rau_train_hops.py _FWD_WEIGHTS (:53-65)
enum {
  Q_W, Q_B, H_W, H_B, I_W, I_B, AQ_W, AQ_B, AI_W, AI_B, AS_W, AS_B, AM_W, AM_B,
  AP_W, AP_B, L_WI, L_BI, L_WH, L_BH, MG_W, MG_B, CLS_W, CLS_B, DP_W, DP_B,
  NWEIGHTS
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

// the hop loop's dropout: one seed, one rate for all three sites; row0 is
// the call's first row in the global batch, so that each element's mask is
// keyed by its global index whichever rank or microbatch holds the row
struct Dropout {
  uint32_t seed, thresh;
  float scale;
  bool on;
  uint32_t row0;
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

}  // namespace rth
