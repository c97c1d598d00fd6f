// The training hop loop's forward, for sm_90a.
//
// Replaces: rau_vqa_tpu/ops/rau_train_hops.py, _run_fwd (:358), whose Pallas
// body is _fwd_kernel (:320-355) with the per-hop math in _hop_fwd_core
// (:104-167) and the masks of ops/maskgen.py.
//
// Computes, per batch row and for each of H hops, under that hop's dropout
// masks (maskgen.cuh, regenerated from the element's global index): the image
// embedding ifeat = tanh((feats * fmask) Wi + bi) and addfeat = tanh(ifeat Wa
// + ba + qatt); qfeat from the masked question and the previous h; the
// attention softmax and pooling; join; the ATTLSTM step (gates [i, g, f, o]);
// merge_d = merge * mmask; the classifier scores and the do_pred sigmoid.  It
// saves the carries entering every hop and the final one, c_all / h_all
// [H+1, B, R], which is all the backward kernel needs to rematerialize.
// Two instantiations, by the products' operand type T (rau_train_hops.cuh):
// float, as ours_ms trains by default (matmul_precision "highest"), and
// bf16 for compute_dtype "bfloat16" (--bf16), where q, feats and the weights
// arrive in bf16, each product's operands are rounded to bf16 and summed in
// float32, and everything else (carries, softmax, pooling, outputs) stays
// float32.
//
// What bounds it on an H100: operations.  At B=100, H=8 the two image
// products (feats Wi: 103 MFLOP, ifeat Wa: 51 MFLOP per row and hop) are
// ~123 GFLOP of float32 FMA, ~1.8 ms at the 67 TFLOP/s non-tensor peak,
// against ~60 MB of traffic (feats 40 MB read once).  In bf16 the same
// products could run on the tensor cores (989 TFLOP/s, ~0.13 ms), but this
// kernel still takes them as float32 FMAs on rounded operands: the same
// design at both types, its redesign left for later.
//
// Design: the Pallas kernel keeps a 16-row tile of feats and all weights
// (~12 MB) in VMEM for the whole loop; a Hopper block has 227 KB of shared
// memory and one row's ifeat is 401 KB.  So one block owns one row and runs
// all H hops itself (rows are independent; no grid-wide sync; any B works),
// and the row's ifeat [S, M] and addfeat [S, F] go to a per-block workspace
// in device memory that stays in L2 while the block uses it: the softmax
// over S must finish before the pooling reads ifeat again.  Both image
// products are tiled float32 GEMMs (64 x 64 tiles, 16 x 16 threads of 4 x 4
// FMAs) whose A loader applies the feats mask on the fly; the small products
// are FMA loops with one output column per thread, weights streaming from
// L2.  The masks are a function of the global index, so the block's row
// alone fixes them.

#include "rau_train_hops.cuh"

namespace {

using namespace rth;

template <class T>
__global__ void __launch_bounds__(NT, 1)
train_hops_fwd_kernel(Dims d, Weights<T> W, Dropout dr, const int* __restrict__ seed,
                      const T* __restrict__ q, const T* __restrict__ feats,
                      float* __restrict__ work, float* __restrict__ scores,
                      float* __restrict__ dopred, float* __restrict__ attprob,
                      float* __restrict__ c_all, float* __restrict__ h_all) {
  extern __shared__ __align__(16) float smem[];
  Smem s;
  Smem::carve(smem, d, &s);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x;
  const int B = d.B, M = d.M, R = d.R, A = d.A, S = d.S;
  dr.seed = (uint32_t)seed[0];
  const T* q_row = q + (size_t)b * d.Q;
  const T* feats_row = feats + (size_t)b * S * d.Dc;
  float* ifeat = work + (size_t)b * S * (M + d.F);
  float* addfeat = ifeat + (size_t)S * M;

  for (int j = tid; j < R; j += NT) { s.c[j] = 0.f; s.h[j] = 0.f; }
  __syncthreads();
  for (int hop = 0; hop < d.H; ++hop) {
    hop_forward(d, W, dr, b, hop, q_row, feats_row, ifeat, addfeat, s);
    for (int j = tid; j < R; j += NT) {
      c_all[((size_t)hop * B + b) * R + j] = s.c[j];
      h_all[((size_t)hop * B + b) * R + j] = s.h[j];
    }
    for (int i = tid; i < S; i += NT) attprob[((size_t)hop * B + b) * S + i] = s.sc[i];
    for (int n = tid; n < A; n += NT)
      scores[((size_t)hop * B + b) * A + n] =
          dot_col(s.merge, M, W.p[CLS_W], A, n) + ldf(W.p[CLS_B], n);
    if (warp == 0) {
      const float z = dot_row_warp(s.merge, M, W.p[DP_W], 0);
      if (lane == 0) dopred[(size_t)hop * B + b] = sigm(z + ldf(W.p[DP_B], 0));
    }
    __syncthreads();
    for (int j = tid; j < R; j += NT) { s.c[j] = s.cn[j]; s.h[j] = s.hn[j]; }
    __syncthreads();
  }
  for (int j = tid; j < R; j += NT) {
    c_all[((size_t)d.H * B + b) * R + j] = s.c[j];
    h_all[((size_t)d.H * B + b) * R + j] = s.h[j];
  }
}

template <class T>
int fwd_launch(const void* q, const void* feats, const void* seed,
               const void* const* weights, void* work, void* scores, void* dopred,
               void* attprob, void* c_all, void* h_all, int B, int Q, int S, int Dc,
               int M, int F, int R, int A, int H, uint32_t thresh, float scale,
               int use_mask, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || Dc <= 0 || M <= 0 || F <= 0 || R <= 0 || A <= 0)
    return (int)cudaErrorInvalidValue;
  const Dims d{B, Q, S, Dc, M, F, R, A, H};
  Weights<T> w;
  for (int i = 0; i < NWEIGHTS; ++i) w.p[i] = (const T*)weights[i];
  const Dropout dr{0u, thresh, scale, use_mask != 0};
  Smem layout;
  const size_t smem = Smem::carve(nullptr, d, &layout) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      train_hops_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  train_hops_fwd_kernel<T><<<B, NT, smem, (cudaStream_t)stream>>>(
      d, w, dr, (const int*)seed, (const T*)q, (const T*)feats, (float*)work,
      (float*)scores, (float*)dopred, (float*)attprob, (float*)c_all, (float*)h_all);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, Q], feats [B, S, Dc]; seed: one int32 on the device; weights: 26
// pointers in _FWD_WEIGHTS order; q, feats and the weights float32 (the
// first entry) or bf16 (the second); work: B * S * (M + F) floats.  Outputs
// scores [H, B, A], dopred [H, B], attprob [H, B, S], c_all / h_all
// [H+1, B, R], all float32.  thresh / scale: the dropout threshold and scale
// (use_mask 0 when the rate is 0).  Returns cudaGetLastError().
#define TRAIN_HOPS_FWD_ENTRY(NAME, T)                                                   \
  extern "C" int NAME(const void* q, const void* feats, const void* seed,              \
                      const void* const* weights, void* work, void* scores,            \
                      void* dopred, void* attprob, void* c_all, void* h_all, int B,    \
                      int Q, int S, int Dc, int M, int F, int R, int A, int H,         \
                      uint32_t thresh, float scale, int use_mask, void* stream) {      \
    return fwd_launch<T>(q, feats, seed, weights, work, scores, dopred, attprob,       \
                         c_all, h_all, B, Q, S, Dc, M, F, R, A, H, thresh, scale,      \
                         use_mask, stream);                                            \
  }
TRAIN_HOPS_FWD_ENTRY(train_hops_fwd_launch, float)
TRAIN_HOPS_FWD_ENTRY(train_hops_fwd_bf16_launch, __nv_bfloat16)
