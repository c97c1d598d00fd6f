// The training hop loop's backward, for sm_90a.
//
// Replaces: rau_vqa_tpu/ops/rau_train_hops.py, _run_bwd (:471), whose Pallas
// body is _bwd_kernel (:411-468) with the per-hop math in _hop_fwd_core
// (:104-167, rematerialized) and _hop_bwd_core (:170-276).
//
// Computes, per batch row, over the hops in reverse: the hop's forward again
// from the saved carries c_all / h_all and the same counter-hash masks; the
// serial (dc, dh) cotangent chain through merge, the ATTLSTM cell, join, the
// attention softmax, the content score and qfeat; the nine per-hop emissions
// of _EMITS (:76-80) for the weight-gradient GEMMs that run outside; and the
// feats-path weight gradients of _INKERNEL_GRADS (:72-73) -- i_embed w / b,
// att_i w / b, att_score w -- summed over the block's hops into the block's
// own slot of per-block partial buffers, which the wrapper sums in PyTorch
// (as JAX sums its per-tile partials outside the kernel, :533-535).  No
// atomics: the sum is deterministic.  Two instantiations by the products'
// operand type T, as the forward's (rau_train_hops.cuh): float, and bf16,
// where q, feats and the weights arrive in bf16, each product (the remat's,
// the cotangent chain's x W^T, the grads' a^T b) rounds both operands to
// bf16 and sums in float32, the emitted activations qfeat / join / merge_d
// are bf16 and the cotangents, the carries and the grad partials float32.
//
// What bounds it on an H100: operations.  Per row and hop: the remat's two
// image products (77 M FMA), difeat = dpre_add Wa^T (26 M), the att_i w grad
// ifeat^T dpre_add (26 M) and the i_embed w grad feats_d^T dpre_i (51 M):
// ~360 MFLOP, ~290 GFLOP a step at B=100, H=8, ~4.3 ms at the 67 TFLOP/s
// float32 peak (in bf16 on the tensor cores ~0.3 ms; this kernel takes the
// bf16 products as float32 FMAs on rounded operands, as the forward does).
//
// Design: as the forward (rau_train_hops_fwd.cu), one block owns one row and
// loops over the hops itself -- the loop takes the place of the TPU's
// sequential hop grid dimension, and the (dc, dh) carry stays in shared
// memory.  The row's [S, *] tensors live in a per-block workspace in device
// memory (L2-resident while in use): ifeat [S, M], overwritten by dpre_i once
// the att_i grad has read it, and addfeat [S, F], overwritten by dpre_add.
// The [Dc, M] and [M, F] weight grads (1 MB and 0.5 MB) do not fit in shared
// memory; each hop's tile GEMM adds its product into the block's partial slot
// in device memory (the first hop processed writes it).  The small products
// are warp-per-output loops over the transposed weights' rows.

#include "rau_train_hops.cuh"

namespace {

using namespace rth;

// emissions in _EMITS order
enum { E_DPRE_Q, E_DQATT, E_DSCORE, E_DJOIN, E_DGATES, E_DMERGE, E_QFEAT, E_JOIN,
       E_MERGE, NEMITS };
struct Emits {
  void* p[NEMITS];  // float32 cotangents; E_QFEAT, E_JOIN, E_MERGE in T
};
// per-block partial grads in _INKERNEL_GRADS order
struct Partials {
  float *i_w, *i_b, *ai_w, *ai_b, *as_w;
};

template <class T>
__global__ void __launch_bounds__(NT, 1)
train_hops_bwd_kernel(Dims d, Weights<T> W, Dropout dr, const int* __restrict__ seed,
                      const T* __restrict__ q, const T* __restrict__ feats,
                      const float* __restrict__ c_all, const float* __restrict__ h_all,
                      const float* __restrict__ gmerge, float* __restrict__ work,
                      Emits em, Partials gp) {
  extern __shared__ __align__(16) float smem[];
  Smem s;
  Smem::carve(smem, d, true, &s);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x;
  const int B = d.B, S = d.S, Dc = d.Dc, M = d.M, F = d.F, R = d.R, H = d.H;
  dr.seed = (uint32_t)seed[0];
  const T* q_row = q + (size_t)b * d.Q;
  const T* feats_row = feats + (size_t)b * S * Dc;
  auto ef = [&](int i) { return static_cast<float*>(em.p[i]); };  // the cotangents
  auto et = [&](int i) { return static_cast<T*>(em.p[i]); };      // the activations
  float* ifeat = work + (size_t)b * S * (M + F);
  float* addfeat = ifeat + (size_t)S * M;
  float* g_iw = gp.i_w + (size_t)b * Dc * M;
  float* g_aiw = gp.ai_w + (size_t)b * M * F;

  for (int j = tid; j < R; j += NT) { s.dc[j] = 0.f; s.dh[j] = 0.f; }
  for (int j = tid; j < M; j += NT) s.acc_bi[j] = 0.f;
  for (int j = tid; j < F; j += NT) { s.acc_as[j] = 0.f; s.acc_bai[j] = 0.f; }

  for (int hop = H - 1; hop >= 0; --hop) {
    const bool first = hop == H - 1;
    const size_t hb = (size_t)hop * B + b;
    for (int j = tid; j < R; j += NT) {
      s.c[j] = c_all[hb * R + j];
      s.h[j] = h_all[hb * R + j];
    }
    __syncthreads();
    hop_forward(d, W, dr, b, hop, q_row, feats_row, ifeat, addfeat, s);
    const maskgen::Site mm = dr.site(hop, maskgen::SITE_MERGE);

    // dmerge_pre = g_merge * mmask
    for (int n = tid; n < M; n += NT) {
      const float g = mm.apply(gmerge[hb * M + n], (uint32_t)b * M + n);
      s.dmerge[n] = g;
      ef(E_DMERGE)[hb * M + n] = g;
      stf(et(E_MERGE), hb * M + n, s.merge[n]);
    }
    __syncthreads();
    // dh_new = dmerge_pre Wmg^T + dh
    for (int r = warp; r < R; r += NWARP) {
      const float v = dot_row_warp(s.dmerge, M, W.p[MG_W], r);
      if (lane == 0) s.dhn[r] = v + s.dh[r];
    }
    __syncthreads();
    // ATTLSTM cell backward; dc becomes the carry into the previous hop
    for (int j = tid; j < R; j += NT) {
      const float ig = s.gates[j], gt = s.gates[R + j];
      const float fg = s.gates[2 * R + j], og = s.gates[3 * R + j];
      const float tc = tanhf(s.cn[j]);
      const float dhn = s.dhn[j];
      const float dgo = dhn * tc;
      const float dcn = dhn * og * (1.0f - tc * tc) + s.dc[j];
      const float dgf = dcn * s.c[j];
      s.dc[j] = dcn * fg;
      const float dgi = dcn * gt;
      const float dgg = dcn * ig;
      s.dgates[j] = dgi * ig * (1.0f - ig);
      s.dgates[R + j] = dgg * (1.0f - gt * gt);
      s.dgates[2 * R + j] = dgf * fg * (1.0f - fg);
      s.dgates[3 * R + j] = dgo * og * (1.0f - og);
    }
    __syncthreads();
    for (int j = tid; j < 4 * R; j += NT) ef(E_DGATES)[hb * 4 * R + j] = s.dgates[j];
    // djoin = dmerge_pre + dgates Wi^T;  dh_prev = dgates Wh^T
    for (int n = warp; n < M; n += NWARP) {
      const float v = dot_row_warp(s.dgates, 4 * R, W.p[L_WI], n);
      if (lane == 0) s.djoin[n] = s.dmerge[n] + v;
    }
    for (int r = warp; r < R; r += NWARP) {
      const float v = dot_row_warp(s.dgates, 4 * R, W.p[L_WH], r);
      if (lane == 0) s.dhp[r] = v;
    }
    __syncthreads();
    for (int n = tid; n < M; n += NT) {
      ef(E_DJOIN)[hb * M + n] = s.djoin[n];
      stf(et(E_JOIN), hb * M + n, s.join[n]);
      stf(et(E_QFEAT), hb * M + n, s.qfeat[n]);
    }
    // dattprob = djoin Wp^T + sum_m ifeat djoin   (into dsc; the second on
    // unrounded values: T = float reads the workspace as it is)
    for (int i = warp; i < S; i += NWARP) {
      const float a = dot_row_warp(s.djoin, M, W.p[AP_W], i);
      const float c = dot_row_warp(s.djoin, M, ifeat, i);
      if (lane == 0) s.dsc[i] = a + c;
    }
    __syncthreads();
    // softmax backward: dattscore = p (dattprob - sum(dattprob p))
    if (warp == 0) {
      float dot = 0.f;
      for (int i = lane; i < S; i += 32) dot += s.dsc[i] * s.sc[i];
      dot = warp_sum(dot);
      for (int i = lane; i < S; i += 32) s.dsc[i] = s.sc[i] * (s.dsc[i] - dot);
    }
    __syncthreads();
    for (int i = tid; i < S; i += NT) ef(E_DSCORE)[hb * S + i] = s.dsc[i];
    // dh_prev += dattscore Wmem^T
    for (int r = warp; r < R; r += NWARP) {
      const float v = dot_row_warp(s.dsc, S, W.p[AM_W], r);
      if (lane == 0) s.dhp[r] += v;
    }
    // att_score w grad: sum_s addfeat[s, f] dattscore[s]
    for (int f = tid; f < F; f += NT) {
      float acc = 0.f;
      for (int i = 0; i < S; ++i)
        acc = fmaf(rnd<T>(addfeat[(size_t)i * F + f]), rnd<T>(s.dsc[i]), acc);
      s.acc_as[f] += acc;
    }
    __syncthreads();
    // dpre_add = dattscore w_score (1 - addfeat^2), in place of addfeat
    {
      const T* ws = W.p[AS_W];
      for (int e = tid; e < S * F; e += NT) {
        const int i = e / F, f = e - i * F;
        const float a = addfeat[e];
        addfeat[e] = (s.dsc[i] * ldf(ws, f)) * (1.0f - a * a);
      }
    }
    __syncthreads();
    float* dpre_add = addfeat;
    // dqatt = sum_s dpre_add  (also this row's att_i b grad)
    for (int f = tid; f < F; f += NT) {
      float acc = 0.f;
      for (int i = 0; i < S; ++i) acc += dpre_add[(size_t)i * F + f];
      s.dqatt[f] = acc;
      s.acc_bai[f] += acc;
      ef(E_DQATT)[hb * F + f] = acc;
    }
    __syncthreads();
    // dpre_q = (djoin + dqatt Waq^T) (1 - qfeat^2)
    for (int n = warp; n < M; n += NWARP) {
      const float v = dot_row_warp(s.dqatt, F, W.p[AQ_W], n);
      if (lane == 0) {
        const float qf = s.qfeat[n];
        const float dp = (s.djoin[n] + v) * (1.0f - qf * qf);
        s.dpre_q[n] = dp;
        ef(E_DPRE_Q)[hb * M + n] = dp;
      }
    }
    __syncthreads();
    // dh_prev += dpre_q Whp^T; it becomes the carry into the previous hop
    for (int r = warp; r < R; r += NWARP) {
      const float v = dot_row_warp(s.dpre_q, M, W.p[H_W], r);
      if (lane == 0) s.dh[r] = s.dhp[r] + v;
    }
    // att_i w grad: ifeat^T dpre_add                  [M, S] x [S, F]
    block_gemm<false, true>(
        M, F, S, [&](int m, int k) { return rnd<T>(ifeat[(size_t)k * M + m]); },
        [&](int k, int n) { return rnd<T>(dpre_add[(size_t)k * F + n]); },
        [&](int m, int n, float acc) {
          float* o = g_aiw + (size_t)m * F + n;
          *o = first ? acc : *o + acc;
        },
        s.As, s.Bs);
    // dpre_i = (p djoin + dpre_add Wa^T) (1 - ifeat^2), in place of ifeat
    {
      const T* wa = W.p[AI_W];
      const float* p = s.sc;
      const float* djoin = s.djoin;
      block_gemm<true, false>(
          S, M, F, [&](int m, int k) { return rnd<T>(dpre_add[(size_t)m * F + k]); },
          [&](int k, int n) { return ldf(wa, (size_t)n * F + k); },
          [&](int m, int n, float acc) {
            float* o = ifeat + (size_t)m * M + n;
            const float x = *o;
            *o = (p[m] * djoin[n] + acc) * (1.0f - x * x);
          },
          s.As, s.Bs);
    }
    float* dpre_i = ifeat;
    for (int n = tid; n < M; n += NT) {
      float acc = 0.f;
      for (int i = 0; i < S; ++i) acc += dpre_i[(size_t)i * M + n];
      s.acc_bi[n] += acc;
    }
    // i_embed w grad: (feats * fmask)^T dpre_i         [Dc, S] x [S, M]
    {
      const maskgen::Site fm = dr.site(hop, maskgen::SITE_FEATS);
      const uint32_t base = (uint32_t)b * (uint32_t)(S * Dc);
      block_gemm<false, true>(
          Dc, M, S,
          [&](int m, int k) {
            const int e = k * Dc + m;
            return rnd<T>(fm.apply(ldf(feats_row, e), base + (uint32_t)e));
          },
          [&](int k, int n) { return rnd<T>(dpre_i[(size_t)k * M + n]); },
          [&](int m, int n, float acc) {
            float* o = g_iw + (size_t)m * M + n;
            *o = first ? acc : *o + acc;
          },
          s.As, s.Bs);
    }
  }
  for (int j = tid; j < M; j += NT) gp.i_b[(size_t)b * M + j] = s.acc_bi[j];
  for (int j = tid; j < F; j += NT) {
    gp.ai_b[(size_t)b * F + j] = s.acc_bai[j];
    gp.as_w[(size_t)b * F + j] = s.acc_as[j];
  }
}

template <class T>
int bwd_launch(const void* q, const void* feats, const void* seed, const void* c_all,
               const void* h_all, const void* gmerge, const void* const* weights,
               void* work, void* const* emits, void* const* partials, int B, int Q,
               int S, int Dc, int M, int F, int R, int H, uint32_t thresh, float scale,
               int use_mask, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || Dc <= 0 || M <= 0 || F <= 0 || R <= 0)
    return (int)cudaErrorInvalidValue;
  const Dims d{B, Q, S, Dc, M, F, R, 0, H};
  Weights<T> w;
  for (int i = 0; i < NWEIGHTS; ++i) w.p[i] = (const T*)weights[i];
  Emits em;
  for (int i = 0; i < NEMITS; ++i) em.p[i] = emits[i];
  const Partials gp{(float*)partials[0], (float*)partials[1], (float*)partials[2],
                    (float*)partials[3], (float*)partials[4]};
  const Dropout dr{0u, thresh, scale, use_mask != 0};
  Smem layout;
  const size_t smem = Smem::carve(nullptr, d, true, &layout) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      train_hops_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  train_hops_bwd_kernel<T><<<B, NT, smem, (cudaStream_t)stream>>>(
      d, w, dr, (const int*)seed, (const T*)q, (const T*)feats, (const float*)c_all,
      (const float*)h_all, (const float*)gmerge, (float*)work, em, gp);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, Q], feats [B, S, Dc], c_all / h_all [H+1, B, R], gmerge [H, B, M]
// (the score cotangent times cls_w^T, float32); seed: one int32 on the
// device; weights: 26 pointers in _FWD_WEIGHTS order (cls and do_pred
// unread); q, feats and the weights float32 (the first entry) or bf16 (the
// second); work: B * S * (M + F) floats; emits: 9 pointers in _EMITS order,
// [H, B, width], float32 but for qfeat / join / merge_d in the weights'
// type; partials, float32: i_embed w [B, Dc, M], i_embed b [B, M], att_i w
// [B, M, F], att_i b [B, F], att_score w [B, F].  Returns cudaGetLastError().
#define TRAIN_HOPS_BWD_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const void* q, const void* feats, const void* seed,             \
                      const void* c_all, const void* h_all, const void* gmerge,       \
                      const void* const* weights, void* work, void* const* emits,     \
                      void* const* partials, int B, int Q, int S, int Dc, int M,      \
                      int F, int R, int H, uint32_t thresh, float scale,              \
                      int use_mask, void* stream) {                                   \
    return bwd_launch<T>(q, feats, seed, c_all, h_all, gmerge, weights, work, emits,  \
                         partials, B, Q, S, Dc, M, F, R, H, thresh, scale, use_mask,  \
                         stream);                                                     \
  }
TRAIN_HOPS_BWD_ENTRY(train_hops_bwd_launch, float)
TRAIN_HOPS_BWD_ENTRY(train_hops_bwd_bf16_launch, __nv_bfloat16)
