// The whole eval hop loop of the recurrent answering units, for sm_90a.
//
// Replaces: rau_vqa_tpu/ops/rau_hops.py, rau_hops_pallas (:152), whose Pallas
// body is _kernel (:122-148) with the per-hop math in _hop_body (:39-80).
//
// Computes, per batch row and for H hops: qfeat = tanh(q Wq + bq + h Wh + bh);
// qatt; the content score sum_f tanh(iatt + qatt) w_score + b_score plus the
// memory score h W_mem + b_mem; softmax over S; attention pooling of ifeat;
// join; the ATTLSTM step (gates [i, g, f, o]); merge; the classifier and the
// do_pred sigmoid.  Dot operands are rounded to bf16 and summed in f32, as in
// _hop_body with dot_dtype=bf16; softmax, pooling and the state stay f32.
//
// What bounds it on an H100: bytes.  At B=512 the features (ifeat + iatt,
// ~154 MB in bf16) dominate ~186 MB of traffic, against ~7 MFLOP per row
// and hop of dots.  The hop weights (~9 MB in bf16) fit in the 50 MB L2.
//
// Design: rows are independent, so one block owns RB batch rows and runs all
// H hops itself; no grid-wide sync is needed.  The Pallas kernel keeps a
// 16-row tile of features plus all weights in ~12 MB of VMEM; a Hopper block
// has at most 227 KB of shared memory and one feature row alone is 300 KB,
// so here only the f32 vectors of the RB rows live in shared memory (qpre,
// qfeat, qatt, scores, join, gates, c, h, merge: ~22 KB a row) and weights
// and features stream from L2 / HBM.  Each weight element read serves RB
// rows.  Products are FMA loops with one output column per thread; the
// content score is one warp per (row, cell) with bf16x2 loads of iatt; the
// softmax is one warp per row over S, masked at the ragged edge by the
// strided loop.  The question projection q Wq + bq is the same every hop and
// is computed once.  Features are re-read once per hop (H x 154 MB at
// B=512), a cost a later version removes.  A ragged last tile reads row B-1
// and writes nothing for the missing rows.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int RB = 4;      // batch rows per block
constexpr int NT = 512;    // threads per block
constexpr int NWARP = NT / 32;

// weight order of rau_vqa_tpu/ops/rau_hops.py _WEIGHT_ORDER (:103-112)
enum {
  Q_W, Q_B, H_W, H_B, AQ_W, AQ_B, AS_W, AS_B, AM_W, AM_B, AP_W, AP_B,
  L_WI, L_BI, L_WH, L_BH, MG_W, MG_B, CLS_W, CLS_B, DP_W, DP_B, NWEIGHTS
};

struct HopWeights {
  const __nv_bfloat16* p[NWEIGHTS];
};

__device__ __forceinline__ float bf(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float bfr(float x) {  // round to bf16 and back
  return __bfloat162float(__float2bfloat16(x));
}
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

// acc[r] += sum_k bf16(x[r * xstride + k]) * w[k][n]
__device__ __forceinline__ void dot_col(float (&acc)[RB], const float* x,
                                        int xstride, int K,
                                        const __nv_bfloat16* __restrict__ w,
                                        int N, int n) {
  for (int k = 0; k < K; ++k) {
    float wv = bf(w[(size_t)k * N + n]);
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] = fmaf(bfr(x[r * xstride + k]), wv, acc[r]);
  }
}

__global__ void __launch_bounds__(NT, 1)
rau_hops_kernel(const float* __restrict__ q, const __nv_bfloat16* __restrict__ ifeat,
                const __nv_bfloat16* __restrict__ iatt, HopWeights W,
                float* __restrict__ scores, float* __restrict__ dopred,
                float* __restrict__ attprob,
                int B, int Q, int S, int M, int F, int R, int A, int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qpre = reinterpret_cast<float*>(smem_raw);  // [RB][M]
  float* qfeat = qpre + RB * M;                      // [RB][M]
  float* join = qfeat + RB * M;                      // [RB][M]
  float* merge = join + RB * M;                      // [RB][M]
  float* qatt = merge + RB * M;                      // [RB][F]
  float* sc = qatt + RB * F;                         // [RB][S] scores, then probs
  float* gates = sc + RB * S;                        // [RB][4R]
  float* cs = gates + RB * 4 * R;                    // [RB][R]
  float* hs = cs + RB * R;                           // [RB][R]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int b0 = blockIdx.x * RB;
  int row[RB];
  bool valid[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    valid[r] = b0 + r < B;
    row[r] = min(b0 + r, B - 1);
  }

  for (int i = tid; i < RB * R; i += NT) { cs[i] = 0.f; hs[i] = 0.f; }
  // the question projection is the same every hop: compute it once
  for (int n = tid; n < M; n += NT) {
    float acc[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] = 0.f;
    for (int k = 0; k < Q; ++k) {
      float wv = bf(W.p[Q_W][(size_t)k * M + n]);
#pragma unroll
      for (int r = 0; r < RB; ++r)
        acc[r] = fmaf(bfr(q[(size_t)row[r] * Q + k]), wv, acc[r]);
    }
    float b = bf(W.p[Q_B][n]);
#pragma unroll
    for (int r = 0; r < RB; ++r) qpre[r * M + n] = acc[r] + b;
  }
  __syncthreads();

  const float b_score = bf(W.p[AS_B][0]);
  const float b_dopred = bf(W.p[DP_B][0]);

  for (int hop = 0; hop < H; ++hop) {
    // 1. qfeat = tanh(qpre + h Wh + bh)
    for (int n = tid; n < M; n += NT) {
      float acc[RB] = {};
      dot_col(acc, hs, R, R, W.p[H_W], M, n);
      float b = bf(W.p[H_B][n]);
#pragma unroll
      for (int r = 0; r < RB; ++r) qfeat[r * M + n] = tanhf(qpre[r * M + n] + acc[r] + b);
    }
    __syncthreads();
    // 2. qatt = qfeat Waq + baq;  3a. memory score h Wmem into sc
    for (int n = tid; n < F; n += NT) {
      float acc[RB] = {};
      dot_col(acc, qfeat, M, M, W.p[AQ_W], F, n);
      float b = bf(W.p[AQ_B][n]);
#pragma unroll
      for (int r = 0; r < RB; ++r) qatt[r * F + n] = acc[r] + b;
    }
    for (int n = tid; n < S; n += NT) {
      float acc[RB] = {};
      dot_col(acc, hs, R, R, W.p[AM_W], S, n);
#pragma unroll
      for (int r = 0; r < RB; ++r) sc[r * S + n] = acc[r];
    }
    __syncthreads();
    // 3b. content score, one warp per (row, cell):
    //     ((sum_f bf16(tanh(iatt + qatt)) w_f + b_score) + mem) + b_mem
    for (int cell = warp; cell < RB * S; cell += NWARP) {
      const int r = cell / S, s = cell - r * S;
      const __nv_bfloat162* ia = reinterpret_cast<const __nv_bfloat162*>(
          iatt + ((size_t)row[r] * S + s) * F);
      const __nv_bfloat162* ws = reinterpret_cast<const __nv_bfloat162*>(W.p[AS_W]);
      const float* qa = qatt + r * F;
      float sum = 0.f;
      for (int f2 = lane; f2 < F / 2; f2 += 32) {
        float2 v = __bfloat1622float2(ia[f2]);
        float2 w = __bfloat1622float2(ws[f2]);
        sum = fmaf(bfr(tanhf(v.x + qa[2 * f2])), w.x, sum);
        sum = fmaf(bfr(tanhf(v.y + qa[2 * f2 + 1])), w.y, sum);
      }
      sum = warp_sum(sum);
      if (lane == 0) sc[r * S + s] = ((sum + b_score) + sc[r * S + s]) + bf(W.p[AM_B][s]);
    }
    __syncthreads();
    // 4. softmax over S, one warp per row
    if (warp < RB) {
      const int r = warp;
      float* x = sc + r * S;
      float mx = __int_as_float(0xff800000);  // -inf
      for (int s = lane; s < S; s += 32) mx = fmaxf(mx, x[s]);
      mx = warp_max(mx);
      float den = 0.f;
      for (int s = lane; s < S; s += 32) {
        float e = expf(x[s] - mx);
        x[s] = e;
        den += e;
      }
      den = warp_sum(den);
      for (int s = lane; s < S; s += 32) {
        float p = x[s] / den;
        x[s] = p;
        if (valid[r]) attprob[((size_t)hop * B + b0 + r) * S + s] = p;
      }
    }
    __syncthreads();
    // 5. join = qfeat + sum_s ifeat p_s + bf16(p) Wap + bap
    for (int n = tid; n < M; n += NT) {
      float pool[RB] = {}, proj[RB] = {};
      for (int s = 0; s < S; ++s) {
        float wv = bf(W.p[AP_W][(size_t)s * M + n]);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          float p = sc[r * S + s];
          pool[r] = fmaf(bf(ifeat[((size_t)row[r] * S + s) * M + n]), p, pool[r]);
          proj[r] = fmaf(bfr(p), wv, proj[r]);
        }
      }
      float b = bf(W.p[AP_B][n]);
#pragma unroll
      for (int r = 0; r < RB; ++r)
        join[r * M + n] = ((qfeat[r * M + n] + pool[r]) + proj[r]) + b;
    }
    __syncthreads();
    // 6. ATTLSTM gates = ((join Wi + bi) + h Wh) + bh
    for (int n = tid; n < 4 * R; n += NT) {
      float ai[RB] = {}, ah[RB] = {};
      dot_col(ai, join, M, M, W.p[L_WI], 4 * R, n);
      dot_col(ah, hs, R, R, W.p[L_WH], 4 * R, n);
      float bi = bf(W.p[L_BI][n]), bh = bf(W.p[L_BH][n]);
#pragma unroll
      for (int r = 0; r < RB; ++r) gates[r * 4 * R + n] = ((ai[r] + bi) + ah[r]) + bh;
    }
    __syncthreads();
    // 7. cell update, gate layout [i, g, f, o]
    for (int i = tid; i < RB * R; i += NT) {
      const int r = i / R, j = i - r * R;
      const float* g = gates + r * 4 * R;
      float c = sigm(g[2 * R + j]) * cs[i] + sigm(g[j]) * tanhf(g[R + j]);
      cs[i] = c;
      hs[i] = sigm(g[3 * R + j]) * tanhf(c);
    }
    __syncthreads();
    // 8. merge = join + h Wmg + bmg
    for (int n = tid; n < M; n += NT) {
      float acc[RB] = {};
      dot_col(acc, hs, R, R, W.p[MG_W], M, n);
      float b = bf(W.p[MG_B][n]);
#pragma unroll
      for (int r = 0; r < RB; ++r) merge[r * M + n] = (join[r * M + n] + acc[r]) + b;
    }
    __syncthreads();
    // 9. classifier, and do_pred (one warp per row)
    for (int n = tid; n < A; n += NT) {
      float acc[RB] = {};
      dot_col(acc, merge, M, M, W.p[CLS_W], A, n);
      float b = bf(W.p[CLS_B][n]);
#pragma unroll
      for (int r = 0; r < RB; ++r)
        if (valid[r]) scores[((size_t)hop * B + b0 + r) * A + n] = acc[r] + b;
    }
    if (warp < RB) {
      const int r = warp;
      float sum = 0.f;
      for (int m = lane; m < M; m += 32)
        sum = fmaf(bfr(merge[r * M + m]), bf(W.p[DP_W][m]), sum);
      sum = warp_sum(sum);
      if (lane == 0 && valid[r]) dopred[(size_t)hop * B + b0 + r] = sigm(sum + b_dopred);
    }
    __syncthreads();
  }
}

}  // namespace

// q [B, Q] f32; ifeat [B, S, M], iatt [B, S, F] bf16; weights: 22 bf16
// pointers in _WEIGHT_ORDER; scores [H, B, A], dopred [H, B], attprob
// [H, B, S] f32.  Returns cudaGetLastError().
extern "C" int rau_hops_launch(const void* q, const void* ifeat, const void* iatt,
                               const void* const* weights, void* scores,
                               void* dopred, void* attprob, int B, int Q, int S,
                               int M, int F, int R, int A, int H, void* stream) {
  if (B <= 0 || H <= 0 || F % 2 != 0 || S <= 0 || M <= 0 || R <= 0 || A <= 0)
    return (int)cudaErrorInvalidValue;
  HopWeights w;
  for (int i = 0; i < NWEIGHTS; ++i) w.p[i] = (const __nv_bfloat16*)weights[i];
  size_t smem = (size_t)RB * (4 * M + F + S + 4 * R + 2 * R) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rau_hops_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((B + RB - 1) / RB);
  rau_hops_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const __nv_bfloat16*)ifeat, (const __nv_bfloat16*)iatt, w,
      (float*)scores, (float*)dopred, (float*)attprob, B, Q, S, M, F, R, A, H);
  return (int)cudaGetLastError();
}
