// Question-encoder LSTM over all timesteps and layers, for sm_90a.
//
// Replaces: rau_vqa_tpu/ops/lstm_encoder.py, lstm_encode_pallas (:81), whose
// Pallas body is _kernel (:57-77) with the cell in _cell_step (:28-54).
//
// Computes: the DeepLSTM (gate layout [i, f, o | g]) over T tokens for each
// batch row, and keeps the packed state (c1, h1, c2, h2, ...) at the step
// where lengths == t + 1.  Dot operands are rounded to bf16, products are
// summed in f32, the state stays f32, as in _cell_step.
//
// What bounds it on an H100: operations.  At B=512, T=26 the dots are about
// 7.1 MFLOP per row and step against ~22 MB of inputs, weights and output;
// the weights (~7 MB in bf16) fit in the 50 MB L2.  This first version runs
// the products as FMA loops on the CUDA cores, so in practice the weight
// stream from L2 and the FMA rate bound it, far above the tensor-core bound.
//
// Design: rows are independent, so one block owns RB batch rows and runs the
// whole time loop and both layers itself; no grid-wide sync is needed.  Each
// thread owns hidden unit j (blockDim.x == R) and computes the four gate
// columns j, R+j, 2R+j, 3R+j for its rows, so the cell update is thread
// local and c, h stay in registers in f32.  Shared memory holds only the dot
// operands in bf16: the current token's embedding and each layer's h.  Each
// weight element read from L2 serves RB rows.  A block stops at the longest
// question among its rows; a ragged last tile reads row B-1 and writes
// nothing for the missing rows.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int RB = 8;       // batch rows per block
constexpr int MAXL = 2;     // layers the kernel holds state for
constexpr int MAXR = 512;   // threads per block == rnn_size

struct Layer {
  const __nv_bfloat16* wi;  // [K, 4R]
  const __nv_bfloat16* bi;  // [4R]
  const __nv_bfloat16* wh;  // [R, 4R]
  const __nv_bfloat16* bh;  // [4R]
};

__device__ __forceinline__ float bf(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float sigm(float x) { return 1.0f / (1.0f + expf(-x)); }

// acc[g][r] += sum_k x[r][k] * w[k][g*R + j]
__device__ __forceinline__ void gate_dot(float (&acc)[4][RB],
                                         const __nv_bfloat16* x, int K,
                                         const __nv_bfloat16* __restrict__ w,
                                         int R, int j) {
  const int G = 4 * R;
  for (int k = 0; k < K; ++k) {
    const __nv_bfloat16* wk = w + (size_t)k * G + j;
    float w0 = bf(wk[0]), w1 = bf(wk[R]), w2 = bf(wk[2 * R]), w3 = bf(wk[3 * R]);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      float xv = bf(x[r * K + k]);
      acc[0][r] = fmaf(xv, w0, acc[0][r]);
      acc[1][r] = fmaf(xv, w1, acc[1][r]);
      acc[2][r] = fmaf(xv, w2, acc[2][r]);
      acc[3][r] = fmaf(xv, w3, acc[3][r]);
    }
  }
}

__global__ void __launch_bounds__(MAXR, 1)
lstm_encode_kernel(const float* __restrict__ emb, const int* __restrict__ lengths,
                   Layer l0, Layer l1, float* __restrict__ out,
                   int B, int T, int E, int R, int L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* xs = smem;               // [RB][E]   current token, bf16
  __nv_bfloat16* hs = smem + RB * E;      // [L][RB][R] each layer's h, bf16

  const int j = threadIdx.x;
  const int b0 = blockIdx.x * RB;
  const int D = 2 * L * R;

  int len[RB];
  int tmax = 0;
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    len[r] = (b0 + r < B) ? lengths[b0 + r] : 0;
    tmax = max(tmax, len[r]);
  }
  tmax = min(tmax, T);

  float c[MAXL][RB], h[MAXL][RB];
#pragma unroll
  for (int l = 0; l < MAXL; ++l)
#pragma unroll
    for (int r = 0; r < RB; ++r) { c[l][r] = 0.f; h[l][r] = 0.f; }
  for (int i = j; i < L * RB * R; i += blockDim.x) hs[i] = __float2bfloat16(0.f);
  // a row whose length is outside [1, T] keeps zeros, as in the Pallas kernel
#pragma unroll
  for (int r = 0; r < RB; ++r)
    if (b0 + r < B)
      for (int q = 0; q < D; q += R) out[(size_t)(b0 + r) * D + q + j] = 0.f;

  for (int t = 0; t < tmax; ++t) {
    for (int i = j; i < RB * E; i += blockDim.x) {
      int r = i / E, k = i - r * E;
      int b = min(b0 + r, B - 1);
      xs[i] = __float2bfloat16(emb[((size_t)b * T + t) * E + k]);
    }
    __syncthreads();
#pragma unroll
    for (int l = 0; l < MAXL; ++l) {
      if (l >= L) break;
      const Layer& w = (l == 0) ? l0 : l1;
      const __nv_bfloat16* x = (l == 0) ? xs : hs + (l - 1) * RB * R;
      const int K = (l == 0) ? E : R;
      float acc[4][RB];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int r = 0; r < RB; ++r) acc[g][r] = 0.f;
      gate_dot(acc, x, K, w.wi, R, j);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float b = bf(w.bi[g * R + j]);
#pragma unroll
        for (int r = 0; r < RB; ++r) acc[g][r] += b;
      }
      gate_dot(acc, hs + l * RB * R, R, w.wh, R, j);
      __syncthreads();  // every thread has read this step's operands
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        float gi = acc[0][r] + bf(w.bh[j]);
        float gf = acc[1][r] + bf(w.bh[R + j]);
        float go = acc[2][r] + bf(w.bh[2 * R + j]);
        float gg = acc[3][r] + bf(w.bh[3 * R + j]);
        float nc = sigm(gf) * c[l][r] + sigm(gi) * tanhf(gg);
        float nh = sigm(go) * tanhf(nc);
        c[l][r] = nc;
        h[l][r] = nh;
        hs[(l * RB + r) * R + j] = __float2bfloat16(nh);
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (b0 + r < B && len[r] == t + 1) {
        float* o = out + (size_t)(b0 + r) * D;
#pragma unroll
        for (int l = 0; l < MAXL; ++l) {
          if (l >= L) break;
          o[2 * l * R + j] = c[l][r];
          o[(2 * l + 1) * R + j] = h[l][r];
        }
      }
    }
  }
}

}  // namespace

// emb [B, T, E] f32 (after the embedding tanh), lengths [B] int32,
// per layer wi [K, 4R], bi [4R], wh [R, 4R], bh [4R] bf16 (layer 2 pointers
// are ignored when L == 1), out [B, 2*L*R] f32.  Returns cudaGetLastError().
extern "C" int lstm_encode_launch(const void* emb, const void* lengths,
                                  const void* wi0, const void* bi0,
                                  const void* wh0, const void* bh0,
                                  const void* wi1, const void* bi1,
                                  const void* wh1, const void* bh1,
                                  void* out, int B, int T, int E, int R, int L,
                                  void* stream) {
  if (B <= 0 || T <= 0 || L < 1 || L > MAXL || R % 32 != 0 || R > MAXR || E <= 0)
    return (int)cudaErrorInvalidValue;
  using bfp = const __nv_bfloat16*;
  Layer l0{(bfp)wi0, (bfp)bi0, (bfp)wh0, (bfp)bh0};
  Layer l1{(bfp)wi1, (bfp)bi1, (bfp)wh1, (bfp)bh1};
  size_t smem = (size_t)(RB * E + L * RB * R) * sizeof(__nv_bfloat16);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lstm_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((B + RB - 1) / RB);
  lstm_encode_kernel<<<grid, R, smem, (cudaStream_t)stream>>>(
      (const float*)emb, (const int*)lengths, l0, l1, (float*)out, B, T, E, R, L);
  return (int)cudaGetLastError();
}
