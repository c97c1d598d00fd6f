// Question-encoder LSTM over all timesteps and layers, for sm_90a.
//
// Replaces: rau_vqa_tpu/ops/lstm_encoder.py, lstm_encode_pallas (:81), whose
// Pallas body is _kernel (:57-77) with the cell in _cell_step (:28-54).
//
// Computes: the DeepLSTM (gate layout [i, f, o | g]) over T tokens for each
// batch row, and keeps the packed state (c1, h1, c2, h2) at the step where
// lengths == t + 1; a row whose length lies outside [1, T] stays zero.  Dot
// operands are rounded to bf16, products are summed in f32, the state stays
// f32, as in _cell_step.
//
// What bounds it on an H100.  On paper, operations: the work is a chain of
// 2T small products; at B=512, T=26 each layer-step is [512, 712 or 1024] x
// [.., 2048] in bf16, 94.6 GFLOP in all (~0.05-0.1 ms at the tensor-core
// peak), against 7.1 MB of weights.  The TPU kernel keeps the weights in VMEM
// and runs the products on the MXU.  One SM's 227 KB cannot hold 7.1 MB, and
// a step needs the whole previous h of every row, so in practice the limits
// are (1) the weights, if they were streamed every step, (2) the exchange of
// h between the SMs that compute it: every SM reads every row's h each step,
// and (3) at small B, the latency of a grid-wide barrier.  Measured
// (chip_smoke.py, one H100): 0.67 ms at B=512 (13x the operations bound, set
// by the h reads through L2) and 0.13 ms at B=1 (~4.8 us a step).
//
// Design.  One cooperative grid of about one CTA per SM runs the whole call:
// - Weights resident.  CTA c of a row group owns the hidden units
//   [c U, c U + U) and all four of their gate columns, so the cell update
//   stays in the CTA.  Its slab of the stacked weights ([wi0; wh0] with
//   K0 = E16 + R, [wi1; wh1] with K1 = 2R; E16 is E rounded up to 16) is
//   read from device memory once per call into shared memory, laid out
//   [4U columns][K] so that ldmatrix gives mma's B fragments directly
//   (pack_encoder_weights makes that layout once per parameter set).
//   At R=512, U=4 that is 16 x 1,736 x 2 B = 55.6 KB a CTA.
// - Tensor cores.  Each layer-step is C[rows, 4U] = [x_t | h_{t-1}] W on
//   bf16 mma.sync m16n8k16 with f32 sums.  Rows are the M dimension: a job
//   is 32 rows x one K split; the 16 warps take the jobs, and at small B the
//   K dimension is split S ways so that every warp works; the S partial sums
//   are added in a fixed order (no atomics: two calls give the same bits).
// - h exchange.  Each layer's new h goes, in bf16, to a double-buffered
//   global scratch stored in mma A-fragment order, so a lane reads its whole
//   16x16 fragment with one 16-byte load, through L2 (ld.global.cg: the
//   buffers are rewritten by other SMs within the call).  c lives in the
//   owning CTA's shared memory, the f32 h only as long as the update.  x is
//   converted to bf16 once per call, in the same layout, in the prologue.
// - A wavefront of layers: phase p runs layer 0 at step p beside layer 1 at
//   step p - 1, so a call takes one grid barrier a phase, T + 1 in all at
//   L = 2, and stops at the batch's longest length (read on the device).
// - Row groups.  With RG = 2 the grid splits into two groups that each own
//   all units (U twice as large) for half of the rows: each SM then reads
//   half as many h rows a step, for twice the weights.
// Rows beyond what one pass holds in shared memory (c and the gate sums) run
// in further passes over the same grid.  Launched with
// cudaLaunchCooperativeKernel on the caller's stream; if the grid cannot be
// co-resident the launch fails and the wrapper raises.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace mma;
typedef __nv_bfloat16 bf16;

constexpr int NTHREADS = 512;  // 16 warps
constexpr int NWARPS = NTHREADS / 32;
constexpr int ROWS = 32;       // rows of a job: two m16 tiles
constexpr int PAD = 8;         // bf16 of row padding of a weight slab (ldmatrix banks)
constexpr int KB = 2;          // k-tiles a step of the A-fragment prefetch

__device__ __forceinline__ float sigm(float x) { return 1.0f / (1.0f + expf(-x)); }

// Element offset of (row, col) in a buffer of 16x16 bf16 tiles kept in mma
// A-fragment order: tile (row / 16, col / 16) of a [.., kts tiles] matrix is
// 32 lanes x 8 values, lane-major, so lane l's a0..a3 are 16 contiguous bytes.
__device__ __forceinline__ size_t frag_off(int row, int col, int kts) {
  const int r = row & 15, c = col & 15;
  const int lane = (r & 7) * 4 + ((c & 7) >> 1);
  const int reg = (r >> 3) + 2 * (c >> 3);
  return (((size_t)(row >> 4) * kts + (col >> 4)) * 32 + lane) * 8 + reg * 2 + (c & 1);
}

struct Args {
  const float* emb;      // [B, T, E] f32
  const int* lengths;    // [B]
  const bf16* w[2];      // packed slabs [R][4][K_l]
  const float* bias;     // [L][R][4] f32, bi + bh
  bf16* xbuf;            // [T][RG*BCg rows][E16] in fragment order
  bf16* hbuf;            // [L][2][RG*BCg rows][R] in fragment order
  float* out;            // [B, 2 L R]
  int B, T, E, R, L, RG, S, BCg;
};

// shared memory layout, in bytes; the Python plan (ops/lstm_encoder.py,
// smem_bytes) computes the same total, and the launcher checks that it does
struct Smem {
  int w1, bias, g, c, total;
  __host__ __device__ Smem(int U, int E, int R, int L, int S, int BCg) {
    const int N = 4 * U, E16 = (E + 15) / 16 * 16;
    w1 = N * (E16 + R + PAD) * 2;  // layer 0's slab starts at 0
    bias = w1 + (L > 1 ? N * (2 * R + PAD) * 2 : 0);
    g = bias + L * N * 4;
    c = g + L * S * BCg * N * 4;
    total = c + L * BCg * U * 4;
  }
};

// A fragments of k-tiles [kt, kt + KB) of m-tiles mt0, mt0 + 1 (zero past
// k1).  A's k-tiles [0, kta) come from seg_a, the rest from seg_b, both
// fragment buffers with kta and ktb tiles a row.
__device__ __forceinline__ void load_a(uint4 (&a)[KB][2], const uint4* seg_a, int kta,
                                       const uint4* seg_b, int ktb, int mt0, int kt, int k1) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < KB; ++q) {
    const int k = kt + q;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (k < k1) {
        const uint4* p = k < kta ? seg_a + ((size_t)(mt0 + i) * kta + k) * 32
                                 : seg_b + ((size_t)(mt0 + i) * ktb + (k - kta)) * 32;
        a[q][i] = __ldcg(p + lane);
      } else {
        a[q][i] = make_uint4(0, 0, 0, 0);
      }
    }
  }
}

// acc += A[k-tiles kt .. kt + KB) W[.., 8 NT] with B fragments from the
// resident slab by ldmatrix: w_lane is this lane's row address (column
// (lane >> 4) * 8 + (lane & 7), k offset ((lane >> 3) & 1) * 8), ldw the
// slab's row length.
template <int NT>
__device__ __forceinline__ void mma_a(float (&acc)[2][NT][4], const uint4 (&a)[KB][2], int kt,
                                      int k1, uint32_t w_lane, int ldw) {
#pragma unroll
  for (int q = 0; q < KB; ++q) {
    if (kt + q < k1) {
      const uint32_t wk = w_lane + (kt + q) * 16 * 2;
      uint32_t b[NT][2];
      if (NT == 1) {
        uint32_t r[2];
        ldsm_x2(r, wk);
        b[0][0] = r[0];
        b[0][1] = r[1];
      } else {
#pragma unroll
        for (int j = 0; j + 1 < NT; j += 2) {
          uint32_t r[4];
          ldsm_x4(r, wk + j * 8 * ldw * 2);
          b[j][0] = r[0];
          b[j][1] = r[1];
          b[j + 1][0] = r[2];
          b[j + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t af[4] = {a[q][i].x, a[q][i].y, a[q][i].z, a[q][i].w};
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], af, b[j][0], b[j][1]);
      }
    }
  }
}

// One job: acc = A[32 rows of m-tiles mt0, mt0 + 1][k-tiles k0 .. k1) W.
// The next KB k-tiles' A fragments are in flight while these KB multiply.
template <int NT>
__device__ __forceinline__ void job(float (&acc)[2][NT][4], const uint4* seg_a, int kta,
                                    const uint4* seg_b, int ktb, int mt0, int k0, int k1,
                                    uint32_t w_lane, int ldw) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  uint4 a0[KB][2], a1[KB][2];
  load_a(a0, seg_a, kta, seg_b, ktb, mt0, k0, k1);
  for (int kt = k0; kt < k1; kt += 2 * KB) {
    load_a(a1, seg_a, kta, seg_b, ktb, mt0, kt + KB, k1);
    mma_a<NT>(acc, a0, kt, k1, w_lane, ldw);
    if (kt + KB >= k1) break;
    load_a(a0, seg_a, kta, seg_b, ktb, mt0, kt + 2 * KB, k1);
    mma_a<NT>(acc, a1, kt + KB, k1, w_lane, ldw);
  }
}

template <int U>
__global__ void __launch_bounds__(NTHREADS, 1) lstm_encode_kernel(Args a) {
  constexpr int N = 4 * U;       // gate columns a CTA owns, n = u * 4 + gate
  constexpr int NT = N / 8;      // n8 tiles
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  __shared__ int s_tmax;

  const int B = a.B, T = a.T, E = a.E, R = a.R, L = a.L, S = a.S, BCg = a.BCg;
  const int E16 = (E + 15) / 16 * 16;
  const int KX = E16 / 16, KH = R / 16;
  const int K0 = E16 + R, K1 = 2 * R;
  const int ncg = R / U;                         // CTAs a row group
  const int grp = blockIdx.x / ncg;
  const int u0 = (blockIdx.x % ncg) * U;
  const int rows_c = a.RG * BCg;                 // rows a pass, all groups
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Smem lay(U, E, R, L, S, BCg);
  bf16* ws0 = reinterpret_cast<bf16*>(smem);
  bf16* ws1 = reinterpret_cast<bf16*>(smem + lay.w1);
  float* sbias = reinterpret_cast<float*>(smem + lay.bias);
  float* sg = reinterpret_cast<float*>(smem + lay.g);
  float* sc = reinterpret_cast<float*>(smem + lay.c);

  // the CTA's weight slabs and biases, once per call
  for (int l = 0; l < L; ++l) {
    const int K = l ? K1 : K0, cpr = K / 8;      // 16-byte chunks a row
    const bf16* src = a.w[l] + (size_t)u0 * 4 * K;
    bf16* dst = l ? ws1 : ws0;
    for (int i = tid; i < N * cpr; i += NTHREADS) {
      const int n = i / cpr, q = i - n * cpr;
      cp_async16(smem_u32(dst + n * (K + PAD) + q * 8), src + (size_t)n * K + q * 8, true);
    }
    for (int i = tid; i < N; i += NTHREADS) sbias[l * N + i] = a.bias[((size_t)l * R + u0) * 4 + i];
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const size_t hslot = (size_t)rows_c * R;       // one layer-slot of hbuf
  const uint4* xb = reinterpret_cast<const uint4*>(a.xbuf);
  const int D = 2 * L * R;

  for (int chunk0 = 0; chunk0 < B; chunk0 += rows_c) {
    const int g0 = chunk0 + grp * BCg;            // this group's first row
    const int rows_g = max(0, min(BCg, B - g0));
    const int rt_g = (rows_g + ROWS - 1) / ROWS;  // this group's jobs a layer and split
    // the pass's longest question, the same in every CTA
    if (tid == 0) s_tmax = 0;
    __syncthreads();
    int tm = 0;
    for (int i = tid; i < min(rows_c, B - chunk0); i += NTHREADS) tm = max(tm, a.lengths[chunk0 + i]);
    atomicMax(&s_tmax, tm);
    for (int i = tid; i < L * BCg * U; i += NTHREADS) sc[i] = 0.f;
    // a row keeps zeros unless its length lies in [1, T]
    for (int i = tid; i < rows_g * L * 2 * U; i += NTHREADS) {
      const int r = i / (L * 2 * U), q = i - r * (L * 2 * U);
      a.out[(size_t)(g0 + r) * D + (q / U) * R + u0 + q % U] = 0.f;
    }
    __syncthreads();
    const int tmax = min(s_tmax, T);
    // x_t in bf16 for every row of the pass (zero beyond B and E), and h_{-1} = 0
    {
      const int kp = E16 / 2, n_x = tmax * rows_c * kp;
      for (int i = blockIdx.x * NTHREADS + tid; i < n_x; i += gridDim.x * NTHREADS) {
        const int k = (i % kp) * 2, cr = (i / kp) % rows_c, t = i / (kp * rows_c);
        const int b = chunk0 + cr;
        float v0 = 0.f, v1 = 0.f;
        if (b < B) {
          const float* e = a.emb + ((size_t)b * T + t) * E;
          if (k < E) v0 = e[k];
          if (k + 1 < E) v1 = e[k + 1];
        }
        *reinterpret_cast<__nv_bfloat162*>(a.xbuf + (size_t)t * rows_c * E16 + frag_off(cr, k, KX)) =
            __floats2bfloat162_rn(v0, v1);
      }
      uint4* hb = reinterpret_cast<uint4*>(a.hbuf);
      const size_t n_h = (size_t)L * 2 * hslot / 8;
      for (size_t i = blockIdx.x * NTHREADS + tid; i < n_h; i += (size_t)gridDim.x * NTHREADS)
        hb[i] = make_uint4(0, 0, 0, 0);
    }
    grid.sync();

    const int phases = tmax > 0 ? tmax + L - 1 : 0;
    for (int p = 0; p < phases; ++p) {
      // active layers: layer 0 at step p, layer 1 at step p - 1
      const int lo = p < tmax ? 0 : 1;
      const int hi = (L > 1 && p >= 1) ? 1 : 0;
      const int n_act = hi - lo + 1;
      const int n_jobs = n_act * rt_g * S;
      for (int j = warp; j < n_jobs; j += NWARPS) {
        const int l = lo + j / (rt_g * S);
        const int rt = (j / S) % rt_g, s = j % S;
        const int t = p - l;
        const int kts = l ? 2 * KH : KX + KH;
        const int k0 = s * kts / S, k1 = (s + 1) * kts / S;
        const int mt0 = (grp * BCg + rt * ROWS) / 16;
        const uint4* seg_a;
        const uint4* seg_b;
        int kta;
        if (l == 0) {   // [x_t | h0_{t-1}]
          seg_a = xb + (size_t)t * rows_c * E16 / 8;
          kta = KX;
          seg_b = reinterpret_cast<const uint4*>(a.hbuf + ((t + 1) & 1) * hslot);
        } else {        // [h0_t | h1_{t-1}]
          seg_a = reinterpret_cast<const uint4*>(a.hbuf + (t & 1) * hslot);
          kta = KH;
          seg_b = reinterpret_cast<const uint4*>(a.hbuf + (2 + ((t + 1) & 1)) * hslot);
        }
        const int ldw = (l ? K1 : K0) + PAD;
        // ldmatrix row address: column n = (lane >> 4) * 8 + (lane & 7) of
        // the n-tile pair, k offset ((lane >> 3) & 1) * 8
        const uint32_t w_lane = smem_u32((l ? ws1 : ws0) + ((lane >> 4) * 8 + (lane & 7)) * ldw +
                                         ((lane >> 3) & 1) * 8);
        float acc[2][NT][4];
        job<NT>(acc, seg_a, kta, seg_b, KH, mt0, k0, k1, w_lane, ldw);
        float* gs = sg + ((size_t)(l * S + s) * BCg + rt * ROWS) * N;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int jn = 0; jn < NT; ++jn) {
            const int r = i * 16 + (lane >> 2), n = jn * 8 + (lane & 3) * 2;
            *reinterpret_cast<float2*>(gs + r * N + n) = make_float2(acc[i][jn][0], acc[i][jn][1]);
            *reinterpret_cast<float2*>(gs + (r + 8) * N + n) = make_float2(acc[i][jn][2], acc[i][jn][3]);
          }
      }
      __syncthreads();
      // the cell update of each (layer, row, unit) the CTA owns
      for (int i = tid; i < n_act * rows_g * U; i += NTHREADS) {
        const int l = lo + i / (rows_g * U);
        const int r = (i / U) % rows_g, u = i % U;
        const int t = p - l;
        float4 pre = *reinterpret_cast<const float4*>(sbias + l * N + u * 4);
        for (int s = 0; s < S; ++s) {
          const float4 v = *reinterpret_cast<const float4*>(sg + ((size_t)(l * S + s) * BCg + r) * N + u * 4);
          pre.x += v.x;
          pre.y += v.y;
          pre.z += v.z;
          pre.w += v.w;
        }
        float* cp = sc + (l * BCg + r) * U + u;
        const float nc = sigm(pre.y) * *cp + sigm(pre.x) * tanhf(pre.w);
        const float nh = sigm(pre.z) * tanhf(nc);
        *cp = nc;
        a.hbuf[(2 * l + (t & 1)) * hslot + frag_off(grp * BCg + r, u0 + u, KH)] = __float2bfloat16(nh);
        const int b = g0 + r;
        if (a.lengths[b] == t + 1) {
          a.out[(size_t)b * D + 2 * l * R + u0 + u] = nc;
          a.out[(size_t)b * D + (2 * l + 1) * R + u0 + u] = nh;
        }
      }
      if (p + 1 < phases || chunk0 + rows_c < B) grid.sync();
    }
  }
}

template <int U>
int launch(const Args& args, int smem, cudaStream_t stream) {
  const int grid = args.RG * (args.R / U);
  auto kern = lstm_encode_kernel<U>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NTHREADS, smem)) !=
      cudaSuccess)
    return (int)e;
  if (per_sm * n_sm < grid) return (int)cudaErrorCooperativeLaunchTooLarge;
  Args a = args;
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)kern, dim3(grid), dim3(NTHREADS), params,
                                  (size_t)smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// emb [B, T, E] f32 (after the embedding tanh), lengths [B] int32; w0, w1 the
// packed slabs [R][4][K_l] bf16 (w1 ignored when L == 1), bias [L][R][4] f32;
// xbuf [T * RG * BCg * E16] and hbuf [L * 2 * RG * BCg * R] bf16 scratch;
// out [B, 2 L R] f32.  The plan (U units a CTA, RG row groups, S K splits,
// BCg rows a group and pass) comes from lstm_plan; smem is its shared-memory
// size, checked here.  Returns a cudaError_t: cudaErrorInvalidValue for a
// shape or plan the kernel does not take, cudaErrorCooperativeLaunchTooLarge
// if the grid cannot be co-resident.
extern "C" int lstm_encode_launch(const void* emb, const void* lengths, const void* w0,
                                  const void* w1, const void* bias, void* xbuf, void* hbuf,
                                  void* out, int B, int T, int E, int R, int L, int U, int RG,
                                  int S, int BCg, int smem, void* stream) {
  if (B <= 0 || T <= 0 || E <= 0 || L < 1 || L > 2 || R % 32 != 0 || R > 512 || RG < 1 ||
      S < 1 || S > 8 || BCg <= 0 || BCg % ROWS != 0 || R % U != 0 ||
      Smem(U, E, R, L, S, BCg).total != smem)
    return (int)cudaErrorInvalidValue;
  Args a{(const float*)emb, (const int*)lengths, {(const bf16*)w0, (const bf16*)w1},
         (const float*)bias, (bf16*)xbuf, (bf16*)hbuf, (float*)out,
         B, T, E, R, L, RG, S, BCg};
  cudaStream_t st = (cudaStream_t)stream;
  switch (U) {
    case 2: return launch<2>(a, smem, st);
    case 4: return launch<4>(a, smem, st);
    case 8: return launch<8>(a, smem, st);
    case 16: return launch<16>(a, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
