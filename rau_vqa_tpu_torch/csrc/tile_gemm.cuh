// The grid-level tile GEMM of the training hop loop's two kernels
// (rau_train_hops_fwd.cu, rau_train_hops_bwd.cu) and of the serving hop
// loop (rau_hops.cu).
//
// out[m, n] = epi(m, n, sum_k A(m, k) B(k, n)) over a grid of output tiles,
// one CTA a tile: blockIdx.x walks the n tiles (so neighbouring CTAs share
// their A rows in L2), blockIdx.y the m tiles, and blockIdx.z the chunks of
// a split K (the weight grads: each chunk writes its own partial [M, N] to
// out + z * M * N, which a later kernel sums in a fixed order; no atomics).
//
// Both operands are in T, the products' type (the kernels write a bf16
// copy of each float32 operand where they produce it: rounding there is
// JAX's astype before its dot).  Each is read with either index contiguous
// (Operand: element (r, k) at p[r * ld + k] when kc, else p[k * ld + r]),
// so a product with a transposed weight or a transposed workspace needs no
// copy.  Shared memory keeps each operand in its global layout, 16-byte
// chunks along the contiguous index, in a ring of STAGES k-slices filled by
// cp.async (zero-filled past the ragged edges); an operand whose rows are
// not 16-byte aligned (a leading dimension of 196 bf16) is staged by plain
// loads instead.  Two bodies, by the tile's configuration:
//
// - FmaCfg: register-tiled FMAs (BM x BN a CTA, TM x TN a thread), each
//   output summed in ascending k in one float32 chain: exact float32.  It
//   also takes bf16 operands, staged by plain loads converted to float32:
//   each product of two bf16 values is exact in float32, so its sums are
//   those of a float32 product of the rounded operands;
// - MmaCfg (bf16 operands): mma.sync m16n8k16 on ldmatrix fragments (.trans for an
//   operand kept k-major) with float32 sums (mma_bf16.cuh), each k-slice's
//   sums added to the running ones in float32: JAX's dot(bf16, bf16) -> f32
//   up to the order of the sums.
//
// The epilogue is one of the Op codes below, a switch outside the K loop:
// the biases, tanh, the bias order of JAX's sums, the masks and the
// in-place scales of the phases; with ``emit`` set it also
// writes the value in T (an emission, or the bf16 copy of an operand).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "maskgen.cuh"
#include "mma_bf16.cuh"

namespace tg {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}
template <class T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// one operand in T: element (r, k) at p[r * ld + k] when kc, else at
// p[k * ld + r]; async when p and ld keep every 16-byte chunk aligned
struct Operand {
  const void* p;
  long long ld;
  int kc;
  int async;
};

// epilogues; v0 / v1 are [rows, N] float32 (rows = M, or M / rdiv where
// named), bias0 / bias1 [N] in T
enum Op {
  STORE,      // out = acc                                   (also the split-K partials)
  QFEAT,      // out = tanh(((v0 + bias0) + acc) + bias1)
  BIAS,       // out = acc + bias0
  TANH_BIAS,  // out = tanh(acc + bias0)
  ADDFEAT,    // out = tanh((acc + bias0) + v0[m / rdiv])
  JOIN,       // out = ((v0 + v1) + acc) + bias0
  GATES,      // out = ((v0 + bias0) + acc) + bias1
  MERGE,      // emit2 = mask((v0 + acc) + bias0); out = mask(v1) (the merge site)
  ADD,        // out = v0 + acc
  DPREQ,      // out = (v0 + acc) (1 - v1^2)
  DPREI,      // out = (v0[m] v1[m / rdiv] + acc) (1 - out^2), in place
  // the forward's, on a tile with fwd_ops alone: in every product's
  // epilogue they cost the backward 4-5% (PERF.md)
  MERGE_D,       // emit2 = mask((v0 + acc) + bias0) (MERGE without a cotangent)
  SIGMOID_BIAS,  // out = sigmoid(acc + bias0)
};

struct Epi {
  int op;
  float* out;
  void* emit;   // [M, N] in T: out's value (null: none)
  void* emit2;  // MERGE: merge_d in T
  const float* v0;
  const float* v1;
  const void* bias0;
  const void* bias1;
  int rdiv;
  // the merge site's mask (MERGE): seed on the device, hop, rate
  const int* seed;
  int hop;
  uint32_t thresh;
  float scale;
  int mask_on;
};

struct Problem {
  Operand a, b;
  int M, N, K;
  int kchunk;  // K a chunk (gridDim.z chunks); K when not split
  Epi e;
};

__device__ __forceinline__ maskgen::Site merge_site(const Epi& e) {
  return {maskgen::site_salt((uint32_t)e.seed[0], e.hop, maskgen::SITE_MERGE), e.thresh,
          e.scale, e.mask_on != 0};
}

// kFwdOps: with the forward's ops
template <class T, bool kFwdOps>
__device__ __forceinline__ void epilogue(const Problem& pr, int m, int n, float acc) {
  const Epi& e = pr.e;
  const int N = pr.N;
  const size_t o = (size_t)m * N + n;
  const size_t ov = (size_t)(m / e.rdiv) * N + n;
  const T* b0 = static_cast<const T*>(e.bias0);
  const T* b1 = static_cast<const T*>(e.bias1);
  if constexpr (kFwdOps) {
    if (e.op == MERGE_D) {
      put(static_cast<T*>(e.emit2), o,
          merge_site(e).apply((e.v0[o] + acc) + to_f(b0[n]), (uint32_t)o));
      return;
    }
    if (e.op == SIGMOID_BIAS) {
      e.out[o] = 1.0f / (1.0f + expf(-(acc + to_f(b0[n]))));
      return;
    }
  }
  float v;
  switch (e.op) {
    case STORE:
      e.out[(size_t)blockIdx.z * pr.M * N + o] = acc;
      return;
    case QFEAT:
      v = tanhf(((e.v0[o] + to_f(b0[n])) + acc) + to_f(b1[n]));
      break;
    case BIAS:
      v = acc + to_f(b0[n]);
      break;
    case TANH_BIAS:
      v = tanhf(acc + to_f(b0[n]));
      break;
    case ADDFEAT:
      v = tanhf((acc + to_f(b0[n])) + e.v0[ov]);
      break;
    case JOIN:
      v = ((e.v0[o] + e.v1[o]) + acc) + to_f(b0[n]);
      break;
    case GATES:
      v = ((e.v0[o] + to_f(b0[n])) + acc) + to_f(b1[n]);
      break;
    case MERGE: {
      const maskgen::Site mm = merge_site(e);
      put(static_cast<T*>(e.emit2), o, mm.apply((e.v0[o] + acc) + to_f(b0[n]), (uint32_t)o));
      v = mm.apply(e.v1[o], (uint32_t)o);
      break;
    }
    case ADD:
      v = e.v0[o] + acc;
      break;
    case DPREQ: {
      const float x = e.v1[o];
      v = (e.v0[o] + acc) * (1.0f - x * x);
      break;
    }
    default: {  // DPREI
      const float x = e.out[o];
      v = (e.v0[m] * e.v1[ov] + acc) * (1.0f - x * x);
      break;
    }
  }
  e.out[o] = v;
  if (e.emit) put(static_cast<T*>(e.emit), o, v);
}

// ---------------------------------------------------------------------------
// Staging: one operand's k-slice [ROWS x BK] into shared memory in its
// global layout -- KC: [ROWS][BK + V], else [BK][ROWS + V] -- as 16-byte
// chunks of V elements of T along the contiguous index, by the CTA's NT
// threads.  The operand is in S: T, or bf16 converted to a float T.
// ---------------------------------------------------------------------------

// an operand's element of S as T: as it is, or bf16 to float
template <class T, class S>
__device__ __forceinline__ T elem(S x) {
  if constexpr (std::is_same<S, T>::value)
    return x;
  else
    return to_f(x);
}

template <class T, int ROWS, int BK, bool KC, int NT, class S = T>
struct Stage {
  static constexpr int V = 16 / sizeof(T);
  static constexpr int LD = KC ? BK + V : ROWS + V;  // elements a line
  static constexpr int SIZE = (KC ? ROWS : BK) * LD;  // elements a slice
  static constexpr int CPL = (KC ? BK : ROWS) / V;    // chunks a line
  static constexpr int CHUNKS = CPL * (KC ? ROWS : BK);
  static_assert((KC ? BK : ROWS) % V == 0, "whole chunks a line");

  __device__ __forceinline__ static void load(T* dst, const Operand& o, int r0, int rmax,
                                              int k0, int kend) {
    const S* src = static_cast<const S*>(o.p);
    for (int c = threadIdx.x; c < CHUNKS; c += NT) {
      const int line = c / CPL, q = (c % CPL) * V;
      const int li = KC ? r0 + line : k0 + line;    // the strided index
      const int ci = KC ? k0 + q : r0 + q;          // the contiguous one
      const int lmax = KC ? rmax : kend, cmax = KC ? kend : rmax;
      const int n = li < lmax ? max(0, min(V, cmax - ci)) : 0;
      const S* s = n > 0 ? src + (size_t)li * o.ld + ci : src;
      T* d = dst + line * LD + q;
      if (std::is_same<S, T>::value && o.async) {
        mma::cp_async16_n(mma::smem_u32(d), s, n * (int)sizeof(T));
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) d[e] = e < n ? elem<T>(s[e]) : from_f<T>(0.f);
      }
    }
  }
};

// The K loop of one CTA of tile C: a ring of STAGES slices, each of A's then
// B's Stage (operands in S, kept in T); body(a_slice, b_slice) multiplies one.
template <class T, class S, class C, bool AKC, bool BKC, class Body>
__device__ __forceinline__ void k_loop(const Problem& pr, T* smem, int m0, int n0, int kbeg,
                                       int kend, Body body) {
  constexpr int BK = C::BK, STAGES = C::STAGES;
  using SA = Stage<T, C::BM, BK, AKC, C::NT, S>;
  using SB = Stage<T, C::BN, BK, BKC, C::NT, S>;
  constexpr int SLICE = SA::SIZE + SB::SIZE;
  const int nk = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;
  auto issue = [&](int it) {
    if (it < nk) {
      T* s = smem + (it % STAGES) * SLICE;
      const int k0 = kbeg + it * BK;
      SA::load(s, pr.a, m0, pr.M, k0, kend);
      SB::load(s + SA::SIZE, pr.b, n0, pr.N, k0, kend);
    }
    mma::cp_async_commit();
  };
#pragma unroll
  for (int it = 0; it < STAGES - 1; ++it) issue(it);
  for (int it = 0; it < nk; ++it) {
    mma::cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice it is in; slice it - 1's slot is free
    issue(it + STAGES - 1);
    const T* s = smem + (it % STAGES) * SLICE;
    body(s, s + SA::SIZE);
  }
}

// ---------------------------------------------------------------------------
// float body: BM x BN a CTA, TM x TN a thread.  A thread's rows are two runs
// of TM / 2 (at ty TM / 2 and BM / 2 + ty TM / 2).  Its columns likewise
// when B is kept n-major (float4 reads along n), two k a step (float2 reads
// along a k-major A); when B is kept k-major they interleave (tx + 16 j), so
// that a warp's reads along k fall on distinct rows' banks, one k a step.
// Each output's sum runs in ascending k.
// ---------------------------------------------------------------------------

template <int BM_, int BN_, int BK_, int STAGES_, int TM_, int TN_, bool FWD_OPS = false>
struct FmaCfg {
  static constexpr bool mma = false;
  static constexpr bool fwd_ops = FWD_OPS;  // the epilogue takes MERGE_D and SIGMOID_BIAS
  using Elem = float;  // the type kept in shared memory
  static constexpr int BM = BM_, BN = BN_, BK = BK_, STAGES = STAGES_, TM = TM_, TN = TN_;
  static constexpr int NT = (BM / TM) * (BN / TN);  // one thread a TM x TN block
};

// CTAs a SM of the float body: two (at most 128 registers a thread) but where
// both operands are k-major, which needs more registers than that not to spill
template <bool AKC, bool BKC>
constexpr int kFmaMinCtas = AKC && BKC ? 1 : 2;

template <int H>
__device__ __forceinline__ void ld_run(float* r, const float* p) {
  if constexpr (H % 4 == 0) {
#pragma unroll
    for (int i = 0; i < H; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      r[i] = v.x;
      r[i + 1] = v.y;
      r[i + 2] = v.z;
      r[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < H; ++i) r[i] = p[i];
  }
}

// the i-th of a thread's T2 rows (or columns) of a ROWS-row tile: two runs
// of T2 / 2, or interleaved at a stride of ROWS / T2
template <int T2, int ROWS>
__device__ __forceinline__ int row_of(int t, int i, bool interleave) {
  constexpr int H = T2 / 2;
  if (interleave) return t + (ROWS / T2) * i;
  return i < H ? t * H + i : ROWS / 2 + t * H + i - H;
}

// x[j][i]: k = kk + j of the thread's i-th row (or column) from a slice, the
// rows in two runs
template <int T2, int ROWS, bool KC, int LD>
__device__ __forceinline__ void fma_frag2(float (&x)[2][T2], const float* s, int t, int kk) {
  constexpr int H = T2 / 2;
  if constexpr (KC) {
#pragma unroll
    for (int i = 0; i < T2; ++i) {
      const float2 v =
          *reinterpret_cast<const float2*>(s + row_of<T2, ROWS>(t, i, false) * LD + kk);
      x[0][i] = v.x;
      x[1][i] = v.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      ld_run<H>(x[j], s + (kk + j) * LD + t * H);
      ld_run<H>(x[j] + H, s + (kk + j) * LD + ROWS / 2 + t * H);
    }
  }
}

// x[i]: k = kk of the thread's i-th row (or column) from a slice
template <int T2, int ROWS, bool KC, int LD>
__device__ __forceinline__ void fma_frag1(float (&x)[T2], const float* s, int t, int kk,
                                          bool interleave) {
  constexpr int H = T2 / 2;
  if constexpr (KC) {
#pragma unroll
    for (int i = 0; i < T2; ++i) x[i] = s[row_of<T2, ROWS>(t, i, interleave) * LD + kk];
  } else {
    ld_run<H>(x, s + kk * LD + t * H);
    ld_run<H>(x + H, s + kk * LD + ROWS / 2 + t * H);
  }
}

// S: the operands' type, float or bf16
template <class C, bool AKC, bool BKC, class S>
__global__ void __launch_bounds__(C::NT, kFmaMinCtas<AKC, BKC>) gemm_fma(Problem pr) {
  constexpr int BM = C::BM, BN = C::BN, BK = C::BK, TM = C::TM, TN = C::TN;
  using SA = Stage<float, BM, BK, AKC, C::NT>;
  using SB = Stage<float, BN, BK, BKC, C::NT>;
  extern __shared__ __align__(16) float smem_f[];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * pr.kchunk;
  const int kend = min(pr.K, kbeg + pr.kchunk);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  k_loop<float, S, C, AKC, BKC>(
      pr, smem_f, m0, n0, kbeg, kend, [&](const float* as, const float* bs) {
        if constexpr (BKC) {
#pragma unroll 4
          for (int kk = 0; kk < BK; ++kk) {
            float a[TM], b[TN];
            fma_frag1<TM, BM, AKC, SA::LD>(a, as, ty, kk, false);
            fma_frag1<TN, BN, true, SB::LD>(b, bs, tx, kk, true);
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
              for (int n = 0; n < TN; ++n) acc[i][n] = fmaf(a[i], b[n], acc[i][n]);
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < BK; kk += 2) {
            float a[2][TM], b[2][TN];
            fma_frag2<TM, BM, AKC, SA::LD>(a, as, ty, kk);
            fma_frag2<TN, BN, false, SB::LD>(b, bs, tx, kk);
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int n = 0; n < TN; ++n) acc[i][n] = fmaf(a[j][i], b[j][n], acc[i][n]);
          }
        }
      });
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + row_of<TM, BM>(ty, i, false);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + row_of<TN, BN>(tx, j, BKC);
      if (m < pr.M && n < pr.N) epilogue<S, C::fwd_ops>(pr, m, n, acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 body: BM x BN a CTA, WM x WN warps, each a (BM / WM) x (BN / WN)
// block of m16n8 products.  Fragments by ldmatrix from either layout: a
// k-contiguous operand's rows as they are, a row-contiguous one's with
// .trans (each 8 x 8 matrix is 8 k-lines of 8 rows).  Lines of 16-byte
// multiples with 16 bytes of padding put ldmatrix's eight row addresses in
// eight distinct bank groups.  Each k-slice's products accumulate in fresh
// registers, which are then added to the running float32 sums: the tensor
// cores' accumulation aligns its addends to the largest one and drops the
// bits below, so a long K summed inside them drifts from a float32 sum by
// more than the order of the sums does.
// ---------------------------------------------------------------------------

template <int BM_, int BN_, int BK_, int STAGES_, int WM_, int WN_, bool FWD_OPS = false>
struct MmaCfg {
  static constexpr bool mma = true;
  static constexpr bool fwd_ops = FWD_OPS;  // the epilogue takes MERGE_D and SIGMOID_BIAS
  using Elem = __nv_bfloat16;  // the type kept in shared memory
  static constexpr int BM = BM_, BN = BN_, BK = BK_, STAGES = STAGES_, WM = WM_, WN = WN_;
  static constexpr int NT = WM * WN * 32;
  static constexpr int MI = BM / WM / 16, NJ = BN / WN / 8;
  static_assert(MI >= 1 && NJ >= 2 && NJ % 2 == 0 && BK % 16 == 0,
                "whole m16 tiles, pairs of n8 tiles, k16 steps");
};

template <class C, bool AKC, bool BKC>
__global__ void __launch_bounds__(C::NT) gemm_mma(Problem pr) {
  using bf16 = __nv_bfloat16;
  constexpr int BM = C::BM, BN = C::BN, BK = C::BK, MI = C::MI, NJ = C::NJ;
  constexpr int WTM = BM / C::WM, WTN = BN / C::WN;
  using SA = Stage<bf16, BM, BK, AKC, C::NT>;
  using SB = Stage<bf16, BN, BK, BKC, C::NT>;
  extern __shared__ __align__(16) bf16 smem_h[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * pr.kchunk;
  const int kend = min(pr.K, kbeg + pr.kchunk);
  float acc[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  // this lane's ldmatrix address (elements) within a slice, before the
  // tile's and the k step's offsets: A's four 8 x 8 matrices are (m, k) =
  // (0, 0), (8, 0), (0, 8), (8, 8); B's (n, k) = (0, 0), (0, 8), (8, 0),
  // (8, 8), two n8 tiles
  const int a_lane = AKC ? (wm * WTM + (lane & 15)) * SA::LD + (lane >> 4) * 8
                         : ((lane & 7) + ((lane >> 4) << 3)) * SA::LD + wm * WTM +
                               ((lane >> 3) & 1) * 8;
  const int b_lane = BKC ? (wn * WTN + (lane & 7) + ((lane >> 4) << 3)) * SB::LD +
                               ((lane >> 3) & 1) * 8
                         : ((lane & 7) + (((lane >> 3) & 1) << 3)) * SB::LD + wn * WTN +
                               ((lane >> 4) << 3);
  k_loop<bf16, bf16, C, AKC, BKC>(
      pr, smem_h, m0, n0, kbeg, kend, [&](const bf16* as, const bf16* bs) {
        const uint32_t a_base = mma::smem_u32(as + a_lane);
        const uint32_t b_base = mma::smem_u32(bs + b_lane);
        float part[MI][NJ][4];
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < BK; ks += 16) {
          uint32_t af[MI][4], bfr[NJ][2];
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            if constexpr (AKC)
              mma::ldsm_x4(af[i], a_base + (i * 16 * SA::LD + ks) * 2);
            else
              mma::ldsm_x4_t(af[i], a_base + (ks * SA::LD + i * 16) * 2);
          }
#pragma unroll
          for (int j = 0; j < NJ; j += 2) {
            uint32_t r[4];
            if constexpr (BKC)
              mma::ldsm_x4(r, b_base + (j * 8 * SB::LD + ks) * 2);
            else
              mma::ldsm_x4_t(r, b_base + (ks * SB::LD + j * 8) * 2);
            bfr[j][0] = r[0];
            bfr[j][1] = r[1];
            bfr[j + 1][0] = r[2];
            bfr[j + 1][1] = r[3];
          }
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j) mma::mma_bf16(part[i][j], af[i], bfr[j][0], bfr[j][1]);
        }
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
      });
  // c0, c1: row lane / 4, columns 2 (lane % 4) + {0, 1}; c2, c3: 8 rows on
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * WTM + i * 16 + (lane >> 2) + (e >> 1) * 8;
        const int n = n0 + wn * WTN + j * 8 + (lane & 3) * 2 + (e & 1);
        if (m < pr.M && n < pr.N) epilogue<bf16, C::fwd_ops>(pr, m, n, acc[i][j][e]);
      }
}

// the two tiles of each body: Big for the [B*S, *] products and the split-K
// weight grads, Small (a deeper k-slice) for the [B, *] ones; the training
// forward's [B, *] products take FmaSmallFwd, the same tile with the
// forward's ops, and the serving hop loop's (rau_hops.cu) MmaSmallFwd
using FmaBig = FmaCfg<128, 128, 16, 3, 8, 8>;
using FmaSmall = FmaCfg<32, 32, 32, 3, 2, 2>;
using FmaSmallFwd = FmaCfg<32, 32, 32, 3, 2, 2, true>;
using MmaBig = MmaCfg<128, 128, 32, 3, 4, 4>;
using MmaSmall = MmaCfg<32, 64, 64, 3, 2, 4>;
using MmaSmallFwd = MmaCfg<32, 64, 64, 3, 2, 4, true>;

// dynamic shared memory of tile C with these layouts, in bytes
template <class C, bool AKC, bool BKC>
constexpr int smem_bytes() {
  using E = typename C::Elem;
  return C::STAGES *
         (Stage<E, C::BM, C::BK, AKC, C::NT>::SIZE + Stage<E, C::BN, C::BK, BKC, C::NT>::SIZE) *
         (int)sizeof(E);
}

// One product's launch with tile C: grid (N / BN, M / BM, K / kchunk), each
// rounded up, and the dynamic shared memory of its operands' layouts.
template <class C>
void shape(const Problem& pr, dim3* grid, int* smem) {
  *grid = dim3((pr.N + C::BN - 1) / C::BN, (pr.M + C::BM - 1) / C::BM,
               (pr.K + pr.kchunk - 1) / pr.kchunk);
  *smem = pr.a.kc ? (pr.b.kc ? smem_bytes<C, true, true>() : smem_bytes<C, true, false>())
                  : (pr.b.kc ? smem_bytes<C, false, true>() : smem_bytes<C, false, false>());
}

// T: the operands' type
template <class T, class C, bool AKC, bool BKC>
cudaError_t launch_as(const Problem& pr, dim3 grid, cudaStream_t st) {
  static_assert(!C::mma || std::is_same<T, __nv_bfloat16>::value, "mma.sync takes bf16");
  constexpr int bytes = smem_bytes<C, AKC, BKC>();
  auto kernel = [] {
    if constexpr (C::mma)
      return gemm_mma<C, AKC, BKC>;
    else
      return gemm_fma<C, AKC, BKC, T>;
  }();
  // the opt-in above 48 KB is the current device's: set on every launch
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<grid, C::NT, bytes, st>>>(pr);
  return cudaGetLastError();
}

// Enqueues one product with tile C on the stream, as shape() describes it;
// the kernel by the operands' layouts.
template <class T, class C>
cudaError_t launch(const Problem& pr, cudaStream_t st) {
  if (!C::fwd_ops && pr.e.op >= MERGE_D) return cudaErrorNotSupported;
  dim3 grid;
  int smem;
  shape<C>(pr, &grid, &smem);
  if (pr.a.kc)
    return pr.b.kc ? launch_as<T, C, true, true>(pr, grid, st)
                   : launch_as<T, C, true, false>(pr, grid, st);
  return pr.b.kc ? launch_as<T, C, false, true>(pr, grid, st)
                 : launch_as<T, C, false, false>(pr, grid, st);
}

}  // namespace tg
