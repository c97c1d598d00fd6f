// One training hop's forward as batch-wide phases, shared by the training
// hop loop's forward kernel (rau_train_hops_fwd.cu), which runs it once a
// hop and saves the carries, and its backward (rau_train_hops_bwd.cu), which
// runs it again from the saved carries before each hop's cotangent chain.
// Both enqueue the same phases; each kernel picks the tiles of their
// products.  In float32 both take the FMA tiles, so the backward
// rematerializes the very forward that produced the loss, in the same order
// of sums; in bf16 the forward keeps the FMA body (exact products, float32
// chains) and the backward takes mma.sync.
//
// The hop (_hop_fwd_core, rau_vqa_tpu/ops/rau_train_hops.py:104-167) is a
// fixed sequence of phases, each one launch over the whole batch on one
// stream (stream order is the only synchronisation); "G" is a tile GEMM
// (tile_gemm.cuh), "P" the workspace's [B*S, *] rows:
//   prep      q_d = q qmask, feats_d = feats fmask, both in T (h too, bf16)
//   G qd      q_d Wq -> tmp;  G hmem  h Wmem -> msc;  G qfeat  h Wh (+ tmp, biases)
//   G qatt    qfeat Waq + baq
//   G ifeat   tanh(feats_d Wi + bi)                      P x M, K = Dc
//   G addfeat tanh((ifeat Wa + ba) + qatt[row])          P x F, K = M
//   rows_fwd  score, softmax, pooling                    one CTA a row
//   G join    p Wp (+ qfeat + pool, bp)
//   G gates   join Wli -> tmp;  h Wlh (+ tmp, biases);  cell: c', h'
//   G merge   h' Wmg (+ join, bmg) masked: merge_d in T; the backward also
//             masks its cotangent gmerge there
// tmp carries q_d Wq into qfeat and join Wli into gates: each reader runs
// before the next writer on the stream.  Also here: the dry-run record of
// the launches and the enqueueing helper both kernels' C entries use.

#pragma once

#include <algorithm>
#include <type_traits>

#include "rau_train_hops.cuh"
#include "tile_gemm.cuh"

namespace rth {

// A dry run's record of the launches: grid x, y, z and dynamic shared
// memory bytes of each, in the order they would be enqueued (at most cap;
// n counts them all).
struct Rec {
  int* out;
  int cap;
  int n;
  void add(dim3 g, int smem) {
    if (n < cap) {
      int* o = out + 4 * n;
      o[0] = (int)g.x;
      o[1] = (int)g.y;
      o[2] = (int)g.z;
      o[3] = smem;
    }
    ++n;
  }
};

// A segment of n floats of a scratch buffer at offset off, 256-byte aligned
// (base nullptr only counts).
inline float* take(float* base, size_t& off, size_t n) {
  float* p = base ? base + off : nullptr;
  off += (n + 63) & ~size_t(63);
  return p;
}

// Enqueues a C entry's launches on one stream, or with rec set records
// each launch in place of enqueueing it (the pointers are then unread);
// keeps the first error.  Products take tile BigC ([B*S, *] rows and the
// split weight grads) or SmallC ([B, *] rows).  Operands are in T: element (r, k) at p[r * ld + k]
// (rows: k contiguous) or at p[k * ld + r] (kmaj: a weight [K, N] read as B,
// or a transposed workspace).  With float products a float32 operand is
// read as it is (pick); with bf16 ones its copy in T, written by its
// producer (copy: where to write it, null for float).
template <class T, class BigC, class SmallC>
struct Enqueuer {
  using Type = T;
  static constexpr bool f32 = std::is_same<T, float>::value;

  cudaStream_t st;
  Rec* rec;
  const int* seed;  // on the device
  uint32_t thresh;
  float scale;
  int use_mask;
  cudaError_t err;

  // after each phase's launch
  void check(cudaError_t e) {
    if (err == cudaSuccess && e != cudaSuccess) err = e;
  }
  // true in a dry run, which records the launch in place of enqueueing it
  bool dry(dim3 grid, size_t smem) {
    if (rec) rec->add(grid, (int)smem);
    return rec != nullptr;
  }
  static tg::Operand op(const void* p, long long ld, bool kc) {
    const bool aligned = reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % (16 / sizeof(T)) == 0;
    return tg::Operand{p, ld, kc ? 1 : 0, aligned ? 1 : 0};
  }
  static tg::Operand rows(const void* p, long long ld) { return op(p, ld, true); }
  static tg::Operand kmaj(const void* p, long long ld) { return op(p, ld, false); }
  static const void* pick(const float* f, const void* c) {
    return f32 ? static_cast<const void*>(f) : c;
  }
  static void* copy(void* c) { return f32 ? nullptr : c; }
  tg::Epi epi(int op_, float* out) const {
    tg::Epi e{};
    e.op = op_;
    e.out = out;
    e.rdiv = 1;
    e.seed = seed;
    e.thresh = thresh;
    e.scale = scale;
    e.mask_on = use_mask;
    return e;
  }
  template <class C>
  void gemm(const tg::Problem& pr) {
    dim3 grid;
    int smem;
    tg::shape<C>(pr, &grid, &smem);
    if (!dry(grid, smem)) check(tg::launch<T, C>(pr, st));
  }
  // the [B*S, *] products and the split weight grads (kchunk: K a chunk)
  void big(tg::Operand a, tg::Operand b, int m, int n, int k, tg::Epi e, int kchunk = 0) {
    gemm<BigC>(tg::Problem{a, b, m, n, k, kchunk ? kchunk : k, e});
  }
  // the [B, *] products
  void small(tg::Operand a, tg::Operand b, int m, int n, int k, tg::Epi e) {
    gemm<SmallC>(tg::Problem{a, b, m, n, k, k, e});
  }
};

// q_d = q qmask and feats_d = feats fmask, in T (every reader is a
// product), and h in T where hb is set
template <class T>
__global__ void prep_kernel(size_t nq, size_t nf, size_t nh, const int* seed, int hop,
                            Dropout dr, const T* __restrict__ q, const T* __restrict__ feats,
                            const float* __restrict__ h, T* __restrict__ qd,
                            T* __restrict__ fd, T* __restrict__ hb) {
  dr.seed = (uint32_t)seed[0];
  const maskgen::Site qm = dr.site(hop, maskgen::SITE_Q);
  const maskgen::Site fm = dr.site(hop, maskgen::SITE_FEATS);
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < nq + nf + nh;
       i += stride) {
    if (i < nq) {
      stf(qd, i, qm.apply(ldf(q, i), (uint32_t)i));
    } else if (i < nq + nf) {
      const size_t j = i - nq;
      stf(fd, j, fm.apply(ldf(feats, j), (uint32_t)j));
    } else {
      stf(hb, i - nq - nf, h[i - nq - nf]);
    }
  }
}

// One row b a CTA: the attention score ((addfeat w_score + b_score) + h
// Wmem) + b_mem, the softmax over S into sc, and the pooling sum_s ifeat p_s
// (unrounded) into pool.
template <class T>
__global__ void __launch_bounds__(NT) rows_fwd_kernel(
    int S, int M, int F, const float* __restrict__ ifeat, const float* __restrict__ addfeat,
    const float* __restrict__ msc, const T* __restrict__ ws, const T* __restrict__ bs,
    const T* __restrict__ bmem, float* __restrict__ sc, T* __restrict__ scb,
    float* __restrict__ pool) {
  extern __shared__ __align__(16) float p[];  // [S]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, b = blockIdx.x;
  const float* af = addfeat + (size_t)b * S * F;
  const float* ifr = ifeat + (size_t)b * S * M;
  const float b_score = ldf(bs, 0);
  for (int cell = warp; cell < S; cell += NWARP) {
    const float* row = af + (size_t)cell * F;
    float acc = 0.f;
    for (int f = lane; f < F; f += 32) acc = fmaf(rnd<T>(row[f]), ldf(ws, f), acc);
    acc = warp_sum(acc);
    if (lane == 0) p[cell] = ((acc + b_score) + msc[(size_t)b * S + cell]) + ldf(bmem, cell);
  }
  __syncthreads();
  if (warp == 0) {
    float mx = __int_as_float(0xff800000);  // -inf
    for (int i = lane; i < S; i += 32) mx = fmaxf(mx, p[i]);
    mx = warp_max(mx);
    float den = 0.f;
    for (int i = lane; i < S; i += 32) {
      const float e = expf(p[i] - mx);
      p[i] = e;
      den += e;
    }
    den = warp_sum(den);
    for (int i = lane; i < S; i += 32) p[i] = p[i] / den;
  }
  __syncthreads();
  for (int i = tid; i < S; i += NT) {
    sc[(size_t)b * S + i] = p[i];
    if (scb) stf(scb, (size_t)b * S + i, p[i]);
  }
  for (int n = tid; n < M; n += NT) {
    float acc = 0.f;
    for (int i = 0; i < S; ++i) acc = fmaf(ifr[(size_t)i * M + n], p[i], acc);
    pool[(size_t)b * M + n] = acc;
  }
}

// The ATTLSTM cell, gate layout [i, g, f, o]: gates keep their activations;
// cn, hn the new carry (hn also in T where hnb is set).
template <class T>
__global__ void cell_kernel(int B, int R, const float* __restrict__ c, float* __restrict__ gates,
                            float* __restrict__ cn, float* __restrict__ hn, T* __restrict__ hnb) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * R) return;
  const int b = i / R, j = i - b * R;
  float* g = gates + (size_t)b * 4 * R;
  const float ig = sigm(g[j]);
  const float gt = tanhf(g[R + j]);
  const float fg = sigm(g[2 * R + j]);
  const float og = sigm(g[3 * R + j]);
  const float cc = fg * c[i] + ig * gt;
  cn[i] = cc;
  hn[i] = og * tanhf(cc);
  if (hnb) stf(hnb, i, og * tanhf(cc));
  g[j] = ig;
  g[R + j] = gt;
  g[2 * R + j] = fg;
  g[3 * R + j] = og;
}

// Where one hop's forward phases read and write, float32 unless in T.  The
// copies in T of a float32 operand (hb, xb, scb, hnb) are read by bf16
// products only, and unused with float ones.
template <class T>
struct HopBufs {
  const T* q;              // [B, Q]
  const T* feats;          // [B, S, Dc]
  const float *c, *h;      // the carry entering the hop, [B, R]
  T *qd, *fd, *hb;         // q_d [B, Q], feats_d [P, Dc], h [B, R]
  float *tmp;              // [B, max(M, 4R)]
  float *msc, *qfeat, *qatt, *pool, *join, *gates;
  float *ifeat, *addfeat;  // the workspace, [P, M] and [P, F]
  T* xb;                   // ifeat [P, M]
  float* sc;               // the softmax, [B, S]
  T* scb;
  float *cn, *hn;          // the carry leaving the hop
  T* hnb;
  T *qfeat_t, *join_t;     // qfeat and join in T, written by their epilogues
  T* merge_d;              // [B, M]
  // the backward's merge cotangent: gmerge [B, M] masked into dmerge (and
  // its copy in T); gmerge null in the forward
  const float* gmerge;
  float* dmerge;
  T* dmergeb;
};

// Enqueues one hop's forward phases (see the top of this file) with the
// enqueuer's tiles.
template <class E>
void hop_forward_phases(E& eq, const Dims& d, const Dropout& dr, const void* const* W, int hop,
                        const HopBufs<typename E::Type>& b) {
  using T = typename E::Type;
  constexpr int ew = NT;
  const int B = d.B, Q = d.Q, S = d.S, Dc = d.Dc, M = d.M, F = d.F, R = d.R;
  const int P = B * S;
  const tg::Operand h_op = E::rows(E::pick(b.h, b.hb), R);
  {
    const size_t nq = (size_t)B * Q, nf = (size_t)P * Dc, nh = E::f32 ? 0 : (size_t)B * R;
    const int blocks = (int)std::min<size_t>((nq + nf + nh + ew - 1) / ew, 4096);
    if (!eq.dry(blocks, 0)) {
      prep_kernel<T><<<blocks, ew, 0, eq.st>>>(nq, nf, nh, eq.seed, hop, dr, b.q, b.feats, b.h,
                                              b.qd, b.fd, b.hb);
      eq.check(cudaGetLastError());
    }
  }
  eq.small(E::rows(b.qd, Q), E::kmaj(W[Q_W], M), B, M, Q, eq.epi(tg::STORE, b.tmp));
  eq.small(h_op, E::kmaj(W[AM_W], S), B, S, R, eq.epi(tg::STORE, b.msc));
  {
    tg::Epi e = eq.epi(tg::QFEAT, b.qfeat);
    e.v0 = b.tmp;
    e.bias0 = W[Q_B];
    e.bias1 = W[H_B];
    e.emit = b.qfeat_t;
    eq.small(h_op, E::kmaj(W[H_W], M), B, M, R, e);
  }
  {
    tg::Epi e = eq.epi(tg::BIAS, b.qatt);
    e.bias0 = W[AQ_B];
    eq.small(E::rows(b.qfeat_t, M), E::kmaj(W[AQ_W], F), B, F, M, e);
  }
  {
    tg::Epi e = eq.epi(tg::TANH_BIAS, b.ifeat);
    e.bias0 = W[I_B];
    e.emit = E::copy(b.xb);
    eq.big(E::rows(b.fd, Dc), E::kmaj(W[I_W], M), P, M, Dc, e);
  }
  {
    tg::Epi e = eq.epi(tg::ADDFEAT, b.addfeat);
    e.bias0 = W[AI_B];
    e.v0 = b.qatt;
    e.rdiv = S;
    eq.big(E::rows(E::pick(b.ifeat, b.xb), M), E::kmaj(W[AI_W], F), P, F, M, e);
  }
  if (!eq.dry(B, S * sizeof(float))) {
    rows_fwd_kernel<T><<<B, NT, S * sizeof(float), eq.st>>>(
        S, M, F, b.ifeat, b.addfeat, b.msc, (const T*)W[AS_W], (const T*)W[AS_B],
        (const T*)W[AM_B], b.sc, (T*)E::copy(b.scb), b.pool);
    eq.check(cudaGetLastError());
  }
  {
    tg::Epi e = eq.epi(tg::JOIN, b.join);
    e.v0 = b.qfeat;
    e.v1 = b.pool;
    e.bias0 = W[AP_B];
    e.emit = b.join_t;
    eq.small(E::rows(E::pick(b.sc, b.scb), S), E::kmaj(W[AP_W], M), B, M, S, e);
  }
  eq.small(E::rows(b.join_t, M), E::kmaj(W[L_WI], 4 * R), B, 4 * R, M, eq.epi(tg::STORE, b.tmp));
  {
    tg::Epi e = eq.epi(tg::GATES, b.gates);
    e.v0 = b.tmp;
    e.bias0 = W[L_BI];
    e.bias1 = W[L_BH];
    eq.small(h_op, E::kmaj(W[L_WH], 4 * R), B, 4 * R, R, e);
  }
  if (!eq.dry((B * R + ew - 1) / ew, 0)) {
    cell_kernel<T><<<(B * R + ew - 1) / ew, ew, 0, eq.st>>>(B, R, b.c, b.gates, b.cn, b.hn,
                                                           (T*)E::copy(b.hnb));
    eq.check(cudaGetLastError());
  }
  {
    tg::Epi e = eq.epi(b.gmerge ? tg::MERGE : tg::MERGE_D, b.dmerge);
    e.v0 = b.join;
    e.v1 = b.gmerge;
    e.bias0 = W[MG_B];
    e.emit = E::copy(b.dmergeb);
    e.emit2 = b.merge_d;
    e.hop = hop;
    eq.small(E::rows(E::pick(b.hn, b.hnb), R), E::kmaj(W[MG_W], M), B, M, R, e);
  }
}

}  // namespace rth
