// The training hop loop's backward, for sm_90a.
//
// Replaces: rau_vqa_tpu/ops/rau_train_hops.py, _run_bwd (:471), whose Pallas
// body is _bwd_kernel (:411-468) with the per-hop math in _hop_fwd_core
// (:104-167, rematerialized) and _hop_bwd_core (:170-276).
//
// Computes, over the hops in reverse: the hop's forward again from the saved
// carries c_all / h_all and the same counter-hash masks; the (dc, dh)
// cotangent chain through merge, the ATTLSTM cell, join, the attention
// softmax, the content score and qfeat; the nine per-hop emissions of _EMITS
// (:76-80) for the weight-gradient products that run outside; and the
// feats-path weight gradients of _INKERNEL_GRADS (:72-73) -- i_embed w / b,
// att_i w / b, att_score w -- summed over the rows and the hops.  Two
// instantiations by the products' operand type T: float, and bf16, where q,
// feats and the weights arrive in bf16, each product rounds both operands to
// bf16 and sums in float32, and the emitted activations qfeat / join /
// merge_d are bf16; the workspace, the carries, the cotangents and the grads
// stay float32, and the pooling, sum_m ifeat djoin and the softmax read them
// unrounded.  A float32 value that a product reads is also written in bf16
// by the kernel that produces it (a copy in the scratch buffer), which the
// product reads: JAX's cast before its dot, done once.
//
// Design: as the Pallas kernel tiles the batch (its grid is (B / block_b,
// H), :517-519), each hop is a fixed sequence of phases, each one launch over
// the whole batch, enqueued on the caller's stream by one C entry (stream
// order is the only synchronisation; no grid barrier).  Every product is one
// tile GEMM (tile_gemm.cuh) over all rows: [B*S, *] products with 128 x 128
// tiles, [B, *] ones with small tiles, so each weight is read once a hop and
// not once a row.  The feats dropout mask and the bf16 rounding of feats_d
// are applied once a hop, into a feats_d buffer that both products that read
// it take as it is.  The [Dc, M] and [M, F] weight grads sum over B*S inside
// the GEMM's contraction: the rows split into fixed chunks, each CTA writes
// its chunk's partial tile, and one kernel a hop adds the chunks, in order,
// to the running grads (no atomics: two calls give the same bits).
//
// What bounds it on an H100: operations, ~290 GFLOP a step at B=100, H=8
// (the remat's ifeat and addfeat products, dpre_add Wa^T and the two weight
// grads, ~36 GFLOP a hop): ~4.3 ms at the 67 TFLOP/s float32 FMA peak, ~0.3
// ms at the 989 TFLOP/s bf16 tensor-core peak.  Those five products run on
// the 128 x 128 tiles at a few thousand CTAs each (one wave or more on 132
// SMs); the [B, *] products and the row kernels are latency-bound at B=100.
//
// Phases of one hop (h), in order; "G" is a tile GEMM, "P" the workspace's
// [B*S, *] rows:
//   prep      q_d = q qmask, feats_d = feats fmask, both in T
//   G qd      q_d Wq -> tmp;  G hmem  h Wmem -> msc;  G qfeat  h Wh (+ tmp, biases)
//   G qatt    qfeat Waq + baq
//   G ifeat   tanh(feats_d Wi + bi)                      P x M, K = Dc
//   G addfeat tanh((ifeat Wa + ba) + qatt[row])          P x F, K = M
//   rows_fwd  score, softmax, pooling                    one CTA a row
//   G join    p Wp (+ qfeat + pool, bp), emits join
//   G gates   join Wli -> tmp;  h Wlh (+ tmp, biases);  cell: c', h'
//   G merge   h' Wmg (+ join, bmg) masked, emits merge_d; dmerge = gmerge mmask
//   G dhn     dmerge Wmg^T + dh;  cell_bwd: dgates, dc
//   G djoin   dgates Wli^T + dmerge;  G dhp  dgates Wlh^T
//   G datt    djoin Wp^T -> tmp
//   softmax_bwd  dattprob, the softmax backward         one CTA a row
//   dpre_add  the att_score w partial, dpre_add in place of addfeat, dqatt =
//             sum_s dpre_add                            a CTA a row's 32 columns
//   G dhp    += dscore Wmem^T;  G dpre_q  (djoin + dqatt Waq^T)(1 - qfeat^2)
//   G dh      dhp + dpre_q Wh^T  (the carry into hop h - 1)
//   G att_i w ifeat^T dpre_add, split over P             M x F, K = P
//   G dpre_i  (p djoin + dpre_add Wa^T)(1 - ifeat^2) in place of ifeat
//   G i_emb w feats_d^T dpre_i, split over P             Dc x M, K = P
//   colsum    the i_embed b partials;  reduce  the hop's grads, in order

#include <algorithm>
#include <type_traits>

#include "rau_train_hops.cuh"
#include "tile_gemm.cuh"

namespace {

using rth::Dims;
using rth::Dropout;
using tg::Epi;
using tg::Operand;
using tg::Problem;

constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr int KSTEP = 32;  // chunk_rows must be a multiple of the bodies' k slices
constexpr int COLSUM_ROWS = 128;  // rows a partial of the i_embed b grad

// emissions in _EMITS order
enum { E_DPRE_Q, E_DQATT, E_DSCORE, E_DJOIN, E_DGATES, E_DMERGE, E_QFEAT, E_JOIN,
       E_MERGE, NEMITS };
// grads in _INKERNEL_GRADS order
enum { G_IW, G_IB, G_AIW, G_AIB, G_ASW, NGRADS };

// The scratch buffer: feats_d and q_d in T, the hop's [B, *] vectors, the
// split-K partials and, with bf16 products, the bf16 copies of the float32
// operands (empty for float).  Segments start on 256-byte boundaries.
struct Scratch {
  void *fd, *qd;
  float *tmp, *msc, *sc, *qfeat, *qatt, *pool, *join, *gates, *cn, *hn;
  float *dc, *dh, *dhn, *dhp, *aspart, *part6, *part8, *partb;
  void *hb, *scb, *hnb, *dmergeb, *dgatesb, *djoinb, *dscoreb, *dqattb, *dpreqb, *xb, *ab;

  static float* take(float* base, size_t& off, size_t n) {
    float* p = base ? base + off : nullptr;
    off += (n + 63) & ~size_t(63);
    return p;
  }
  // returns the float count; base nullptr only counts
  static size_t carve(float* base, const Dims& d, int t_bytes, int chunks, Scratch* s) {
    const size_t B = d.B, P = (size_t)d.B * d.S, M = d.M, F = d.F, R = d.R, S = d.S;
    size_t off = 0;
    s->fd = take(base, off, (P * d.Dc * t_bytes + 3) / 4);
    s->qd = take(base, off, (B * d.Q * t_bytes + 3) / 4);
    const size_t wide = 4 * R > M ? (4 * R > S ? 4 * R : S) : (M > S ? M : S);
    s->tmp = take(base, off, B * wide);
    s->msc = take(base, off, B * S);
    s->sc = take(base, off, B * S);
    s->qfeat = take(base, off, B * M);
    s->qatt = take(base, off, B * F);
    s->pool = take(base, off, B * M);
    s->join = take(base, off, B * M);
    s->gates = take(base, off, B * 4 * R);
    s->cn = take(base, off, B * R);
    s->hn = take(base, off, B * R);
    s->dc = take(base, off, B * R);
    s->dh = take(base, off, B * R);
    s->dhn = take(base, off, B * R);
    s->dhp = take(base, off, B * R);
    s->aspart = take(base, off, B * F);
    s->part6 = take(base, off, (size_t)chunks * M * F);
    s->part8 = take(base, off, (size_t)chunks * d.Dc * M);
    s->partb = take(base, off, (P + COLSUM_ROWS - 1) / COLSUM_ROWS * M);
    // the copies in T of a float32 operand: none when T is float
    auto copy = [&](size_t n) { return take(base, off, t_bytes == 4 ? 0 : (n * t_bytes + 3) / 4); };
    s->hb = copy(B * R);
    s->scb = copy(B * S);
    s->hnb = copy(B * R);
    s->dmergeb = copy(B * M);
    s->dgatesb = copy(B * 4 * R);
    s->djoinb = copy(B * M);
    s->dscoreb = copy(B * S);
    s->dqattb = copy(B * F);
    s->dpreqb = copy(B * M);
    s->xb = copy(P * M);
    s->ab = copy(P * F);
    return off;
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
      rth::stf(qd, i, qm.apply(rth::ldf(q, i), (uint32_t)i));
    } else if (i < nq + nf) {
      const size_t j = i - nq;
      rth::stf(fd, j, fm.apply(rth::ldf(feats, j), (uint32_t)j));
    } else {
      rth::stf(hb, i - nq - nf, h[i - nq - nf]);
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
  const float b_score = rth::ldf(bs, 0);
  for (int cell = warp; cell < S; cell += NWARP) {
    const float* row = af + (size_t)cell * F;
    float acc = 0.f;
    for (int f = lane; f < F; f += 32) acc = fmaf(rth::rnd<T>(row[f]), rth::ldf(ws, f), acc);
    acc = rth::warp_sum(acc);
    if (lane == 0)
      p[cell] = ((acc + b_score) + msc[(size_t)b * S + cell]) + rth::ldf(bmem, cell);
  }
  __syncthreads();
  if (warp == 0) {
    float mx = __int_as_float(0xff800000);  // -inf
    for (int i = lane; i < S; i += 32) mx = fmaxf(mx, p[i]);
    mx = rth::warp_max(mx);
    float den = 0.f;
    for (int i = lane; i < S; i += 32) {
      const float e = expf(p[i] - mx);
      p[i] = e;
      den += e;
    }
    den = rth::warp_sum(den);
    for (int i = lane; i < S; i += 32) p[i] = p[i] / den;
  }
  __syncthreads();
  for (int i = tid; i < S; i += NT) {
    sc[(size_t)b * S + i] = p[i];
    if (scb) rth::stf(scb, (size_t)b * S + i, p[i]);
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
  const float ig = rth::sigm(g[j]);
  const float gt = tanhf(g[R + j]);
  const float fg = rth::sigm(g[2 * R + j]);
  const float og = rth::sigm(g[3 * R + j]);
  const float cc = fg * c[i] + ig * gt;
  cn[i] = cc;
  hn[i] = og * tanhf(cc);
  if (hnb) rth::stf(hnb, i, og * tanhf(cc));
  g[j] = ig;
  g[R + j] = gt;
  g[2 * R + j] = fg;
  g[3 * R + j] = og;
}

// The cell's backward: dgates (also in T where dgb is set) from dh_new and
// the carried dc; dc becomes the carry into the previous hop.
template <class T>
__global__ void cell_bwd_kernel(int B, int R, const float* __restrict__ c,
                                const float* __restrict__ gates, const float* __restrict__ cn,
                                const float* __restrict__ dhn, float* __restrict__ dc,
                                float* __restrict__ dgates, T* __restrict__ dgb) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * R) return;
  const int b = i / R, j = i - b * R;
  const float* g = gates + (size_t)b * 4 * R;
  float* dg = dgates + (size_t)b * 4 * R;
  const float ig = g[j], gt = g[R + j], fg = g[2 * R + j], og = g[3 * R + j];
  const float tc = tanhf(cn[i]);
  const float dh = dhn[i];
  const float dgo = dh * tc;
  const float dcn = dh * og * (1.0f - tc * tc) + dc[i];
  const float dgf = dcn * c[i];
  dc[i] = dcn * fg;
  const float dgi = dcn * gt;
  const float dgg = dcn * ig;
  const float v[4] = {dgi * ig * (1.0f - ig), dgg * (1.0f - gt * gt), dgf * fg * (1.0f - fg),
                      dgo * og * (1.0f - og)};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    dg[q * R + j] = v[q];
    if (dgb) rth::stf(dgb, (size_t)b * 4 * R + q * R + j, v[q]);
  }
}

// One row b a CTA: dattprob = (djoin Wp^T, in datt) + sum_m ifeat djoin
// (unrounded), then the softmax backward into dscore (and its copy in T
// where dscoreb is set).
template <class T>
__global__ void __launch_bounds__(NT) softmax_bwd_kernel(
    int S, int M, const float* __restrict__ ifeat, const float* __restrict__ sc,
    const float* __restrict__ djoin, const float* __restrict__ datt,
    float* __restrict__ dscore, T* __restrict__ dscoreb) {
  extern __shared__ __align__(16) float sm[];
  float* dj = sm;            // [M]
  float* ds = sm + M;        // [S]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, b = blockIdx.x;
  const float* ifr = ifeat + (size_t)b * S * M;
  const float* p = sc + (size_t)b * S;
  for (int n = tid; n < M; n += NT) dj[n] = djoin[(size_t)b * M + n];
  __syncthreads();
  for (int i = warp; i < S; i += NWARP) {
    const float* row = ifr + (size_t)i * M;
    float acc = 0.f;
    for (int m = lane; m < M; m += 32) acc = fmaf(row[m], dj[m], acc);
    acc = rth::warp_sum(acc);
    if (lane == 0) ds[i] = datt[(size_t)b * S + i] + acc;
  }
  __syncthreads();
  if (warp == 0) {
    float dot = 0.f;
    for (int i = lane; i < S; i += 32) dot += ds[i] * p[i];
    dot = rth::warp_sum(dot);
    for (int i = lane; i < S; i += 32) ds[i] = p[i] * (ds[i] - dot);
  }
  __syncthreads();
  for (int i = tid; i < S; i += NT) {
    dscore[(size_t)b * S + i] = ds[i];
    if (dscoreb) rth::stf(dscoreb, (size_t)b * S + i, ds[i]);
  }
}

constexpr int DF = 32;       // columns a CTA of dpre_add_kernel
constexpr int DG = NT / DF;  // its row groups

// Row b, columns [32 blockIdx.y, +32) a CTA, the S cells split over 8 row
// groups: this row's att_score w partial sum_s addfeat dscore (both rounded
// to T), dpre_add = dscore w_score (1 - addfeat^2) in place of addfeat (and
// in T where ab is set), and dqatt = sum_s dpre_add; each group's sums are
// added in group order.
template <class T>
__global__ void __launch_bounds__(NT) dpre_add_kernel(
    int S, int F, float* __restrict__ addfeat, const float* __restrict__ dscore,
    const T* __restrict__ ws, float* __restrict__ aspart, float* __restrict__ dqatt,
    T* __restrict__ dqattb, T* __restrict__ ab) {
  __shared__ float red[2][DG][DF];
  const int b = blockIdx.x, c = threadIdx.x % DF, g = threadIdx.x / DF;
  const int f = blockIdx.y * DF + c;
  float as = 0.f, dq = 0.f;
  if (f < F) {
    const float w = rth::ldf(ws, f);
    float* af = addfeat + (size_t)b * S * F + f;
    const float* ds = dscore + (size_t)b * S;
    for (int i = g; i < S; i += DG) {
      const float a = af[(size_t)i * F], d_s = ds[i];
      as = fmaf(rth::rnd<T>(a), rth::rnd<T>(d_s), as);
      const float d = (d_s * w) * (1.0f - a * a);
      af[(size_t)i * F] = d;
      if (ab) rth::stf(ab, ((size_t)b * S + i) * F + f, d);
      dq += d;
    }
  }
  red[0][g][c] = as;
  red[1][g][c] = dq;
  __syncthreads();
  if (g == 0 && f < F) {
    for (int k = 1; k < DG; ++k) {
      as += red[0][k][c];
      dq += red[1][k][c];
    }
    aspart[(size_t)b * F + f] = as;
    dqatt[(size_t)b * F + f] = dq;
    if (dqattb) rth::stf(dqattb, (size_t)b * F + f, dq);
  }
}

// part[z, n] = sum over rows [z COLSUM_ROWS, (z + 1) COLSUM_ROWS) of x[row, n],
// ascending rows
__global__ void colsum_kernel(int P, int N, const float* __restrict__ x,
                              float* __restrict__ part) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int z = blockIdx.y;
  const int r1 = min(P, (z + 1) * COLSUM_ROWS);
  float acc = 0.f;
#pragma unroll 8
  for (int r = z * COLSUM_ROWS; r < r1; ++r) acc += x[(size_t)r * N + n];
  part[(size_t)z * N + n] = acc;
}

// The hop's feats-path grads into the running sums: each grad element adds
// its chunks' (or rows') partials in ascending order, then adds that to the
// sum over the hops already processed.
struct ReduceArgs {
  float* g[NGRADS];
  const float* part[NGRADS];
  int size[NGRADS];   // elements of the grad
  int parts[NGRADS];  // partials to add
};
__global__ void reduce_kernel(ReduceArgs a) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  for (int k = 0; k < NGRADS; ++k) {
    if (i < a.size[k]) {
      const float* p = a.part[k] + i;
      float s = 0.f;
      for (int z = 0; z < a.parts[k]; ++z) s += p[(size_t)z * a.size[k]];
      a.g[k][i] += s;
      return;
    }
    i -= a.size[k];
  }
}

int chunks_for(int P, int chunk_rows) { return (P + chunk_rows - 1) / chunk_rows; }

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

// Enqueues every phase of the H hops on the stream; with rec set, enqueues
// nothing and records each launch instead (the pointers are then unread).
template <class T>
int bwd_launch(const void* q, const void* feats, const void* seed_p, const void* c_all,
               const void* h_all, const void* gmerge, const void* const* weights,
               void* work, void* const* emits, void* const* grads, void* scratch, int B,
               int Q, int S, int Dc, int M, int F, int R, int H, int chunk_rows,
               long long scratch_floats, uint32_t thresh, float scale, int use_mask,
               void* stream, Rec* rec = nullptr) {
  if (B <= 0 || H <= 0 || S <= 0 || Dc <= 0 || M <= 0 || F <= 0 || R <= 0 || Q <= 0)
    return (int)cudaErrorInvalidValue;
  const int P = B * S;
  if (chunk_rows <= 0 || chunk_rows % KSTEP) return (int)cudaErrorInvalidValue;
  const int chunks = chunks_for(P, chunk_rows);
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  const Dims d{B, Q, S, Dc, M, F, R, 0, H};
  Scratch sc;
  if ((long long)Scratch::carve(nullptr, d, sizeof(T), chunks, &sc) > scratch_floats)
    return (int)cudaErrorInvalidValue;
  Scratch::carve(static_cast<float*>(scratch), d, sizeof(T), chunks, &sc);
  const cudaStream_t st = (cudaStream_t)stream;
  const int* seed = static_cast<const int*>(seed_p);
  const Dropout dr{0u, thresh, scale, use_mask != 0};
  auto W = [&](int i) { return weights[i]; };  // in T
  float* ifeat = static_cast<float*>(work);
  float* addfeat = ifeat + (size_t)P * M;
  float* g[NGRADS];
  for (int k = 0; k < NGRADS; ++k) g[k] = static_cast<float*>(grads[k]);
  const int gsize[NGRADS] = {Dc * M, M, M * F, F, F};
  cudaError_t err = cudaSuccess;
  for (int k = 0; k < NGRADS && err == cudaSuccess && !rec; ++k)
    err = cudaMemsetAsync(g[k], 0, gsize[k] * 4, st);
  if (err == cudaSuccess && !rec) err = cudaMemsetAsync(sc.dc, 0, (size_t)B * R * 4, st);
  if (err == cudaSuccess && !rec) err = cudaMemsetAsync(sc.dh, 0, (size_t)B * R * 4, st);
  // after each phase's launch (one a phase of bwd_plan)
  auto check = [&](cudaError_t e) {
    if (err == cudaSuccess && e != cudaSuccess) err = e;
  };
  // true in a dry run, which records the launch in place of enqueueing it
  auto dry = [&](dim3 grid, size_t smem) {
    if (rec) rec->add(grid, (int)smem);
    return rec != nullptr;
  };

  // Operands, all in T: element (r, k) at p[r * ld + k] (rows of length ld,
  // k contiguous) or at p[k * ld + r] (k-major: a weight [K, N] read as B,
  // or a transposed workspace).  With float products a float32 operand is
  // read as it is; with bf16 ones its copy in T (c), written by its producer.
  constexpr bool f32 = std::is_same<T, float>::value;
  auto op = [](const void* p, long long ld, bool kc) {
    const bool aligned = reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % (16 / sizeof(T)) == 0;
    return Operand{p, ld, kc ? 1 : 0, aligned ? 1 : 0};
  };
  auto rows = [&](const void* p, long long ld) { return op(p, ld, true); };
  auto kmaj = [&](const void* p, long long ld) { return op(p, ld, false); };
  auto pick = [&](const float* f, void* c) { return f32 ? static_cast<const void*>(f) : c; };
  auto copy = [&](void* c) { return f32 ? nullptr : c; };  // where to write a copy
  auto epi = [&](int op_, float* out) {
    Epi e{};
    e.op = op_;
    e.out = out;
    e.rdiv = 1;
    e.seed = seed;
    e.thresh = thresh;
    e.scale = scale;
    e.mask_on = use_mask;
    return e;
  };
  using Big = typename std::conditional<f32, tg::FmaBig, tg::MmaBig>::type;
  using Small = typename std::conditional<f32, tg::FmaSmall, tg::MmaSmall>::type;
  auto gemm = [&](auto tile, const Problem& pr) {
    using C = decltype(tile);
    dim3 grid;
    int smem;
    tg::shape<T, C>(pr, &grid, &smem);
    if (!dry(grid, smem)) check(tg::launch<T, C>(pr, st));
  };
  auto big = [&](Operand a, Operand b, int m, int n, int k, Epi e, int kchunk = 0) {
    gemm(Big{}, Problem{a, b, m, n, k, kchunk ? kchunk : k, e});
  };
  auto small = [&](Operand a, Operand b, int m, int n, int k, Epi e) {
    gemm(Small{}, Problem{a, b, m, n, k, k, e});
  };
  auto em = [&](int i, int hop, int width) {
    return static_cast<char*>(emits[i]) +
           (size_t)hop * B * width * (i >= E_QFEAT ? sizeof(T) : sizeof(float));
  };
  const int ew = 256;  // threads a CTA of the elementwise kernels

  for (int hop = H - 1; hop >= 0; --hop) {
    const float* c = static_cast<const float*>(c_all) + (size_t)hop * B * R;
    const float* h = static_cast<const float*>(h_all) + (size_t)hop * B * R;
    float* dmerge = reinterpret_cast<float*>(em(E_DMERGE, hop, M));
    float* dgates = reinterpret_cast<float*>(em(E_DGATES, hop, 4 * R));
    float* djoin = reinterpret_cast<float*>(em(E_DJOIN, hop, M));
    float* dscore = reinterpret_cast<float*>(em(E_DSCORE, hop, S));
    float* dqatt = reinterpret_cast<float*>(em(E_DQATT, hop, F));
    float* dpre_q = reinterpret_cast<float*>(em(E_DPRE_Q, hop, M));
    const void* qfeat_t = em(E_QFEAT, hop, M);  // the emissions in T
    const void* join_t = em(E_JOIN, hop, M);
    const Operand h_op = rows(pick(h, sc.hb), R);

    // the remat
    {
      const size_t nq = (size_t)B * Q, nf = (size_t)P * Dc, nh = f32 ? 0 : (size_t)B * R;
      const int blocks = (int)std::min<size_t>((nq + nf + nh + ew - 1) / ew, 4096);
      if (!dry(blocks, 0)) {
        prep_kernel<T><<<blocks, ew, 0, st>>>(nq, nf, nh, seed, hop, dr, (const T*)q,
                                               (const T*)feats, h, (T*)sc.qd, (T*)sc.fd,
                                               (T*)sc.hb);
        check(cudaGetLastError());
      }
    }
    small(rows(sc.qd, Q), kmaj(W(rth::Q_W), M), B, M, Q, epi(tg::STORE, sc.tmp));
    small(h_op, kmaj(W(rth::AM_W), S), B, S, R, epi(tg::STORE, sc.msc));
    {
      Epi e = epi(tg::QFEAT, sc.qfeat);
      e.v0 = sc.tmp;
      e.bias0 = W(rth::Q_B);
      e.bias1 = W(rth::H_B);
      e.emit = em(E_QFEAT, hop, M);
      small(h_op, kmaj(W(rth::H_W), M), B, M, R, e);
    }
    {
      Epi e = epi(tg::BIAS, sc.qatt);
      e.bias0 = W(rth::AQ_B);
      small(rows(qfeat_t, M), kmaj(W(rth::AQ_W), F), B, F, M, e);
    }
    {
      Epi e = epi(tg::TANH_BIAS, ifeat);
      e.bias0 = W(rth::I_B);
      e.emit = copy(sc.xb);
      big(rows(sc.fd, Dc), kmaj(W(rth::I_W), M), P, M, Dc, e);
    }
    {
      Epi e = epi(tg::ADDFEAT, addfeat);
      e.bias0 = W(rth::AI_B);
      e.v0 = sc.qatt;
      e.rdiv = S;
      big(rows(pick(ifeat, sc.xb), M), kmaj(W(rth::AI_W), F), P, F, M, e);
    }
    if (!dry(B, S * sizeof(float))) {
      rows_fwd_kernel<T><<<B, NT, S * sizeof(float), st>>>(
          S, M, F, ifeat, addfeat, sc.msc, (const T*)W(rth::AS_W), (const T*)W(rth::AS_B),
          (const T*)W(rth::AM_B), sc.sc, (T*)copy(sc.scb), sc.pool);
      check(cudaGetLastError());
    }
    {
      Epi e = epi(tg::JOIN, sc.join);
      e.v0 = sc.qfeat;
      e.v1 = sc.pool;
      e.bias0 = W(rth::AP_B);
      e.emit = em(E_JOIN, hop, M);
      small(rows(pick(sc.sc, sc.scb), S), kmaj(W(rth::AP_W), M), B, M, S, e);
    }
    small(rows(join_t, M), kmaj(W(rth::L_WI), 4 * R), B, 4 * R, M, epi(tg::STORE, sc.tmp));
    {
      Epi e = epi(tg::GATES, sc.gates);
      e.v0 = sc.tmp;
      e.bias0 = W(rth::L_BI);
      e.bias1 = W(rth::L_BH);
      small(h_op, kmaj(W(rth::L_WH), 4 * R), B, 4 * R, R, e);
    }
    if (!dry((B * R + ew - 1) / ew, 0)) {
      cell_kernel<T><<<(B * R + ew - 1) / ew, ew, 0, st>>>(B, R, c, sc.gates, sc.cn, sc.hn,
                                                           (T*)copy(sc.hnb));
      check(cudaGetLastError());
    }
    {
      Epi e = epi(tg::MERGE, dmerge);
      e.v0 = sc.join;
      e.v1 = static_cast<const float*>(gmerge) + (size_t)hop * B * M;
      e.bias0 = W(rth::MG_B);
      e.emit = copy(sc.dmergeb);
      e.emit2 = em(E_MERGE, hop, M);
      e.hop = hop;
      small(rows(pick(sc.hn, sc.hnb), R), kmaj(W(rth::MG_W), M), B, M, R, e);
    }

    // the cotangent chain
    {
      Epi e = epi(tg::ADD, sc.dhn);
      e.v0 = sc.dh;
      small(rows(pick(dmerge, sc.dmergeb), M), rows(W(rth::MG_W), M), B, R, M, e);
    }
    if (!dry((B * R + ew - 1) / ew, 0)) {
      cell_bwd_kernel<T><<<(B * R + ew - 1) / ew, ew, 0, st>>>(
          B, R, c, sc.gates, sc.cn, sc.dhn, sc.dc, dgates, (T*)copy(sc.dgatesb));
      check(cudaGetLastError());
    }
    const Operand dgates_op = rows(pick(dgates, sc.dgatesb), 4 * R);
    {
      Epi e = epi(tg::ADD, djoin);
      e.v0 = dmerge;
      e.emit = copy(sc.djoinb);
      small(dgates_op, rows(W(rth::L_WI), 4 * R), B, M, 4 * R, e);
    }
    small(dgates_op, rows(W(rth::L_WH), 4 * R), B, R, 4 * R, epi(tg::STORE, sc.dhp));
    small(rows(pick(djoin, sc.djoinb), M), rows(W(rth::AP_W), M), B, S, M,
          epi(tg::STORE, sc.tmp));
    if (!dry(B, (M + S) * sizeof(float))) {
      softmax_bwd_kernel<T><<<B, NT, (M + S) * sizeof(float), st>>>(
          S, M, ifeat, sc.sc, djoin, sc.tmp, dscore, (T*)copy(sc.dscoreb));
      check(cudaGetLastError());
    }
    if (!dry(dim3(B, (F + DF - 1) / DF), 0)) {
      dpre_add_kernel<T><<<dim3(B, (F + DF - 1) / DF), NT, 0, st>>>(
          S, F, addfeat, dscore, (const T*)W(rth::AS_W), sc.aspart, dqatt,
          (T*)copy(sc.dqattb), (T*)copy(sc.ab));
      check(cudaGetLastError());
    }
    const float* dpre_add = addfeat;
    {
      Epi e = epi(tg::ADD, sc.dhp);
      e.v0 = sc.dhp;
      small(rows(pick(dscore, sc.dscoreb), S), rows(W(rth::AM_W), S), B, R, S, e);
    }
    {
      Epi e = epi(tg::DPREQ, dpre_q);
      e.v0 = djoin;
      e.v1 = sc.qfeat;
      e.emit = copy(sc.dpreqb);
      small(rows(pick(dqatt, sc.dqattb), F), rows(W(rth::AQ_W), F), B, M, F, e);
    }
    {
      Epi e = epi(tg::ADD, sc.dh);
      e.v0 = sc.dhp;
      small(rows(pick(dpre_q, sc.dpreqb), M), rows(W(rth::H_W), M), B, R, M, e);
    }
    // att_i w grad partials: ifeat^T dpre_add  [M, P] x [P, F]
    big(kmaj(pick(ifeat, sc.xb), M), kmaj(pick(dpre_add, sc.ab), F), M, F, P,
        epi(tg::STORE, sc.part6), chunk_rows);
    // dpre_i in place of ifeat
    {
      Epi e = epi(tg::DPREI, ifeat);
      e.v0 = sc.sc;
      e.v1 = djoin;
      e.rdiv = S;
      e.emit = copy(sc.xb);
      big(rows(pick(dpre_add, sc.ab), F), rows(W(rth::AI_W), F), P, M, F, e);
    }
    const float* dpre_i = ifeat;
    // i_embed w grad partials: feats_d^T dpre_i  [Dc, P] x [P, M]
    big(kmaj(sc.fd, Dc), kmaj(pick(dpre_i, sc.xb), M), Dc, M, P, epi(tg::STORE, sc.part8),
        chunk_rows);
    const int colsums = (P + COLSUM_ROWS - 1) / COLSUM_ROWS;
    if (!dry(dim3((M + ew - 1) / ew, colsums), 0)) {
      colsum_kernel<<<dim3((M + ew - 1) / ew, colsums), ew, 0, st>>>(P, M, dpre_i, sc.partb);
      check(cudaGetLastError());
    }
    ReduceArgs ra;
    const float* parts[NGRADS] = {sc.part8, sc.partb, sc.part6, dqatt, sc.aspart};
    const int nparts[NGRADS] = {chunks, colsums, chunks, B, B};
    int total = 0;
    for (int k = 0; k < NGRADS; ++k) {
      ra.g[k] = g[k];
      ra.part[k] = parts[k];
      ra.size[k] = gsize[k];
      ra.parts[k] = nparts[k];
      total += gsize[k];
    }
    if (!dry((total + ew - 1) / ew, 0)) {
      reduce_kernel<<<(total + ew - 1) / ew, ew, 0, st>>>(ra);
      check(cudaGetLastError());
    }
  }
  return (int)err;
}

}  // namespace

// q [B, Q], feats [B, S, Dc], c_all / h_all [H+1, B, R], gmerge [H, B, M]
// (the score cotangent times cls_w^T, float32); seed: one int32 on the
// device; weights: 26 pointers in _FWD_WEIGHTS order (cls and do_pred
// unread); q, feats and the weights float32 (the first entry) or bf16 (the
// second); work: B * S * (M + F) floats; emits: 9 pointers in _EMITS order,
// [H, B, width], float32 but for qfeat / join / merge_d in the weights'
// type; grads, float32, written: i_embed w [Dc, M], i_embed b [M], att_i w
// [M, F], att_i b [F], att_score w [F, 1]; scratch: scratch_floats floats,
// at least train_hops_bwd_describe(...)'s count; chunk_rows: rows of B * S a
// chunk of the split-K weight grads, a positive multiple of 32.  Enqueues
// every phase on the stream and returns the first error, cudaSuccess (0) if
// none; cudaErrorInvalidValue for a plan it cannot run.
#define TRAIN_HOPS_BWD_ENTRY(NAME, T)                                                   \
  extern "C" int NAME(const void* q, const void* feats, const void* seed,              \
                      const void* c_all, const void* h_all, const void* gmerge,        \
                      const void* const* weights, void* work, void* const* emits,      \
                      void* const* grads, void* scratch, int B, int Q, int S, int Dc,  \
                      int M, int F, int R, int H, int chunk_rows,                      \
                      long long scratch_floats, uint32_t thresh, float scale,          \
                      int use_mask, void* stream) {                                    \
    return bwd_launch<T>(q, feats, seed, c_all, h_all, gmerge, weights, work, emits,   \
                         grads, scratch, B, Q, S, Dc, M, F, R, H, chunk_rows,          \
                         scratch_floats, thresh, scale, use_mask, stream);             \
  }
TRAIN_HOPS_BWD_ENTRY(train_hops_bwd_launch, float)
TRAIN_HOPS_BWD_ENTRY(train_hops_bwd_bf16_launch, __nv_bfloat16)

// The launcher's own account of one hop at these shapes, operands of t_bytes
// bytes (4: float, 2: bf16) and chunk_rows: a dry run of the entries above
// (nothing is enqueued) writes each launch's grid x, y, z and dynamic shared
// memory bytes, in order, to launches (4 ints a launch, at most cap of them)
// and their count to n_launches.  Returns the scratch floats it carves, -1
// if it cannot run these shapes.
extern "C" int train_hops_bwd_describe(int B, int Q, int S, int Dc, int M, int F, int R,
                                       int t_bytes, int chunk_rows, int* launches, int cap,
                                       int* n_launches) {
  *n_launches = 0;
  if (B <= 0 || S <= 0 || chunk_rows <= 0 || chunk_rows % KSTEP || (t_bytes != 4 && t_bytes != 2))
    return -1;
  const Dims d{B, Q, S, Dc, M, F, R, 0, 1};
  Scratch s;
  const size_t n = Scratch::carve(nullptr, d, t_bytes, chunks_for(B * S, chunk_rows), &s);
  if (n >= 0x7fffffff) return -1;
  const void* weights[rth::NWEIGHTS] = {};
  void* emits[NEMITS] = {};
  void* grads[NGRADS] = {};
  Rec rec{launches, cap, 0};
  const int err =
      t_bytes == 4
          ? bwd_launch<float>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, weights,
                              nullptr, emits, grads, nullptr, B, Q, S, Dc, M, F, R, 1,
                              chunk_rows, (long long)n, 0u, 1.f, 0, nullptr, &rec)
          : bwd_launch<__nv_bfloat16>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                      weights, nullptr, emits, grads, nullptr, B, Q, S, Dc, M,
                                      F, R, 1, chunk_rows, (long long)n, 0u, 1.f, 0, nullptr,
                                      &rec);
  *n_launches = rec.n;
  return err == 0 ? (int)n : -1;
}
