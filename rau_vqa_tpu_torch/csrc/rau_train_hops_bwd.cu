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
// att_i w / b, att_score w -- summed over the rows and the hops; and, where
// the caller asks for it (the features are trained, as under backbone
// fine-tuning), the features' own gradient dfeats [B, S, Dc], float32,
// summed over the hops: each hop's fmask (dpre_i Wi^T).  The JAX package's
// Pallas backward returns zeros there (:649, :664); its plain autodiff on
// the CPU differentiates the features, and so does this.  Two
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
// [B*S, *] rows.  First the hop's forward, prep to merge, as the forward
// kernel runs it (rau_train_hops_phases.cuh), from the saved carries; its
// merge also forms dmerge = gmerge mmask.  Then the cotangent chain:
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
//   G dfeats  dfeats += fmask (dpre_i Wi^T), with dfeats only   P x Dc, K = M
//   G i_emb w feats_d^T dpre_i, split over P             Dc x M, K = P
//   colsum    the i_embed b partials;  reduce  the hop's grads, in order
// dfeats adds one product a hop, 2 P Dc M operations (~118 GFLOP a hop at
// B=288, S=196, Dc=2048, M=512) and a read and a write of the float32 sum;
// each element is one CTA's in every hop, added in hop order: no atomics,
// the same bits in every call.

#include "rau_train_hops_phases.cuh"

namespace {

using rth::Dims;
using rth::Dropout;
using rth::NT;
using rth::NWARP;
using rth::take;
using tg::Epi;
using tg::Operand;

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

// Enqueues every phase of the H hops on the stream; with rec set, enqueues
// nothing and records each launch instead (the pointers are then unread).
// want_dfeats: enqueue the features' gradient into dfeats (unread in a dry run)
template <class T>
int bwd_launch(const void* q, const void* feats, const void* seed_p, const void* c_all,
               const void* h_all, const void* gmerge, const void* const* weights,
               void* work, void* const* emits, void* const* grads, float* dfeats,
               bool want_dfeats, void* scratch, int B, int Q, int S, int Dc, int M, int F,
               int R, int H, int chunk_rows, long long scratch_floats, uint32_t thresh,
               float scale, int use_mask, int row0, void* stream, rth::Rec* rec = nullptr) {
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
  const Dropout dr{0u, thresh, scale, use_mask != 0, (uint32_t)row0};
  const void* const* W = weights;  // in T
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
  if (err == cudaSuccess && !rec && want_dfeats)
    err = cudaMemsetAsync(dfeats, 0, (size_t)P * Dc * 4, st);
  // one launch a phase of bwd_plan
  constexpr bool f32 = std::is_same<T, float>::value;
  using E = rth::Enqueuer<T, typename std::conditional<f32, tg::FmaBig, tg::MmaBig>::type,
                          typename std::conditional<f32, tg::FmaSmall, tg::MmaSmall>::type>;
  using DfC = typename std::conditional<f32, tg::FmaBigDf, tg::MmaBigDf>::type;
  E eq{st, rec, seed, thresh, scale, use_mask, err};
  auto em = [&](int i, int hop, int width) {
    return static_cast<char*>(emits[i]) +
           (size_t)hop * B * width * (i >= E_QFEAT ? sizeof(T) : sizeof(float));
  };
  const int ew = NT;  // threads a CTA of the elementwise kernels

  for (int hop = H - 1; hop >= 0; --hop) {
    const float* c = static_cast<const float*>(c_all) + (size_t)hop * B * R;
    const float* h = static_cast<const float*>(h_all) + (size_t)hop * B * R;
    float* dmerge = reinterpret_cast<float*>(em(E_DMERGE, hop, M));
    float* dgates = reinterpret_cast<float*>(em(E_DGATES, hop, 4 * R));
    float* djoin = reinterpret_cast<float*>(em(E_DJOIN, hop, M));
    float* dscore = reinterpret_cast<float*>(em(E_DSCORE, hop, S));
    float* dqatt = reinterpret_cast<float*>(em(E_DQATT, hop, F));
    float* dpre_q = reinterpret_cast<float*>(em(E_DPRE_Q, hop, M));

    // the remat: the forward's hop, with the emissions qfeat / join / merge_d
    // in T as its copies in T, and dmerge = gmerge mmask
    rth::HopBufs<T> fw{};
    fw.q = static_cast<const T*>(q);
    fw.feats = static_cast<const T*>(feats);
    fw.c = c;
    fw.h = h;
    fw.qd = static_cast<T*>(sc.qd);
    fw.fd = static_cast<T*>(sc.fd);
    fw.hb = static_cast<T*>(sc.hb);
    fw.tmp = sc.tmp;
    fw.msc = sc.msc;
    fw.qfeat = sc.qfeat;
    fw.qatt = sc.qatt;
    fw.pool = sc.pool;
    fw.join = sc.join;
    fw.gates = sc.gates;
    fw.ifeat = ifeat;
    fw.addfeat = addfeat;
    fw.xb = static_cast<T*>(sc.xb);
    fw.sc = sc.sc;
    fw.scb = static_cast<T*>(sc.scb);
    fw.cn = sc.cn;
    fw.hn = sc.hn;
    fw.hnb = static_cast<T*>(sc.hnb);
    fw.qfeat_t = reinterpret_cast<T*>(em(E_QFEAT, hop, M));
    fw.join_t = reinterpret_cast<T*>(em(E_JOIN, hop, M));
    fw.merge_d = reinterpret_cast<T*>(em(E_MERGE, hop, M));
    fw.gmerge = static_cast<const float*>(gmerge) + (size_t)hop * B * M;
    fw.dmerge = dmerge;
    fw.dmergeb = static_cast<T*>(sc.dmergeb);
    rth::hop_forward_phases(eq, d, dr, W, hop, fw);

    // the cotangent chain
    {
      Epi e = eq.epi(tg::ADD, sc.dhn);
      e.v0 = sc.dh;
      eq.small(E::rows(E::pick(dmerge, sc.dmergeb), M), E::rows(W[rth::MG_W], M), B, R, M, e);
    }
    if (!eq.dry((B * R + ew - 1) / ew, 0)) {
      cell_bwd_kernel<T><<<(B * R + ew - 1) / ew, ew, 0, eq.st>>>(
          B, R, c, sc.gates, sc.cn, sc.dhn, sc.dc, dgates, (T*)E::copy(sc.dgatesb));
      eq.check(cudaGetLastError());
    }
    const Operand dgates_op = E::rows(E::pick(dgates, sc.dgatesb), 4 * R);
    {
      Epi e = eq.epi(tg::ADD, djoin);
      e.v0 = dmerge;
      e.emit = E::copy(sc.djoinb);
      eq.small(dgates_op, E::rows(W[rth::L_WI], 4 * R), B, M, 4 * R, e);
    }
    eq.small(dgates_op, E::rows(W[rth::L_WH], 4 * R), B, R, 4 * R, eq.epi(tg::STORE, sc.dhp));
    eq.small(E::rows(E::pick(djoin, sc.djoinb), M), E::rows(W[rth::AP_W], M), B, S, M,
             eq.epi(tg::STORE, sc.tmp));
    if (!eq.dry(B, (M + S) * sizeof(float))) {
      softmax_bwd_kernel<T><<<B, NT, (M + S) * sizeof(float), eq.st>>>(
          S, M, ifeat, sc.sc, djoin, sc.tmp, dscore, (T*)E::copy(sc.dscoreb));
      eq.check(cudaGetLastError());
    }
    if (!eq.dry(dim3(B, (F + DF - 1) / DF), 0)) {
      dpre_add_kernel<T><<<dim3(B, (F + DF - 1) / DF), NT, 0, eq.st>>>(
          S, F, addfeat, dscore, (const T*)W[rth::AS_W], sc.aspart, dqatt,
          (T*)E::copy(sc.dqattb), (T*)E::copy(sc.ab));
      eq.check(cudaGetLastError());
    }
    const float* dpre_add = addfeat;
    {
      Epi e = eq.epi(tg::ADD, sc.dhp);
      e.v0 = sc.dhp;
      eq.small(E::rows(E::pick(dscore, sc.dscoreb), S), E::rows(W[rth::AM_W], S), B, R, S, e);
    }
    {
      Epi e = eq.epi(tg::DPREQ, dpre_q);
      e.v0 = djoin;
      e.v1 = sc.qfeat;
      e.emit = E::copy(sc.dpreqb);
      eq.small(E::rows(E::pick(dqatt, sc.dqattb), F), E::rows(W[rth::AQ_W], F), B, M, F, e);
    }
    {
      Epi e = eq.epi(tg::ADD, sc.dh);
      e.v0 = sc.dhp;
      eq.small(E::rows(E::pick(dpre_q, sc.dpreqb), M), E::rows(W[rth::H_W], M), B, R, M, e);
    }
    // att_i w grad partials: ifeat^T dpre_add  [M, P] x [P, F]
    eq.big(E::kmaj(E::pick(ifeat, sc.xb), M), E::kmaj(E::pick(dpre_add, sc.ab), F), M, F, P,
           eq.epi(tg::STORE, sc.part6), chunk_rows);
    // dpre_i in place of ifeat
    {
      Epi e = eq.epi(tg::DPREI, ifeat);
      e.v0 = sc.sc;
      e.v1 = djoin;
      e.rdiv = S;
      e.emit = E::copy(sc.xb);
      eq.big(E::rows(E::pick(dpre_add, sc.ab), F), E::rows(W[rth::AI_W], F), P, M, F, e);
    }
    const float* dpre_i = ifeat;
    // the features' gradient: dfeats += fmask (dpre_i Wi^T)  [P, M] x [M, Dc]
    if (want_dfeats) {
      Epi e = eq.epi(tg::DFEATS, dfeats);
      e.hop = hop;
      e.mask_base = dr.row0 * (uint32_t)(S * Dc);
      eq.template gemm<DfC>(tg::Problem{E::rows(E::pick(dpre_i, sc.xb), M),
                                        E::rows(W[rth::I_W], M), P, Dc, M, M, e});
    }
    // i_embed w grad partials: feats_d^T dpre_i  [Dc, P] x [P, M]
    eq.big(E::kmaj(sc.fd, Dc), E::kmaj(E::pick(dpre_i, sc.xb), M), Dc, M, P,
           eq.epi(tg::STORE, sc.part8), chunk_rows);
    const int colsums = (P + COLSUM_ROWS - 1) / COLSUM_ROWS;
    if (!eq.dry(dim3((M + ew - 1) / ew, colsums), 0)) {
      colsum_kernel<<<dim3((M + ew - 1) / ew, colsums), ew, 0, eq.st>>>(P, M, dpre_i, sc.partb);
      eq.check(cudaGetLastError());
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
    if (!eq.dry((total + ew - 1) / ew, 0)) {
      reduce_kernel<<<(total + ew - 1) / ew, ew, 0, eq.st>>>(ra);
      eq.check(cudaGetLastError());
    }
  }
  return (int)eq.err;
}

}  // namespace

// q [B, Q], feats [B, S, Dc], c_all / h_all [H+1, B, R], gmerge [H, B, M]
// (the score cotangent times cls_w^T, float32); seed: one int32 on the
// device; weights: 26 pointers in _FWD_WEIGHTS order (cls and do_pred
// unread); q, feats and the weights float32 (the first entry) or bf16 (the
// second); work: B * S * (M + F) floats; emits: 9 pointers in _EMITS order,
// [H, B, width], float32 but for qfeat / join / merge_d in the weights'
// type; grads, float32, written: i_embed w [Dc, M], i_embed b [M], att_i w
// [M, F], att_i b [F], att_score w [F, 1]; dfeats: null, or [B, S, Dc] float32,
// written with the features' gradient; scratch: scratch_floats floats,
// at least train_hops_bwd_describe(...)'s count; chunk_rows: rows of B * S a
// chunk of the split-K weight grads, a positive multiple of 32.  Enqueues
// every phase on the stream and returns the first error, cudaSuccess (0) if
// none; cudaErrorInvalidValue for a plan it cannot run.
#define TRAIN_HOPS_BWD_ENTRY(NAME, T)                                                   \
  extern "C" int NAME(const void* q, const void* feats, const void* seed,              \
                      const void* c_all, const void* h_all, const void* gmerge,        \
                      const void* const* weights, void* work, void* const* emits,      \
                      void* const* grads, void* dfeats, void* scratch, int B, int Q,   \
                      int S, int Dc, int M, int F, int R, int H, int chunk_rows,       \
                      long long scratch_floats, uint32_t thresh, float scale,          \
                      int use_mask, int row0, void* stream) {                          \
    return bwd_launch<T>(q, feats, seed, c_all, h_all, gmerge, weights, work, emits,   \
                         grads, static_cast<float*>(dfeats), dfeats != nullptr,        \
                         scratch, B, Q, S, Dc, M, F, R, H, chunk_rows, scratch_floats, \
                         thresh, scale, use_mask, row0, stream);                       \
  }
TRAIN_HOPS_BWD_ENTRY(train_hops_bwd_launch, float)
TRAIN_HOPS_BWD_ENTRY(train_hops_bwd_bf16_launch, __nv_bfloat16)

// The launcher's own account of one hop at these shapes, operands of t_bytes
// bytes (4: float, 2: bf16), chunk_rows and dfeats (1: with the features'
// gradient, 0: without): a dry run of the entries above
// (nothing is enqueued) writes each launch's grid x, y, z and dynamic shared
// memory bytes, in order, to launches (4 ints a launch, at most cap of them)
// and their count to n_launches.  Returns the scratch floats it carves, -1
// if it cannot run these shapes.
extern "C" int train_hops_bwd_describe(int B, int Q, int S, int Dc, int M, int F, int R,
                                       int t_bytes, int chunk_rows, int dfeats,
                                       int* launches, int cap, int* n_launches) {
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
  rth::Rec rec{launches, cap, 0};
  const int err =
      t_bytes == 4
          ? bwd_launch<float>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, weights,
                              nullptr, emits, grads, nullptr, dfeats != 0, nullptr, B, Q, S,
                              Dc, M, F, R, 1, chunk_rows, (long long)n, 0u, 1.f, 0, 0, nullptr,
                              &rec)
          : bwd_launch<__nv_bfloat16>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                      weights, nullptr, emits, grads, nullptr, dfeats != 0,
                                      nullptr, B, Q, S, Dc, M, F, R, 1, chunk_rows,
                                      (long long)n, 0u, 1.f, 0, 0, nullptr, &rec);
  *n_launches = rec.n;
  return err == 0 ? (int)n : -1;
}
