// The whole eval hop loop of the recurrent answering units, for sm_90a.
//
// Replaces: rau_vqa_tpu/ops/rau_hops.py, rau_hops_pallas (:152), whose Pallas
// body is _kernel (:122-148) with the per-hop math in _hop_body (:39-80).
//
// Computes, for H hops over the batch: qfeat = tanh(q Wq + bq + h Wh + bh);
// qatt; the content score sum_f tanh(iatt + qatt) w_score + b_score plus the
// memory score h W_mem + b_mem; softmax over S; attention pooling of ifeat;
// join; the ATTLSTM step (gates [i, g, f, o]); merge; the classifier and the
// do_pred sigmoid.  Dot operands are rounded to bf16 and summed in float32,
// as in _hop_body with dot_dtype=bf16; the softmax, the pooling, the biases
// and the state stay float32.
//
// Design: as the Pallas kernel tiles the batch, each hop is a fixed sequence
// of phases, each one launch over the whole batch, enqueued on the caller's
// stream by one C entry (stream order is the only synchronisation):
//   prep      zero c, h and h's bf16 copy; q to bf16          (once a call)
//   G q Wq    the question projection, the same every hop     (once a call)
//   G hmem    h Wmem -> msc                                   B x S, K = R
//   G qfeat   tanh(((qWq + bq) + h Wh) + bh), bf16 copy       B x M, K = R
//   G qatt    qfeat Waq + baq                                 B x F, K = M
//   rows_eval score, softmax into attprob[hop], pooling       one CTA a row
//   G join    ((qfeat + pool) + p Wp) + bp, bf16 copy         B x M, K = S
//   G gates   join Wli -> tmp;  ((tmp + bi) + h Wlh) + bh     B x 4R, K = M, R
//   cell      [i, g, f, o] -> c', h' (+ bf16 copy of h')
//   G merge   (join + h' Wmg) + bmg, in bf16                  B x M, K = R
//   G cls     merge Wcls + bcls -> scores[hop]                B x A, K = M
//   G do_pred sigmoid(merge Wdp + bdp) -> do_pred[hop]        B x 1, K = M
// "G" is a tile GEMM of tile_gemm.cuh on the bf16 mma.sync body
// (MmaSmallFwd: 32 x 64 tiles, each k-slice's sums added in float32, with
// the forward's epilogue ops); the epilogues and the cell are those the
// training forward enqueues (rau_train_hops_phases.cuh).  Each weight is
// read once a hop for the whole batch, not once a row.  That is 2 + 11 H
// launches a call, 90 at H = 8.
//
// What bounds it on an H100: bytes.  At B=512 the features (ifeat + iatt,
// ~154 MB in bf16) dominate ~163 MB of traffic, against ~3.4 M multiply-adds
// a row and hop.  rows_eval reads them once a hop: they exceed the 50 MB L2
// at B=512, so each hop reads them from HBM (~0.37 ms over 8 hops); up to
// B of about 100 they stay in L2 across hops.  rows_eval reads iatt and
// ifeat with 16-byte loads: a warp a score cell, 8 features a lane; the
// pooling 8 columns a thread, S cut into slices whose float32 partials,
// each summed in ascending s, are added in slice order.  At small B the
// phases are latency-bound: one CTA a row, and tiles with few valid rows.

#include "rau_train_hops_phases.cuh"

namespace {

using bf16 = __nv_bfloat16;
using rth::take;

constexpr int RT = rth::NT;  // threads a CTA of rows_eval
constexpr int RW = RT / 32;
constexpr int ROWS_SMEM_LIMIT = 48 * 1024;  // rows_eval's, no opt-in

// weight order of rau_vqa_tpu/ops/rau_hops.py _WEIGHT_ORDER (:103-112)
enum {
  Q_W, Q_B, H_W, H_B, AQ_W, AQ_B, AS_W, AS_B, AM_W, AM_B, AP_W, AP_B,
  L_WI, L_BI, L_WH, L_BH, MG_W, MG_B, CLS_W, CLS_B, DP_W, DP_B, NWEIGHTS
};

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float bfr(float x) {  // round to bf16 and back
  return __bfloat162float(__float2bfloat16_rn(x));
}

// slices of S in rows_eval's pooling: enough that each thread has a
// (8-column group, slice) pair where the groups are fewer than the threads
__host__ __device__ __forceinline__ int pool_slices(int M) {
  const int groups = M / 8;
  return groups >= RT ? 1 : RT / groups;
}
// rows_eval's dynamic shared memory: qatt and w_score [F], p [S], and the
// pooling's partials [slices][M], float32
__host__ __device__ __forceinline__ size_t rows_smem(int S, int M, int F) {
  return ((size_t)2 * F + S + (size_t)pool_slices(M) * M) * sizeof(float);
}

// zero the carry (c, h and h in bf16) and the merge mask's seed; q to bf16
__global__ void prep_kernel(size_t nq, size_t nr, const float* __restrict__ q,
                            bf16* __restrict__ qb, float* __restrict__ c,
                            float* __restrict__ h, bf16* __restrict__ hb, int* seed) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t i0 = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i0 == 0) seed[0] = 0;
  for (size_t i = i0; i < nq + nr; i += stride) {
    if (i < nq) {
      qb[i] = __float2bfloat16_rn(q[i]);
    } else {
      const size_t j = i - nq;
      c[j] = 0.f;
      h[j] = 0.f;
      hb[j] = __float2bfloat16_rn(0.f);
    }
  }
}

// sum over 8 features from one 16-byte chunk of iatt at feature f0:
// bf16(tanh(iatt + qatt)) w_score
__device__ __forceinline__ float score8(const uint4& v, const float* qa, const float* w,
                                        int f0, float acc) {
  const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 x = __bfloat1622float2(x2[e]);
    const int f = f0 + 2 * e;
    acc = fmaf(bfr(tanhf(x.x + qa[f])), w[f], acc);
    acc = fmaf(bfr(tanhf(x.y + qa[f + 1])), w[f + 1], acc);
  }
  return acc;
}

// One row b a CTA: the attention score ((sum_f bf16(tanh(iatt + qatt)) w_f +
// b_score) + msc) + b_mem, the softmax over S into attprob (and its bf16
// copy pb, the join product's operand), and the pooling sum_s ifeat p_s
// (unrounded p) into pool.  F and M are multiples of 8.
__global__ void __launch_bounds__(RT) rows_eval_kernel(
    int S, int M, int F, const bf16* __restrict__ ifeat, const bf16* __restrict__ iatt,
    const float* __restrict__ qatt, const float* __restrict__ msc,
    const bf16* __restrict__ ws, const bf16* __restrict__ bs, const bf16* __restrict__ bmem,
    float* __restrict__ attprob, bf16* __restrict__ pb, float* __restrict__ pool) {
  extern __shared__ __align__(16) float sm[];
  float* qa = sm;        // [F]
  float* w = qa + F;     // [F]
  float* p = w + F;      // [S]
  float* part = p + S;   // [slices][M]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, b = blockIdx.x;
  for (int f = tid; f < F; f += RT) {
    qa[f] = qatt[(size_t)b * F + f];
    w[f] = bf(ws[f]);
  }
  __syncthreads();
  const float b_score = bf(bs[0]);
  const int F8 = F / 8;
  const bf16* ia = iatt + (size_t)b * S * F;
  // two cells a warp at a time, so that each lane has two loads in flight
  for (int s0 = warp; s0 < S; s0 += 2 * RW) {
    const int s1 = s0 + RW;
    const uint4* r0 = reinterpret_cast<const uint4*>(ia + (size_t)s0 * F);
    const uint4* r1 = reinterpret_cast<const uint4*>(ia + (size_t)min(s1, S - 1) * F);
    float a0 = 0.f, a1 = 0.f;
    for (int c = lane; c < F8; c += 32) {
      const uint4 v0 = r0[c];
      const uint4 v1 = r1[c];
      a0 = score8(v0, qa, w, 8 * c, a0);
      a1 = score8(v1, qa, w, 8 * c, a1);
    }
    a0 = rth::warp_sum(a0);
    a1 = rth::warp_sum(a1);
    if (lane == 0) {
      p[s0] = ((a0 + b_score) + msc[(size_t)b * S + s0]) + bf(bmem[s0]);
      if (s1 < S) p[s1] = ((a1 + b_score) + msc[(size_t)b * S + s1]) + bf(bmem[s1]);
    }
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
  for (int i = tid; i < S; i += RT) {
    attprob[(size_t)b * S + i] = p[i];
    pb[(size_t)b * S + i] = __float2bfloat16_rn(p[i]);
  }
  // pooling: (8-column group g, slice j) pairs, each summed in ascending s
  const int groups = M / 8, slices = pool_slices(M), per = (S + slices - 1) / slices;
  const bf16* ifr = ifeat + (size_t)b * S * M;
  for (int item = tid; item < groups * slices; item += RT) {
    const int g = item % groups, j = item / groups;
    const int s_end = min(S, (j + 1) * per);
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
#pragma unroll 4
    for (int s = j * per; s < s_end; ++s) {
      const uint4 v = *reinterpret_cast<const uint4*>(ifr + (size_t)s * M + 8 * g);
      const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&v);
      const float ps = p[s];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(x2[e]);
        acc[2 * e] = fmaf(x.x, ps, acc[2 * e]);
        acc[2 * e + 1] = fmaf(x.y, ps, acc[2 * e + 1]);
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) part[(size_t)j * M + 8 * g + e] = acc[e];
  }
  __syncthreads();
  for (int n = tid; n < M; n += RT) {
    float v = part[n];
    for (int j = 1; j < slices; ++j) v += part[(size_t)j * M + n];
    pool[(size_t)b * M + n] = v;
  }
}

// The scratch buffer: the carry (c in two buffers, the cell reading one and
// writing the other), the hop's [B, *] vectors and the bf16 operands the
// products read, and the merge mask's seed (MERGE_D reads it with the mask
// off).  Segments start on 256-byte boundaries.
struct Scratch {
  int* seed;
  bf16 *qb, *hb, *qfeatb, *pb, *joinb, *mergeb;
  float *qwq, *c[2], *h, *msc, *qfeat, *qatt, *pool, *join, *tmp, *gates;

  // returns the float count; base nullptr only counts
  static size_t carve(float* base, int B, int Q, int S, int M, int F, int R, Scratch* s) {
    size_t off = 0;
    auto f = [&](size_t n) { return take(base, off, n); };
    auto h = [&](size_t n) { return reinterpret_cast<bf16*>(take(base, off, (n + 1) / 2)); };
    const size_t b = (size_t)B;
    s->seed = reinterpret_cast<int*>(f(1));
    s->qb = h(b * Q);
    s->hb = h(b * R);
    s->qfeatb = h(b * M);
    s->pb = h(b * S);
    s->joinb = h(b * M);
    s->mergeb = h(b * M);
    s->qwq = f(b * M);
    s->c[0] = f(b * R);
    s->c[1] = f(b * R);
    s->h = f(b * R);
    s->msc = f(b * S);
    s->qfeat = f(b * M);
    s->qatt = f(b * F);
    s->pool = f(b * M);
    s->join = f(b * M);
    s->tmp = f(b * 4 * R);
    s->gates = f(b * 4 * R);
    return off;
  }
};

// Enqueues every phase of the H hops on the stream; with rec set, enqueues
// nothing and records each launch instead (the pointers are then unread).
int hops_launch(const void* q, const void* ifeat, const void* iatt, const void* const* W,
                void* scratch, void* scores, void* dopred, void* attprob, int B, int Q, int S,
                int M, int F, int R, int A, int H, long long scratch_floats, void* stream,
                rth::Rec* rec = nullptr) {
  if (B <= 0 || H <= 0 || Q <= 0 || S <= 0 || M <= 0 || F <= 0 || R <= 0 || A <= 0 ||
      F % 8 != 0 || M % 8 != 0 || rows_smem(S, M, F) > ROWS_SMEM_LIMIT ||
      (long long)B * S * (M > F ? M : F) >= (1ll << 31) ||
      (long long)B * (Q > 4 * R ? Q : 4 * R) >= (1ll << 31) || (long long)B * A >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  Scratch sc;
  if ((long long)Scratch::carve(nullptr, B, Q, S, M, F, R, &sc) > scratch_floats)
    return (int)cudaErrorInvalidValue;
  Scratch::carve(static_cast<float*>(scratch), B, Q, S, M, F, R, &sc);
  const cudaStream_t st = (cudaStream_t)stream;
  using E = rth::Enqueuer<bf16, tg::MmaBig, tg::MmaSmallFwd>;
  E eq{st, rec, sc.seed, 0u, 1.f, 0, cudaSuccess};
  constexpr int ew = rth::NT;
  {
    const size_t nq = (size_t)B * Q, nr = (size_t)B * R;
    const int blocks = (int)std::min<size_t>((nq + nr + ew - 1) / ew, 4096);
    if (!eq.dry(blocks, 0)) {
      prep_kernel<<<blocks, ew, 0, st>>>(nq, nr, static_cast<const float*>(q), sc.qb, sc.c[0],
                                         sc.h, sc.hb, sc.seed);
      eq.check(cudaGetLastError());
    }
  }
  eq.small(E::rows(sc.qb, Q), E::kmaj(W[Q_W], M), B, M, Q, eq.epi(tg::STORE, sc.qwq));
  const tg::Operand h_op = E::rows(sc.hb, R);
  const size_t rsmem = rows_smem(S, M, F);
  for (int hop = 0; hop < H; ++hop) {
    float* c_in = sc.c[hop % 2];
    float* c_out = sc.c[(hop + 1) % 2];
    float* probs = static_cast<float*>(attprob) + (size_t)hop * B * S;
    eq.small(h_op, E::kmaj(W[AM_W], S), B, S, R, eq.epi(tg::STORE, sc.msc));
    {
      tg::Epi e = eq.epi(tg::QFEAT, sc.qfeat);
      e.v0 = sc.qwq;
      e.bias0 = W[Q_B];
      e.bias1 = W[H_B];
      e.emit = sc.qfeatb;
      eq.small(h_op, E::kmaj(W[H_W], M), B, M, R, e);
    }
    {
      tg::Epi e = eq.epi(tg::BIAS, sc.qatt);
      e.bias0 = W[AQ_B];
      eq.small(E::rows(sc.qfeatb, M), E::kmaj(W[AQ_W], F), B, F, M, e);
    }
    if (!eq.dry(B, rsmem)) {
      rows_eval_kernel<<<B, RT, rsmem, st>>>(
          S, M, F, static_cast<const bf16*>(ifeat), static_cast<const bf16*>(iatt), sc.qatt,
          sc.msc, (const bf16*)W[AS_W], (const bf16*)W[AS_B], (const bf16*)W[AM_B], probs,
          sc.pb, sc.pool);
      eq.check(cudaGetLastError());
    }
    {
      tg::Epi e = eq.epi(tg::JOIN, sc.join);
      e.v0 = sc.qfeat;
      e.v1 = sc.pool;
      e.bias0 = W[AP_B];
      e.emit = sc.joinb;
      eq.small(E::rows(sc.pb, S), E::kmaj(W[AP_W], M), B, M, S, e);
    }
    eq.small(E::rows(sc.joinb, M), E::kmaj(W[L_WI], 4 * R), B, 4 * R, M,
             eq.epi(tg::STORE, sc.tmp));
    {
      tg::Epi e = eq.epi(tg::GATES, sc.gates);
      e.v0 = sc.tmp;
      e.bias0 = W[L_BI];
      e.bias1 = W[L_BH];
      eq.small(h_op, E::kmaj(W[L_WH], 4 * R), B, 4 * R, R, e);
    }
    if (!eq.dry((B * R + ew - 1) / ew, 0)) {
      // h and its bf16 copy are overwritten here: every reader of the old h
      // is enqueued above
      rth::cell_kernel<bf16><<<(B * R + ew - 1) / ew, ew, 0, st>>>(B, R, c_in, sc.gates, c_out,
                                                                 sc.h, sc.hb);
      eq.check(cudaGetLastError());
    }
    {
      tg::Epi e = eq.epi(tg::MERGE_D, nullptr);  // the mask is off
      e.v0 = sc.join;
      e.bias0 = W[MG_B];
      e.emit2 = sc.mergeb;
      eq.small(h_op, E::kmaj(W[MG_W], M), B, M, R, e);
    }
    const tg::Operand merge_op = E::rows(sc.mergeb, M);
    {
      tg::Epi e = eq.epi(tg::BIAS, static_cast<float*>(scores) + (size_t)hop * B * A);
      e.bias0 = W[CLS_B];
      eq.small(merge_op, E::kmaj(W[CLS_W], A), B, A, M, e);
    }
    {
      // do_pred w [M, 1]: one row of M, k contiguous
      tg::Epi e = eq.epi(tg::SIGMOID_BIAS, static_cast<float*>(dopred) + (size_t)hop * B);
      e.bias0 = W[DP_B];
      eq.small(merge_op, E::rows(W[DP_W], M), B, 1, M, e);
    }
  }
  return (int)eq.err;
}

}  // namespace

// q [B, Q] float32; ifeat [B, S, M], iatt [B, S, F] bf16; weights: 22 bf16
// pointers in _WEIGHT_ORDER; scratch: scratch_floats floats, at least
// rau_hops_describe(...)'s count.  Outputs scores [H, B, A], dopred [H, B],
// attprob [H, B, S], float32.  Enqueues every phase on the stream and
// returns the first error, cudaSuccess (0) if none; cudaErrorInvalidValue
// for shapes or a scratch buffer it cannot run.
extern "C" int rau_hops_launch(const void* q, const void* ifeat, const void* iatt,
                               const void* const* weights, void* scratch, void* scores,
                               void* dopred, void* attprob, int B, int Q, int S, int M, int F,
                               int R, int A, int H, long long scratch_floats, void* stream) {
  return hops_launch(q, ifeat, iatt, weights, scratch, scores, dopred, attprob, B, Q, S, M, F,
                     R, A, H, scratch_floats, stream);
}

// The launcher's own account of a call of one hop at these shapes: a dry run
// of the entry above (nothing is enqueued) writes each launch's grid x, y, z
// and dynamic shared memory bytes, in order, to launches (4 ints a launch, at
// most cap of them) and their count to n_launches: the two launches before
// the hops, then one hop's.  Returns the scratch floats it carves, -1 if it
// cannot run these shapes.
extern "C" int rau_hops_describe(int B, int Q, int S, int M, int F, int R, int A, int* launches,
                                 int cap, int* n_launches) {
  *n_launches = 0;
  if (B <= 0 || S <= 0) return -1;
  Scratch s;
  const size_t n = Scratch::carve(nullptr, B, Q, S, M, F, R, &s);
  if (n >= 0x7fffffff) return -1;
  const void* weights[NWEIGHTS] = {};
  rth::Rec rec{launches, cap, 0};
  const int err = hops_launch(nullptr, nullptr, nullptr, weights, nullptr, nullptr, nullptr,
                              nullptr, B, Q, S, M, F, R, A, 1, (long long)n, nullptr, &rec);
  *n_launches = rec.n;
  return err == 0 ? (int)n : -1;
}
