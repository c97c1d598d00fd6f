// The training hop loop's forward, for sm_90a.
//
// Replaces: rau_vqa_tpu/ops/rau_train_hops.py, _run_fwd (:358), whose Pallas
// body is _fwd_kernel (:320-355) with the per-hop math in _hop_fwd_core
// (:104-167) and the masks of ops/maskgen.py.
//
// Computes, for each of H hops under that hop's dropout masks (maskgen.cuh,
// regenerated from the element's global index): the image embedding ifeat =
// tanh((feats * fmask) Wi + bi) and addfeat = tanh(ifeat Wa + ba + qatt);
// qfeat from the masked question and the previous h; the attention softmax
// and pooling; join; the ATTLSTM step (gates [i, g, f, o]); merge_d = merge *
// mmask; the classifier scores and the do_pred sigmoid.  It saves the
// carries entering every hop and the final one, c_all / h_all [H+1, B, R],
// which is all the backward kernel needs to rematerialize.  Two
// instantiations, by the products' operand type T (rau_train_hops.cuh):
// float, as ours_ms trains by default (matmul_precision "highest"), and bf16
// for compute_dtype "bfloat16" (--bf16), where q, feats and the weights
// arrive in bf16, each product's operands are rounded to bf16 where they are
// produced (prep, and the epilogues' copies in T) and summed in float32, and
// everything else (carries, softmax, pooling, outputs) stays float32.
//
// Design: as the Pallas kernel tiles the batch (its grid is B / block_b),
// each hop is a fixed sequence of phases, each one launch over the whole
// batch, enqueued on the caller's stream by one C entry: the hop's forward
// phases that the backward also runs (rau_train_hops_phases.cuh), then two
// more:
//   G classifier  scores[hop] = merge_d Wcls + bcls           B x A, K = M
//   G do_pred     do_pred[hop] = sigmoid(merge_d Wdp + bdp)   B x 1, K = M
// Every product is one tile GEMM (tile_gemm.cuh) over all rows, so each
// weight is read once a hop and not once a row: the [B*S, *] image products
// on 128 x 128 tiles, the [B, *] ones on 32 x 32 tiles (FmaSmallFwd, whose
// epilogue also takes the merge without a cotangent and the sigmoid).  The
// cell writes the new carry straight into c_all / h_all [hop + 1] and the
// softmax into attprob[hop]; the workspace holds ifeat and addfeat for all
// rows.  All products take the FMA body in both types, each output one
// float32 chain in ascending k: in float32 the backward's own arithmetic,
// so its remat repeats this forward's sums.  In bf16 the body stages the
// bf16 operands converted to float32; a product of two bf16 values is exact
// in float32, so each output is a float32 chain of exact products, the
// arithmetic the bf16 bars against the plain version were set on.  On
// mma.sync (the backward's bf16 body) the tensor cores' truncated sums put
// the one-hop do_pred beyond its bar on 2 of 10 seeds (PERF.md).
//
// What bounds it on an H100: operations.  At B=100, H=8 the two image
// products (feats Wi, ifeat Wa: 15.4 GFLOP a hop) are ~123 GFLOP of float32
// FMA, ~1.8 ms at the 67 TFLOP/s non-tensor peak, against ~60 MB of traffic
// (feats 40 MB read once).  In bf16 the tensor cores' 989 TFLOP/s would
// bound it at ~0.13 ms; this kernel runs bf16 at the float32 FMA rate.

#include "rau_train_hops_phases.cuh"

namespace {

using rth::Dims;
using rth::take;

// The scratch buffer: feats_d and q_d in T, the hop's [B, *] vectors, qfeat
// / join / merge_d in T and, with bf16 products, the bf16 copies of the
// float32 operands (empty for float).  Segments start on 256-byte
// boundaries.
struct Scratch {
  void *fd, *qd;
  float *tmp, *msc, *qfeat, *qatt, *pool, *join, *gates;
  void *qfeatt, *joint, *merged;
  void *hb, *scb, *hnb, *xb;

  // returns the float count; base nullptr only counts
  static size_t carve(float* base, const Dims& d, int t_bytes, Scratch* s) {
    const size_t B = d.B, P = (size_t)d.B * d.S, M = d.M, F = d.F, R = d.R, S = d.S;
    size_t off = 0;
    auto in_t = [&](size_t n) { return take(base, off, (n * t_bytes + 3) / 4); };
    // the copies in T of a float32 operand: none when T is float
    auto copy = [&](size_t n) { return in_t(t_bytes == 4 ? 0 : n); };
    s->fd = in_t(P * d.Dc);
    s->qd = in_t(B * d.Q);
    s->tmp = take(base, off, B * (4 * R > M ? 4 * R : M));
    s->msc = take(base, off, B * S);
    s->qfeat = take(base, off, B * M);
    s->qatt = take(base, off, B * F);
    s->pool = take(base, off, B * M);
    s->join = take(base, off, B * M);
    s->gates = take(base, off, B * 4 * R);
    s->qfeatt = in_t(B * M);
    s->joint = in_t(B * M);
    s->merged = in_t(B * M);
    s->hb = copy(B * R);
    s->scb = copy(B * S);
    s->hnb = copy(B * R);
    s->xb = copy(P * M);
    return off;
  }
};

// Enqueues every phase of the H hops on the stream; with rec set, enqueues
// nothing and records each launch instead (the pointers are then unread).
template <class T>
int fwd_launch(const void* q, const void* feats, const void* seed_p,
               const void* const* weights, void* work, void* scratch, void* scores,
               void* dopred, void* attprob, void* c_all, void* h_all, int B, int Q, int S,
               int Dc, int M, int F, int R, int A, int H, long long scratch_floats,
               uint32_t thresh, float scale, int use_mask, void* stream,
               rth::Rec* rec = nullptr) {
  if (B <= 0 || H <= 0 || S <= 0 || Dc <= 0 || M <= 0 || F <= 0 || R <= 0 || Q <= 0 ||
      A <= 0)
    return (int)cudaErrorInvalidValue;
  const int P = B * S;
  const Dims d{B, Q, S, Dc, M, F, R, A, H};
  Scratch sc;
  if ((long long)Scratch::carve(nullptr, d, sizeof(T), &sc) > scratch_floats)
    return (int)cudaErrorInvalidValue;
  Scratch::carve(static_cast<float*>(scratch), d, sizeof(T), &sc);
  const cudaStream_t st = (cudaStream_t)stream;
  const rth::Dropout dr{0u, thresh, scale, use_mask != 0};
  const void* const* W = weights;  // in T
  float* c = static_cast<float*>(c_all);
  float* h = static_cast<float*>(h_all);
  cudaError_t err = cudaSuccess;
  if (!rec) err = cudaMemsetAsync(c, 0, (size_t)B * R * 4, st);
  if (err == cudaSuccess && !rec) err = cudaMemsetAsync(h, 0, (size_t)B * R * 4, st);
  // one launch a phase of fwd_plan, every product on the FMA body
  using E = rth::Enqueuer<T, tg::FmaBig, tg::FmaSmallFwd>;
  E eq{st, rec, static_cast<const int*>(seed_p), thresh, scale, use_mask, err};
  rth::HopBufs<T> fw{};
  fw.q = static_cast<const T*>(q);
  fw.feats = static_cast<const T*>(feats);
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
  fw.ifeat = static_cast<float*>(work);
  fw.addfeat = fw.ifeat + (size_t)P * M;
  fw.xb = static_cast<T*>(sc.xb);
  fw.scb = static_cast<T*>(sc.scb);
  fw.hnb = static_cast<T*>(sc.hnb);
  fw.qfeat_t = static_cast<T*>(sc.qfeatt);
  fw.join_t = static_cast<T*>(sc.joint);
  fw.merge_d = static_cast<T*>(sc.merged);
  const tg::Operand merge_op = E::rows(sc.merged, M);

  for (int hop = 0; hop < H; ++hop) {
    const size_t carry = (size_t)B * R;
    fw.c = c + hop * carry;
    fw.h = h + hop * carry;
    fw.cn = c + (hop + 1) * carry;
    fw.hn = h + (hop + 1) * carry;
    fw.sc = static_cast<float*>(attprob) + (size_t)hop * B * S;
    rth::hop_forward_phases(eq, d, dr, W, hop, fw);
    {
      tg::Epi e = eq.epi(tg::BIAS, static_cast<float*>(scores) + (size_t)hop * B * A);
      e.bias0 = W[rth::CLS_B];
      eq.small(merge_op, E::kmaj(W[rth::CLS_W], A), B, A, M, e);
    }
    {
      // do_pred w [M, 1]: one row of M, k contiguous
      tg::Epi e = eq.epi(tg::SIGMOID_BIAS, static_cast<float*>(dopred) + (size_t)hop * B);
      e.bias0 = W[rth::DP_B];
      eq.small(merge_op, E::rows(W[rth::DP_W], M), B, 1, M, e);
    }
  }
  return (int)eq.err;
}

}  // namespace

// q [B, Q], feats [B, S, Dc]; seed: one int32 on the device; weights: 26
// pointers in _FWD_WEIGHTS order; q, feats and the weights float32 (the
// first entry) or bf16 (the second); work: B * S * (M + F) floats; scratch:
// scratch_floats floats, at least train_hops_fwd_describe(...)'s count.
// Outputs scores [H, B, A], dopred [H, B], attprob [H, B, S], c_all / h_all
// [H+1, B, R], all float32.  thresh / scale: the dropout threshold and scale
// (use_mask 0 when the rate is 0).  Enqueues every phase on the stream and
// returns the first error, cudaSuccess (0) if none; cudaErrorInvalidValue
// for a plan it cannot run.
#define TRAIN_HOPS_FWD_ENTRY(NAME, T)                                                   \
  extern "C" int NAME(const void* q, const void* feats, const void* seed,              \
                      const void* const* weights, void* work, void* scores,            \
                      void* dopred, void* attprob, void* c_all, void* h_all,           \
                      void* scratch, int B, int Q, int S, int Dc, int M, int F, int R, \
                      int A, int H, long long scratch_floats, uint32_t thresh,         \
                      float scale, int use_mask, void* stream) {                       \
    return fwd_launch<T>(q, feats, seed, weights, work, scratch, scores, dopred,       \
                         attprob, c_all, h_all, B, Q, S, Dc, M, F, R, A, H,            \
                         scratch_floats, thresh, scale, use_mask, stream);             \
  }
TRAIN_HOPS_FWD_ENTRY(train_hops_fwd_launch, float)
TRAIN_HOPS_FWD_ENTRY(train_hops_fwd_bf16_launch, __nv_bfloat16)

// The launcher's own account of one hop at these shapes, operands of t_bytes
// bytes (4: float, 2: bf16): a dry run of the entries above (nothing is
// enqueued) writes each launch's grid x, y, z and dynamic shared memory
// bytes, in order, to launches (4 ints a launch, at most cap of them) and
// their count to n_launches.  Returns the scratch floats it carves, -1 if it
// cannot run these shapes.
extern "C" int train_hops_fwd_describe(int B, int Q, int S, int Dc, int M, int F, int R, int A,
                                       int t_bytes, int* launches, int cap, int* n_launches) {
  *n_launches = 0;
  if (B <= 0 || S <= 0 || (t_bytes != 4 && t_bytes != 2)) return -1;
  const Dims d{B, Q, S, Dc, M, F, R, A, 1};
  Scratch s;
  const size_t n = Scratch::carve(nullptr, d, t_bytes, &s);
  if (n >= 0x7fffffff) return -1;
  const void* weights[rth::NWEIGHTS] = {};
  rth::Rec rec{launches, cap, 0};
  const int err =
      t_bytes == 4
          ? fwd_launch<float>(nullptr, nullptr, nullptr, weights, nullptr, nullptr, nullptr,
                              nullptr, nullptr, nullptr, nullptr, B, Q, S, Dc, M, F, R, A, 1,
                              (long long)n, 0u, 1.f, 0, nullptr, &rec)
          : fwd_launch<__nv_bfloat16>(nullptr, nullptr, nullptr, weights, nullptr, nullptr,
                                      nullptr, nullptr, nullptr, nullptr, nullptr, B, Q, S, Dc,
                                      M, F, R, A, 1, (long long)n, 0u, 1.f, 0, nullptr, &rec);
  *n_launches = rec.n;
  return err == 0 ? (int)n : -1;
}
