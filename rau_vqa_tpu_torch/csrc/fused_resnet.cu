// A run of N ResNet identity bottlenecks (stride 1, no downsample), for sm_90a.
//
// Replaces: rau_vqa_tpu/ops/fused_resnet.py, fused_identity_stage (:129), whose
// Pallas body is _stage_kernel (:66-124).
//
// Computes, for each stacked block n of N over x [B, H, W, C]:
//   y1 = relu(x @ w1 + b1)                      1x1 reduce,   [.., Cw]
//   y2 = relu(conv3x3_zero_pad(y1, w2) + b2)    3x3, 9 taps,  [.., Cw]
//   x  = relu((x + y2 @ w3) + b3)               1x1 expand + residual, [.., C]
// Products take operands in the activation type and sum in f32; biases and the
// residual are added in f32; y1, y2 and each block's output round to the
// activation type, at the points where _stage_kernel rounds them.
//
// What bounds it on an H100: operations at stages 1-3 (bf16 tensor cores, 989
// TFLOP/s: the stage-2 run at 448 px and B=120 is 4.6 TFLOP against 0.4 GB of
// activation), bytes at stage 0 (C=256, Cw=64).
//
// Design.  The Pallas kernel keeps a batch tile's activation in VMEM across
// all N blocks.  Here one image's stage-2 activation is 1.6 MB and the batch's
// 192 MB, against 227 KB of shared memory a block and 50 MB of L2; reading and
// writing it once a block costs 8.4 GB at stage 2, 2.5 ms at 3.35 TB/s, well
// under the 4.7 ms bound on operations.  So the entry point launches one grid
// per identity block, ping-ponging between two activation buffers, and keeps
// what matters of the TPU kernel: y1 and y2 never reach device memory.  A CTA
// owns one image's output tile with all channels: 4x28 pixels, or 4x14 where
// Cw = 512 leaves no room for more.
//   - Products are wgmma.mma_async m64nNk16 (bf16, f32 sums) by two consumer
//     warpgroups, both operands read from shared memory through 128-byte-
//     swizzle descriptors, with no branch and no register operand between the
//     products of a slab: ptxas serialises wgmmas around either, waiting on
//     each alone.
//   - One producer warp feeds an S-deep ring (3, or 4 where shared memory
//     allows) of weight slabs, 64 K x 64-128 columns, through TMA, with a full
//     and an empty mbarrier a slot; for the reduce each slot also takes the
//     tile's x halo for 64 channels, a 4-D box [1, TH+2, TW+2, 64] that TMA
//     fills with zeros outside the image.  The weights come K-major
//     (pack_stage_weights: w1t [N, Cw, C], w2t [N, 9 Cw, Cw], w3t [N, C, Cw]),
//     one 128-byte row a column.  Consumers wait on full barriers and free a
//     slot as soon as its products are done: no block-wide barrier in a K
//     loop, three named barriers between the products.
//   - The reduce runs over the halo's m64 tiles (180 or 96 rows), each
//     warpgroup taking half of a 64-128-column chunk, A straight from the x
//     slot as TMA wrote it.  Halo pixels outside the image are 0 in y1 (not
//     relu(b1)): the 3x3 pads y1 with zeros.  The x halo is loaded again for
//     each chunk (twice at Cw = 256, four times at Cw = 512): all of Cw in one
//     pass would hold MT1 x Cw / 4 accumulators a thread (192 at 4x28 and
//     Cw = 256, 256 at 4x14 and Cw = 512), beyond the 168 registers that 288
//     threads a SM leave.
//   - The 3x3 and the expand run over the tile's rows of the halo grid, r =
//     py (TW + 2) + px (120 of 128 rows, or 64 with the columns split between
//     the warpgroups for 4x14), so that tap (dy, dx) reads the contiguous y1
//     rows from r + dy (TW + 2) + dx: a descriptor at that row, since the
//     swizzle follows the absolute address.  Columns px >= TW of the grid are
//     computed and not stored.  y1 and y2 sit K-major in 64-column chunks with
//     the same swizzle.
//   - The expand's epilogue transposes each quad's sums with shuffles, so that
//     the residual loads and the output stores move 16 bytes a lane.
//   - Each CTA loads every weight slab itself.  Sharing each slab over a
//     thread-block cluster of 2 or 4 by TMA multicast cut the L2 weight reads
//     2-4x and was 1.5-11.7% slower at every 448-px stage on an H100
//     (PERF.md): each slot's turnaround, not L2 bandwidth, bounds the kernel,
//     and the cluster's remote arrivals lengthen it.
// Shared memory: the weight ring (S x 16 KB), the x ring (S x the halo's rows x
// 128 B, aliased by y2 after the reduce), y1 (Cw x the halo's rows, and the
// rows the last tap reads past them), the biases; 101-228 KB.  The producer is
// one warp beside 256 consumer threads, so setmaxnreg (whole warpgroups only)
// would free nothing worth having: every thread may take 168 registers, one
// CTA a SM (two CTAs a SM with a 2-deep ring at stage 0 spilled and were
// slower).  Edge tiles compute the pixels outside the image
// and store nothing for them.  Sums run in a fixed order (no split-K), so two
// calls give the same bits.  The kernel takes a Probe policy that observes
// nothing here (NoProbe); csrc/fused_resnet_probe.cu instantiates it with
// probes that drop the loads or count cycles, for bench_torch_stage.py.
//
// The float32 instantiation (parity on the card) is plain FMA loops over a 4x8
// tile (halo 6x10) with y1 and y2 in f32 shared memory.  It is a separate
// kernel that no serving path runs: its tight float32 check validates only
// itself, not the bf16 kernel above, which has bf16 checks of its own.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

using namespace mma;
using namespace sm90;
typedef __nv_bfloat16 bf16;

constexpr int NTHREADS = 256;          // the float32 kernel
constexpr int NCONS = 256;             // two consumer warpgroups
constexpr int NTMA = NCONS + 32;       // and one producer warp
constexpr int SK = 64;                 // K a slab: one 128-byte swizzle row of bf16
constexpr int ROWB = SK * 2;           // bytes a slab row
constexpr int NB3 = 128;               // the expand's columns a slab

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int rup(int a, int b) { return cdiv(a, b) * b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// The tile, the reduce's and the 3x3's column chunk NB and the ring depth S.
// The 3x3 and the expand run over the tile's rows of the halo grid, r =
// py (TW + 2) + px, so that each tap reads a contiguous run of y1 rows (at
// offset dy (TW + 2) + dx); columns px >= TW of that grid are computed and
// not stored.
template <int TH_, int TW_, int NB_, int S_>
struct Cfg {
  static constexpr int TH = TH_, TW = TW_, NB = NB_, S = S_;
  static constexpr int HW = TW + 2, NHALO = (TH + 2) * HW;
  static constexpr int MROWS = TH * HW;              // halo-grid rows of the tile
  static constexpr int M = MROWS > 64 ? 128 : 64;    // rows of the 3x3 and the expand
  static constexpr bool SPLITN = M == 64;            // warpgroups split the columns
  static constexpr int MT1 = cdiv(NHALO, 64);        // the reduce's m64 tiles
  static constexpr int YROWS = rup(imax(NHALO, M + 2 * HW + 2), 8);   // y1 rows read
  static constexpr int XSLOT = rup(NHALO * ROWB, 1024);
  static constexpr int WSLOT = (NB > NB3 ? NB : NB3) * ROWB;
  static_assert(MROWS <= M && MT1 <= 4 && (NB == 64 || NB == 128), "tile");
};

// Shared memory, in bytes from a 1024-aligned base (ops/fused_resnet.py
// smem_bytes computes the same total; the card tests hold it to
// fused_identity_stage_smem).  y1 [Cw / 64][YROWS][64] and y2
// [Cw / 64][M][64] are K-major in 64-column chunks with the 128-byte swizzle,
// as the products read them.
template <class K>
struct Layout {
  int wring, xring, y2, y1, bias, bars, total;
  __host__ __device__ Layout(int C, int Cw) {
    const int chunks = Cw / SK;
    wring = 0;
    xring = y2 = K::S * K::WSLOT;
    y1 = xring + rup(imax(K::S * K::XSLOT, chunks * K::M * ROWB), 1024);
    bias = y1 + chunks * K::YROWS * ROWB;    // b1, b2, b3 as bf16
    bars = bias + rup((2 * Cw + C) * 2, 16);
    total = bars + 16 * K::S + 1024;         // + slack to align the base
  }
};

__device__ __forceinline__ void wg_mma(float (&d)[16], uint64_t a, uint64_t b) {
  wgmma_ss_n32(d, a, b);
}
__device__ __forceinline__ void wg_mma(float (&d)[32], uint64_t a, uint64_t b) {
  wgmma_ss_n64(d, a, b);
}
__device__ __forceinline__ void wg_mma(float (&d)[64], uint64_t a, uint64_t b) {
  wgmma_ss_n128(d, a, b);
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

__device__ __forceinline__ float bf(const bf16* p) { return __bfloat162float(*p); }

// Byte offset of (row, column) in a K-major matrix of `rows` rows stored in
// 64-column chunks with the 128-byte swizzle (the 16-byte group of the
// column XOR the row's phase in the 8-row pattern).
__device__ __forceinline__ uint32_t swz(int rows, int row, int col) {
  return (uint32_t)((col >> 6) * rows * ROWB + row * ROWB +
                    ((((col >> 3) & 7) ^ (row & 7)) << 4) + (col & 7) * 2);
}

// What the kernel observes besides its work: nothing.  A probe policy
// (csrc/fused_resnet_probe.cu) may drop the loads (LOADS false: the producer
// issues no TMA and the products run on stale shared memory) or time the
// consumers' waits on full slots (wait) and the ends of the reduce, the 3x3
// and the expand (mark 0, 1, 2), reported once a consumer thread is done
// (report: the slabs it took, the block).
struct NoProbe {
  static constexpr bool LOADS = true;
  template <class F>
  __device__ __forceinline__ void wait(F f) { f(); }
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void report(int, int) {}
};

// One product's K loop over `nslab` ring slots: step(s, slot) issues slab s's
// products as one commit group, and the slot is released as soon as they are
// done.  Each warpgroup holds one slot at a time, so that the producer keeps
// S - 1 slabs in flight; the other warpgroup's products keep the tensor cores
// busy meanwhile.  (Keeping one group in flight and releasing each slot a
// slab later, which holds two slots, was slower at every stage on an H100.)
template <class Wait, class Release, class Step>
__device__ __forceinline__ void slab_loop(int nslab, Wait& wait_full, Release& release,
                                          Step step) {
  for (int s = 0; s < nslab; ++s) {
    const int slot = wait_full();
    step(s, slot);
    wgmma_wait<0>();
    release(slot);
  }
}

// One identity block.  xmap: the block input [B, H, W, C] (box 64 x (TW+2) x
// (TH+2) x 1); w1map / w2map / w3map: w1t [N, Cw, C], w2t [N, 9 Cw, Cw], w3t
// [N, C, Cw] (boxes of 64 K x NB, NB, NB3 rows).  Grid: tiles x B CTAs.
template <class K, class Probe>
__global__ void __launch_bounds__(NTMA, 1)
identity_block_tma(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap w1map,
                   const __grid_constant__ CUtensorMap w2map,
                   const __grid_constant__ CUtensorMap w3map, const bf16* __restrict__ x,
                   bf16* __restrict__ out, const bf16* __restrict__ b1,
                   const bf16* __restrict__ b2, const bf16* __restrict__ b3, int n, int B, int H,
                   int W, int C, int Cw, int tiles_w, int tiles) {
  constexpr int TH = K::TH, TW = K::TW, HW = K::HW, NHALO = K::NHALO, MROWS = K::MROWS;
  constexpr int M = K::M, NB = K::NB, S = K::S, MT1 = K::MT1, YROWS = K::YROWS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);
  const Layout<K> lay(C, Cw);
  const uint32_t wring = base + lay.wring, xring = base + lay.xring;
  const uint32_t y1 = base + lay.y1, y2 = base + lay.y2;
  const uint32_t full = base + lay.bars, empty = full + 8 * S;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile = blockIdx.x % tiles, img = blockIdx.x / tiles;
  const int ty0 = (tile / tiles_w) * TH, tx0 = (tile % tiles_w) * TW;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, NCONS / 32);   // every consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == NCONS / 32) {
    // ---- the producer: one lane issues every slab, in the consumers' order
    if (lane == 0) {
      int i = 0;
      auto issue = [&](const CUtensorMap* map, int k0, int row0, int rows, bool with_x) {
        const int slot = i % S;
        mbar_wait(empty + 8 * slot, ((i / S) & 1) ^ 1);
        const uint32_t fb = full + 8 * slot;
        ++i;
        if (!Probe::LOADS) {
          mbar_arrive_expect_tx(fb, 0);
          return;
        }
        mbar_arrive_expect_tx(fb, rows * ROWB + (with_x ? NHALO * ROWB : 0));
        if (with_x) tma_load_4d(xring + slot * K::XSLOT, &xmap, fb, k0, tx0 - 1, ty0 - 1, img);
        tma_load_3d(wring + slot * K::WSLOT, map, fb, k0, row0, n);
      };
      for (int nc = 0; nc < Cw; nc += NB)
        for (int k0 = 0; k0 < C; k0 += SK) issue(&w1map, k0, nc, NB, true);
      for (int nc = 0; nc < Cw; nc += NB)
        for (int t = 0; t < 9; ++t)
          for (int k0 = 0; k0 < Cw; k0 += SK) issue(&w2map, k0, t * Cw + nc, NB, false);
      for (int nc = 0; nc < C; nc += NB3)
        for (int k0 = 0; k0 < Cw; k0 += SK) issue(&w3map, k0, nc, NB3, false);
    }
  } else {
    // ---- two consumer warpgroups; every product reads A and B from shared
    // memory through descriptors (no branch or register operand between the
    // products, so that ptxas keeps them in flight)
    const int wg = tid >> 7, wq = warp & 3, g = lane >> 2, t4 = lane & 3;
    int i = 0;   // slabs taken
    Probe probe;
    auto wait_full = [&]() {
      const int slot = i % S;
      probe.wait([&]() { mbar_wait(full + 8 * slot, (i / S) & 1); });
      ++i;
      return slot;
    };
    // the warp is done with `slot`: one arrival on its empty barrier
    auto release = [&](int slot) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * slot);
    };

    // the block's biases into shared memory, read by every epilogue
    bf16* const sb1 = reinterpret_cast<bf16*>(gbase + lay.bias);
    bf16* const sb2 = sb1 + Cw;
    bf16* const sb3 = sb2 + Cw;
    for (int c = tid; c < Cw; c += NCONS) {
      sb1[c] = b1[c];
      sb2[c] = b2[c];
    }
    for (int c = tid; c < C; c += NCONS) sb3[c] = b3[c];
    bar_sync(1, NCONS);
    auto store2 = [&](uint32_t addr, float v0, float v1) {
      __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(*reinterpret_cast<uint32_t*>(&v))
                   : "memory");
    };

    // 1. y1 = relu(x_halo @ w1 + b1) over the halo's MT1 m64 tiles, zero
    //    outside the image; warpgroup wg takes half of each column chunk
    {
      constexpr int NW = NB / 2;
      for (int nc = 0; nc < Cw; nc += NB) {
        float acc[MT1][NW / 2];
#pragma unroll
        for (int j = 0; j < MT1; ++j) {
          zero(acc[j]);
          fence_regs(acc[j]);
        }
        // A straight from the slot's x halo as TMA wrote it (K-major, 128-byte
        // swizzle, m64 tiles 8 KB apart)
        slab_loop(C / SK, wait_full, release, [&](int, int slot) {
          const uint64_t da = desc_sw128(xring + slot * K::XSLOT);
          const uint64_t db = desc_sw128(wring + slot * K::WSLOT + wg * NW * ROWB);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
#pragma unroll
            for (int j = 0; j < MT1; ++j)
              wg_mma(acc[j], da + j * (64 * ROWB >> 4) + 2 * ks, db + 2 * ks);
          wgmma_commit();
        });
#pragma unroll
        for (int j = 0; j < MT1; ++j) fence_regs(acc[j]);
#pragma unroll
        for (int j = 0; j < MT1; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = j * 64 + wq * 16 + g + 8 * h;
            if (r >= NHALO) continue;
            const int hy = ty0 - 1 + r / HW, hx = tx0 - 1 + r % HW;
            const bool inside = hy >= 0 && hy < H && hx >= 0 && hx < W;
#pragma unroll
            for (int nt = 0; nt < NW / 8; ++nt) {
              const int c = nc + wg * NW + nt * 8 + 2 * t4;
              float v0 = 0.f, v1 = 0.f;
              if (inside) {
                v0 = fmaxf(acc[j][4 * nt + 2 * h] + bf(sb1 + c), 0.f);
                v1 = fmaxf(acc[j][4 * nt + 2 * h + 1] + bf(sb1 + c + 1), 0.f);
              }
              store2(y1 + swz(YROWS, r, c), v0, v1);
            }
          }
      }
    }
    fence_proxy_async();   // y1's generic stores, before the products read them
    bar_sync(1, NCONS);    // y1 whole; the x ring (which y2 aliases) read
    probe.mark(0);

    // 2. y2 = relu(sum_t shift_t(y1) @ w2[t] + b2) over the tile's M
    //    halo-grid rows: tap t's A is y1 from row dy HW + dx on
    constexpr int NW = K::SPLITN ? NB / 2 : NB;       // columns a warpgroup
    const int mrow = K::SPLITN ? 0 : wg * 64;        // the warpgroup's first row
    {
      const int ncol = K::SPLITN ? wg * NW : 0;
      const int kslabs = Cw / SK;
      for (int nc = 0; nc < Cw; nc += NB) {
        float acc[NW / 2];
        zero(acc);
        fence_regs(acc);
        slab_loop(9 * kslabs, wait_full, release, [&](int s, int slot) {
          const int t = s / kslabs, kc = s - t * kslabs;
          const int off = (t / 3) * HW + t % 3;
          const uint64_t da = desc_sw128(y1 + (kc * YROWS + mrow + off) * ROWB);
          const uint64_t db = desc_sw128(wring + slot * K::WSLOT + ncol * ROWB);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) wg_mma(acc, da + 2 * ks, db + 2 * ks);
          wgmma_commit();
        });
        fence_regs(acc);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mrow + wq * 16 + g + 8 * h;
#pragma unroll
          for (int nt = 0; nt < NW / 8; ++nt) {
            const int c = nc + ncol + nt * 8 + 2 * t4;
            store2(y2 + swz(M, r, c), fmaxf(acc[4 * nt + 2 * h] + bf(sb2 + c), 0.f),
                   fmaxf(acc[4 * nt + 2 * h + 1] + bf(sb2 + c + 1), 0.f));
          }
        }
      }
    }
    fence_proxy_async();
    bar_sync(1, NCONS);   // y2 whole
    probe.mark(1);

    // 3. out = relu((x + y2 @ w3) + b3) for the rows that are pixels of the
    //    image
    {
      constexpr int NW3 = K::SPLITN ? NB3 / 2 : NB3;
      const int ncol = K::SPLITN ? wg * NW3 : 0;
      const size_t img0 = (size_t)img * H * W;
      size_t at[2];
      bool keep[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mrow + wq * 16 + g + 8 * h;
        const int oy = ty0 + r / HW, ox = tx0 + r % HW;
        keep[h] = r < MROWS && r % HW < TW && oy < H && ox < W && img < B;
        at[h] = keep[h] ? (img0 + (size_t)oy * W + ox) * C : 0;
      }
      for (int nc = 0; nc < C; nc += NB3) {
        float acc[NW3 / 2];
        zero(acc);
        fence_regs(acc);
        // the residual: for each 32-column pass, this lane's 8 consecutive
        // columns of its two rows (the quad transposes its sums below, so that
        // loads and stores move 16 bytes a lane), loaded before the products
        // so that its latency hides behind them
        constexpr int NP = NW3 / 32;
        uint4 res[NP][2];
#pragma unroll
        for (int q = 0; q < NP; ++q)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            res[q][h] = keep[h] ? *reinterpret_cast<const uint4*>(x + at[h] + nc + ncol +
                                                                  q * 32 + t4 * 8)
                                : make_uint4(0, 0, 0, 0);
        slab_loop(Cw / SK, wait_full, release, [&](int s, int slot) {
          const uint64_t da = desc_sw128(y2 + (s * M + mrow) * ROWB);
          const uint64_t db = desc_sw128(wring + slot * K::WSLOT + ncol * ROWB);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) wg_mma(acc, da + 2 * ks, db + 2 * ks);
          wgmma_commit();
        });
        fence_regs(acc);
        if (nc + NB3 >= C) probe.mark(2);
#pragma unroll
        for (int q = 0; q < NP; ++q)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // v[b]: this lane's pair of n8 block 4 q + b; r[j]: lane j's pair
            // of block 4 q + t4, i.e. columns 8 t4 + 2 j, + 1
            float2 v[4], r[4];
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              v[b] = make_float2(acc[4 * (4 * q + b) + 2 * h], acc[4 * (4 * q + b) + 2 * h + 1]);
              r[b] = b == t4 ? v[b] : make_float2(0.f, 0.f);
            }
#pragma unroll
            for (int k = 1; k < 4; ++k) {
              const int o = t4 ^ k;
              const float2 send = (o & 2) ? ((o & 1) ? v[3] : v[2]) : ((o & 1) ? v[1] : v[0]);
              const float2 recv = make_float2(__shfl_xor_sync(0xffffffffu, send.x, k),
                                              __shfl_xor_sync(0xffffffffu, send.y, k));
#pragma unroll
              for (int j = 0; j < 4; ++j) r[j] = j == o ? recv : r[j];
            }
            if (!keep[h]) continue;
            const int c = nc + ncol + q * 32 + t4 * 8;
            const uint4 bias = *reinterpret_cast<const uint4*>(sb3 + c);
            const uint32_t rw[4] = {res[q][h].x, res[q][h].y, res[q][h].z, res[q][h].w};
            const uint32_t bw[4] = {bias.x, bias.y, bias.z, bias.w};
            uint32_t ow[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float2 xr = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rw[j]));
              const float2 bv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bw[j]));
              __nv_bfloat162 o2 = __floats2bfloat162_rn(fmaxf((xr.x + r[j].x) + bv.x, 0.f),
                                                        fmaxf((xr.y + r[j].y) + bv.y, 0.f));
              ow[j] = *reinterpret_cast<uint32_t*>(&o2);
            }
            *reinterpret_cast<uint4*>(out + at[h] + c) = make_uint4(ow[0], ow[1], ow[2], ow[3]);
          }
      }
    }
    probe.report(i, n);
  }
}

// ---- float32: FMA loops over a 4x8 tile --------------------------------------

constexpr int FH = 4, FW = 8;                 // output tile
constexpr int FHH = FH + 2, FHW = FW + 2;     // halo tile
constexpr int FPIX = FH * FW, FHALO = FHH * FHW;  // 32, 60
constexpr int FG = 4;                         // pixels a thread sums at once

__global__ void __launch_bounds__(NTHREADS)
identity_block_f32(const float* __restrict__ x, float* __restrict__ out,
                   const float* __restrict__ w1, const float* __restrict__ b1,
                   const float* __restrict__ w2, const float* __restrict__ b2,
                   const float* __restrict__ w3, const float* __restrict__ b3, int H, int W,
                   int C, int Cw, int tiles_w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* y1 = reinterpret_cast<float*>(smem_raw);  // [FHALO][Cw]
  float* y2 = y1 + FHALO * Cw;                     // [FPIX][Cw]
  const int b = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_w) * FH, tx0 = (blockIdx.x % tiles_w) * FW;
  const size_t img = (size_t)b * H * W;

  // 1. reduce over the halo tile; zero outside the image
  for (int item = threadIdx.x; item < (FHALO / FG) * Cw; item += NTHREADS) {
    const int grp = item / Cw, n = item - grp * Cw;
    const float* xs[FG];
    bool in[FG];
    float acc[FG];
#pragma unroll
    for (int u = 0; u < FG; ++u) {
      const int r = grp * FG + u;
      const int hy = ty0 - 1 + r / FHW, hx = tx0 - 1 + r % FHW;
      in[u] = hy >= 0 && hy < H && hx >= 0 && hx < W;
      xs[u] = in[u] ? x + (img + (size_t)hy * W + hx) * C : x;
      acc[u] = 0.f;
    }
    for (int k = 0; k < C; ++k) {
      const float w = w1[(size_t)k * Cw + n];
#pragma unroll
      for (int u = 0; u < FG; ++u) acc[u] = fmaf(xs[u][k], w, acc[u]);
    }
#pragma unroll
    for (int u = 0; u < FG; ++u)
      y1[(grp * FG + u) * Cw + n] = in[u] ? fmaxf(acc[u] + b1[n], 0.f) : 0.f;
  }
  __syncthreads();
  // 2. the 3x3 over y1
  for (int item = threadIdx.x; item < (FPIX / FG) * Cw; item += NTHREADS) {
    const int grp = item / Cw, n = item - grp * Cw;
    float acc[FG];
#pragma unroll
    for (int u = 0; u < FG; ++u) acc[u] = 0.f;
    for (int t = 0; t < 9; ++t) {
      const int dy = t / 3, dx = t - dy * 3;
      const float* wt = w2 + (size_t)t * Cw * Cw + n;
      for (int k = 0; k < Cw; ++k) {
        const float w = wt[(size_t)k * Cw];
#pragma unroll
        for (int u = 0; u < FG; ++u) {
          const int p = grp * FG + u;
          acc[u] = fmaf(y1[((p / FW + dy) * FHW + p % FW + dx) * Cw + k], w, acc[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < FG; ++u) y2[(grp * FG + u) * Cw + n] = fmaxf(acc[u] + b2[n], 0.f);
  }
  __syncthreads();
  // 3. expand + residual
  for (int item = threadIdx.x; item < (FPIX / FG) * C; item += NTHREADS) {
    const int grp = item / C, n = item - grp * C;
    float acc[FG];
#pragma unroll
    for (int u = 0; u < FG; ++u) acc[u] = 0.f;
    for (int k = 0; k < Cw; ++k) {
      const float w = w3[(size_t)k * C + n];
#pragma unroll
      for (int u = 0; u < FG; ++u) acc[u] = fmaf(y2[(grp * FG + u) * Cw + k], w, acc[u]);
    }
#pragma unroll
    for (int u = 0; u < FG; ++u) {
      const int p = grp * FG + u;
      const int oy = ty0 + p / FW, ox = tx0 + p % FW;
      if (oy >= H || ox >= W) continue;
      const size_t i = (img + (size_t)oy * W + ox) * C + n;
      out[i] = fmaxf((x[i] + acc[u]) + b3[n], 0.f);
    }
  }
}

template <typename T, typename K>
cudaError_t launch_blocks(K kernel, size_t smem, int TH_, int TW_, const T* x, T* out, T* scratch,
                          const T* w1, const T* b1, const T* w2, const T* b2, const T* w3,
                          const T* b3, int B, int H, int W, int C, int Cw, int N,
                          cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int tiles_w = (W + TW_ - 1) / TW_, tiles_h = (H + TH_ - 1) / TH_;
  const dim3 grid(tiles_w * tiles_h, B);
  const T* in = x;
  for (int n = 0; n < N; ++n) {
    // the last block writes `out`; the ones before alternate with `scratch`
    T* dst = ((N - 1 - n) & 1) ? scratch : out;
    kernel<<<grid, NTHREADS, smem, stream>>>(
        in, dst, w1 + (size_t)n * C * Cw, b1 + (size_t)n * Cw, w2 + (size_t)n * 9 * Cw * Cw,
        b2 + (size_t)n * Cw, w3 + (size_t)n * Cw * C, b3 + (size_t)n * C, H, W, C, Cw, tiles_w);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    in = dst;
  }
  return cudaSuccess;
}

// ---- host side of the bf16 kernel -----------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so that
// the library needs no -lcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major bf16 tensor of `rank` dims (innermost first), its box, 128-byte
// swizzle; out-of-bounds elements read as zeros.
bool encode(CUtensorMap* map, const void* ptr, int rank, const uint64_t* dims,
            const uint32_t* box) {
  EncodeTiled fn = encoder();
  if (!fn) return false;
  cuuint64_t gdim[5], gstride[4];
  cuuint32_t bdim[5], estride[5];
  uint64_t stride = 2;
  for (int d = 0; d < rank; ++d) {
    gdim[d] = dims[d];
    bdim[d] = box[d];
    estride[d] = 1;
    if (d > 0) gstride[d - 1] = stride;
    stride *= dims[d];
  }
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), gdim, gstride,
            bdim, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class K, class Probe>
cudaError_t launch_tma(const bf16* x, bf16* out, bf16* scratch, const bf16* w1t, const bf16* b1,
                       const bf16* w2t, const bf16* b2, const bf16* w3t, const bf16* b3, int B,
                       int H, int W, int C, int Cw, int N, cudaStream_t stream) {
  if (Cw % K::NB) return cudaErrorInvalidValue;
  auto kernel = identity_block_tma<K, Probe>;
  const Layout<K> lay(C, Cw);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
  if (e != cudaSuccess) return e;
  // one CTA must fit on a SM with this shared memory
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NTMA, lay.total);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int tiles_w = cdiv(W, K::TW), tiles = tiles_w * cdiv(H, K::TH);
  const long long ctas = (long long)tiles * B;
  if (ctas > 0x7fffffff) return cudaErrorInvalidValue;

  CUtensorMap xm[3], w1m, w2m, w3m;
  const bf16* bufs[3] = {x, out, scratch};
  const uint64_t xd[4] = {(uint64_t)C, (uint64_t)W, (uint64_t)H, (uint64_t)B};
  const uint32_t xb[4] = {SK, K::TW + 2, K::TH + 2, 1};
  for (int k = 0; k < 3; ++k)
    if (!encode(&xm[k], bufs[k], 4, xd, xb)) return cudaErrorInvalidValue;
  const uint64_t d1[3] = {(uint64_t)C, (uint64_t)Cw, (uint64_t)N};
  const uint64_t d2[3] = {(uint64_t)Cw, (uint64_t)(9 * Cw), (uint64_t)N};
  const uint64_t d3[3] = {(uint64_t)Cw, (uint64_t)C, (uint64_t)N};
  const uint32_t bw[3] = {SK, (uint32_t)K::NB, 1}, bw3[3] = {SK, (uint32_t)NB3, 1};
  if (!encode(&w1m, w1t, 3, d1, bw) || !encode(&w2m, w2t, 3, d2, bw) ||
      !encode(&w3m, w3t, 3, d3, bw3))
    return cudaErrorInvalidValue;

  int src = 0;   // index of the block input in bufs
  for (int n = 0; n < N; ++n) {
    // the last block writes `out`; the ones before alternate with `scratch`
    const int dst = ((N - 1 - n) & 1) ? 2 : 1;
    kernel<<<(unsigned)ctas, NTMA, lay.total, stream>>>(
        xm[src], w1m, w2m, w3m, bufs[src], const_cast<bf16*>(bufs[dst]), b1 + (size_t)n * Cw,
        b2 + (size_t)n * Cw, b3 + (size_t)n * C, n, B, H, W, C, Cw, tiles_w, tiles);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    src = dst;
  }
  return cudaSuccess;
}

// The instantiations stage_plan chooses from, (TH, TW, NB, S); ops/fused_resnet.py
// INSTANCES lists the same, and fused_identity_stage_smem reports each one's
// shared memory so that the card tests hold the two lists and smem_bytes to it.
#define STAGE_TILES(X) X(4, 28, 64, 3) X(4, 28, 128, 3) X(4, 28, 128, 4) X(4, 14, 64, 3) \
  X(4, 14, 128, 3)

template <class Probe>
cudaError_t launch_bf16(int th, int tw, int nb, int ring, const bf16* x, bf16* out,
                        bf16* scratch, const bf16* w1t, const bf16* b1, const bf16* w2t,
                        const bf16* b2, const bf16* w3t, const bf16* b3, int B, int H, int W,
                        int C, int Cw, int N, cudaStream_t s) {
#define STAGE_TILE(TH, TW, NB, S)                                                           \
  if (th == TH && tw == TW && nb == NB && ring == S)                                       \
    return launch_tma<Cfg<TH, TW, NB, S>, Probe>(x, out, scratch, w1t, b1, w2t, b2, w3t, b3, \
                                                 B, H, W, C, Cw, N, s);
  STAGE_TILES(STAGE_TILE)
#undef STAGE_TILE
  return cudaErrorInvalidValue;
}

// x, out, scratch [B, H, W, C]; the stacked biases b1 [N, Cw], b2 [N, Cw],
// b3 [N, C]; all contiguous and of one type.  bf16 (is_bf16 = 1): w1, w2, w3
// are the K-major copies w1t [N, Cw, C], w2t [N, 9 Cw, Cw], w3t [N, C, Cw]
// (ops/fused_resnet.py pack_stage_weights), and (th, tw, nb, ring) the plan
// (stage_plan); needs C % 128 == 0, Cw % nb == 0, 64 <= Cw <= 512.  float32:
// w1 [N, C, Cw], w2 [N, 9, Cw, Cw], w3 [N, Cw, C] as stacked, the plan
// unused; needs Cw % 64 == 0.  Runs the N blocks in order on `stream`; the
// result lands in `out` (scratch may alias out when N = 1).  Returns the
// error of the first failing check or launch, or 0.
template <class Probe>
int stage_launch(const void* x, void* out, void* scratch, const void* w1, const void* b1,
                 const void* w2, const void* b2, const void* w3, const void* b3, int B, int H,
                 int W, int C, int Cw, int N, int is_bf16, int th, int tw, int nb, int ring,
                 void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || N <= 0 || C % 128 != 0 || Cw % 64 != 0 || Cw < 64 ||
      Cw > 512)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (is_bf16) {
    typedef const bf16* P;
    e = launch_bf16<Probe>(th, tw, nb, ring, (P)x, (bf16*)out, (bf16*)scratch, (P)w1, (P)b1,
                           (P)w2, (P)b2, (P)w3, (P)b3, B, H, W, C, Cw, N, s);
  } else {
    if (B > 65535) return (int)cudaErrorInvalidValue;
    typedef const float* P;
    const size_t smem = (size_t)(FHALO + FPIX) * Cw * sizeof(float);
    e = launch_blocks<float>(identity_block_f32, smem, FH, FW, (P)x, (float*)out,
                             (float*)scratch, (P)w1, (P)b1, (P)w2, (P)b2, (P)w3, (P)b3, B, H, W,
                             C, Cw, N, s);
  }
  return (int)e;
}

}  // namespace

extern "C" int fused_identity_stage_launch(const void* x, void* out, void* scratch,
                                           const void* w1, const void* b1, const void* w2,
                                           const void* b2, const void* w3, const void* b3,
                                           int B, int H, int W, int C, int Cw, int N,
                                           int is_bf16, int th, int tw, int nb, int ring,
                                           void* stream) {
  return stage_launch<NoProbe>(x, out, scratch, w1, b1, w2, b2, w3, b3, B, H, W, C, Cw, N,
                               is_bf16, th, tw, nb, ring, stream);
}

// The dynamic shared memory the launcher asks for a CTA of instantiation
// (th, tw, nb, ring) at (C, Cw): Layout's total; -1 where the library has no
// such instantiation.
extern "C" int fused_identity_stage_smem(int th, int tw, int nb, int ring, int C, int Cw) {
#define STAGE_SMEM(TH, TW, NB, S) \
  if (th == TH && tw == TW && nb == NB && ring == S) return Layout<Cfg<TH, TW, NB, S>>(C, Cw).total;
  STAGE_TILES(STAGE_SMEM)
#undef STAGE_SMEM
  return -1;
}
