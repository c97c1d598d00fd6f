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
// activation), bytes at stage 0 (C=256, Cw=64: 1.5 GB in and out against 0.42
// TFLOP).
//
// Design.  The Pallas kernel keeps a batch tile's whole activation in ~64 MB of
// VMEM across all N blocks.  A Hopper block has at most 227 KB of shared memory
// (one image's stage-2 activation is 1.6 MB), and blocks run in no order, so a
// block cannot take its 3x3 halo from a neighbour.  So the entry point launches
// one grid per identity block, ping-ponging between two activation buffers, and
// each CTA owns one image's output tile with all channels: 8x8 pixels, or 4x14
// where that divides the width and 8x8 does not (28 and 14 at 448 px, where
// 8x8 tiles would leave 23% of their rows outside the image).
//   1. y1 over the tile plus a 1-pixel halo (10x10 or 6x16 pixels) into shared
//      memory, as bf16.  Halo pixels outside the image are 0 in y1 (not
//      relu(b1)): the 3x3 pads y1 with zeros.  The reduce is recomputed on the
//      halo: 100/64 or 96/56 of the pixels, about +13% of a block's work at
//      stage 2.
//   2. y2 for the tile's pixels into shared memory: the 9 taps are 9 shifted
//      products whose A rows are gathered from y1 by ldmatrix row addresses.
//   3. the expand in 128-column chunks, reading the residual and writing the
//      block output.
// y1 and y2 never reach device memory, which is what the TPU kernel exists
// for; the block input is read once plus its halo, the output written once.
// Products are bf16 mma.sync m16n8k16 (f32 sums) on ldmatrix fragments; the
// weights and the reduce's input stream through a 3-deep ring of cp.async slabs
// of 32 K-rows (4-deep at Cw=512, where one CTA fills a SM), one barrier a
// slab.  Warps split the reduce 1x8 (every warp takes all halo rows) and the
// 3x3 and the expand 2x4 over 64 rows.  Shared memory: the halo's rows x (Cw+8)
// bf16 for y1, 64 x (Cw+8) for y2 (aliasing the reduce's input ring) and the
// weight ring: 197-201 KB at Cw=512, 108-110 KB at Cw=256 (two CTAs a SM).
// Edge tiles compute the pixels outside the image and store nothing for them.
//
// Measured on an H100 (chip_smoke.py): the ring's depth did not move the
// stage-2 time (a 2-deep ring with two barriers a slab took the same); the
// 4x14 tile did, by the rows it stops wasting.  The kernel runs at ~90-135
// TFLOP/s, well under what mma.sync can issue: every CTA streams all of a
// block's weights for 56-64 output pixels, and 32-row slabs leave little work
// between barriers.
//
// The float32 instantiation (parity on the card) is plain FMA loops over a 4x8
// tile (halo 6x10) with y1 and y2 in f32 shared memory.  It is a separate
// kernel that no serving path runs: its tight float32 check validates only
// itself, not the bf16 mma.sync kernel above, which has bf16 checks of its own.
//
// Not yet done (a later PR): wgmma/TMA, more output rows per weight slab, and
// keeping an image's activation on chip across blocks (a persistent CTA per
// image with a cluster-shared halo).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace mma;
typedef __nv_bfloat16 bf16;

constexpr int NTHREADS = 256;            // 8 warps
constexpr int MROWS = 64;                // rows of the 3x3 and the expand (4 m16 tiles)
constexpr int KS = 32;                   // K rows per slab
constexpr int PAD = 8;                   // bf16 of row padding (ldmatrix banks)
constexpr int LDA = KS + PAD;            // reduce input slab row
constexpr int NC3 = 128;                 // expand column chunk
constexpr int LDB = NC3 + PAD;           // weight slab row (chunks <= 128)

// One warp's share of one K slab: acc[MT][NT] += A[16 MT rows, KS] B[KS, 8 NT].
// a_addr[i]: this lane's ldmatrix row address of m-tile i at the slab's first
// column (row (lane & 15), column (lane >> 4) * 8 of the tile); b_addr: this
// lane's address in the weight slab at k-row (lane & 15), column
// n_warp + (lane >> 4) * 8; b_addr2: the same at column n_warp + 8 (NT - 1) for
// an odd NT's last tile.
template <int MT, int NT>
__device__ __forceinline__ void warp_slab(float (&acc)[MT][NT][4], const uint32_t (&a_addr)[MT],
                                          uint32_t b_addr, uint32_t b_addr2) {
#pragma unroll
  for (int kk = 0; kk < KS; kk += 16) {
    uint32_t bfr[NT][2];
#pragma unroll
    for (int j = 0; j + 1 < NT; j += 2) {
      uint32_t r[4];
      ldsm_x4_t(r, b_addr + (kk * LDB + j * 8) * 2);
      bfr[j][0] = r[0];
      bfr[j][1] = r[1];
      bfr[j + 1][0] = r[2];
      bfr[j + 1][1] = r[3];
    }
    if (NT & 1) {
      uint32_t r[2];
      ldsm_x2_t(r, b_addr2 + kk * LDB * 2);
      bfr[NT - 1][0] = r[0];
      bfr[NT - 1][1] = r[1];
    }
    uint32_t a[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) ldsm_x4(a[i], a_addr[i] + kk * 2);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a[i], bfr[j][0], bfr[j][1]);
  }
}

// Weight slab: rows [k0, k0 + KS) and columns [n0, n0 + NC) of a row-major
// [K, ldw] matrix into a [KS][LDB] shared buffer.
template <int NC>
__device__ __forceinline__ void load_w_slab(bf16* dst, const bf16* __restrict__ w, int ldw, int k0,
                                            int n0) {
  constexpr int CPR = NC / 8;  // 16-byte chunks a row
  for (int c = threadIdx.x; c < KS * CPR; c += NTHREADS) {
    const int r = c / CPR, q = c - r * CPR;
    cp_async16(smem_u32(dst + r * LDB + q * 8), w + (size_t)(k0 + r) * ldw + n0 + q * 8, true);
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// K loop over nslab slabs through an S-deep cp.async ring, one barrier a
// slab: load(s, slot) issues slab s's copies into ring slot `slot`,
// compute(s, slot) consumes it.  The copies of slab s + S - 1 go into the slot
// computed in the previous iteration, which every warp has left by then.
// Ends with a barrier, so the ring is free for the next loop.
template <int S, typename Load, typename Compute>
__device__ __forceinline__ void pipeline(int nslab, Load load, Compute compute) {
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nslab) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < nslab; ++s) {
    cp_async_wait<S - 2>();
    __syncthreads();
    const int pre = s + S - 1;
    if (pre < nslab) load(pre, pre % S);
    cp_async_commit();
    compute(s, s % S);
  }
  __syncthreads();
}

// An output tile of TH x TW <= MROWS pixels and its 1-pixel halo.
template <int TH_, int TW_>
struct Tile {
  static constexpr int TH = TH_, TW = TW_;
  static constexpr int HW = TW + 2;                  // halo row
  static constexpr int NPIX = TH * TW;
  static constexpr int NHALO = (TH + 2) * HW;
  static constexpr int MT1 = (NHALO + 15) / 16;      // m16 tiles of the reduce
  static_assert(NPIX <= MROWS && MT1 * 16 * (KS / 8) <= 2 * NTHREADS, "tile too large");
};
typedef Tile<8, 8> Square;   // 64 pixels, halo 100 (7 m16 tiles)
typedef Tile<4, 14> Wide;    // 56 pixels, halo 96 (6 m16 tiles): divides 14 and 28

// One identity block.  NC12: the column chunk of the reduce and the 3x3 (64
// or 128; divides Cw).  S: the depth of the slab ring.  T: the tile.
template <int NC12, int S, class T>
__global__ void __launch_bounds__(NTHREADS, 2)
identity_block_bf16(const bf16* __restrict__ x, bf16* __restrict__ out,
                    const bf16* __restrict__ w1, const bf16* __restrict__ b1,
                    const bf16* __restrict__ w2, const bf16* __restrict__ b2,
                    const bf16* __restrict__ w3, const bf16* __restrict__ b3, int H, int W,
                    int C, int Cw, int tiles_w) {
  constexpr int NT1 = NC12 / 64;  // reduce: warps 1 x 8
  constexpr int NT2 = NC12 / 32;  // 3x3: warps 2 x 4
  constexpr int NT3 = NC3 / 32;   // expand: warps 2 x 4
  constexpr int TH = T::TH, TW = T::TW, HW = T::HW, NPIX = T::NPIX, NHALO = T::NHALO;
  constexpr int MT1 = T::MT1;
  constexpr int ASLAB = MT1 * 16 * LDA, WSLAB = KS * LDB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld1 = Cw + PAD;
  bf16* y1 = reinterpret_cast<bf16*>(smem_raw);  // [NHALO][ld1]
  bf16* y2 = y1 + NHALO * ld1;                   // [MROWS][ld1]
  bf16* aslab = y2;                              // [S][MT1*16][LDA], reduce only
  bf16* wslab = y2 + max(MROWS * ld1, S * ASLAB);  // [S][KS][LDB]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int ty0 = (blockIdx.x / tiles_w) * TH, tx0 = (blockIdx.x % tiles_w) * TW;
  const size_t img = (size_t)blockIdx.y * H * W;
  const int lrow = lane & 15, lcol = (lane >> 4) * 8;

  // ---- 1. y1 = relu(x_halo @ w1 + b1), zero outside the image ------------
  {
    // this thread's reduce-input chunks: MT1*16 rows x KS/8 chunks a slab
    constexpr int CH = MT1 * 16 * (KS / 8);
    const bf16* src[2];
    bool val[2];
    int dsto[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = tid + u * NTHREADS;
      const int r = c >> 2, q = c & 3;
      const int hy = ty0 - 1 + r / HW, hx = tx0 - 1 + r % HW;
      val[u] = c < CH && r < NHALO && hy >= 0 && hy < H && hx >= 0 && hx < W;
      src[u] = val[u] ? x + ((img + (size_t)hy * W + hx) * C + q * 8) : x;
      dsto[u] = r * LDA + q * 8;
    }
    const int wn = warp * NT1 * 8;
    for (int n0 = 0; n0 < Cw; n0 += NC12) {
      float acc[MT1][NT1][4];
      zero(acc);
      pipeline<S>(
          C / KS,
          [&](int s, int slot) {
#pragma unroll
            for (int u = 0; u < 2; ++u)
              if (tid + u * NTHREADS < CH)
                cp_async16(smem_u32(aslab + slot * ASLAB + dsto[u]), src[u] + s * KS, val[u]);
            load_w_slab<NC12>(wslab + slot * WSLAB, w1, Cw, s * KS, n0);
          },
          [&](int, int slot) {
            uint32_t a_addr[MT1];
            const bf16* ab = aslab + slot * ASLAB;
#pragma unroll
            for (int i = 0; i < MT1; ++i) a_addr[i] = smem_u32(ab + (i * 16 + lrow) * LDA + lcol);
            const bf16* wb = wslab + slot * WSLAB;
            warp_slab<MT1, NT1>(acc, a_addr, smem_u32(wb + lrow * LDB + wn + lcol),
                                smem_u32(wb + lrow * LDB + wn + (NT1 - 1) * 8));
          });
#pragma unroll
      for (int i = 0; i < MT1; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = i * 16 + g + h * 8;
          if (r >= NHALO) continue;
          const int hy = ty0 - 1 + r / HW, hx = tx0 - 1 + r % HW;
          const bool inside = hy >= 0 && hy < H && hx >= 0 && hx < W;
#pragma unroll
          for (int j = 0; j < NT1; ++j) {
            const int n = n0 + wn + j * 8 + 2 * tig;
            float v0 = 0.f, v1 = 0.f;
            if (inside) {
              v0 = fmaxf(acc[i][j][2 * h] + __bfloat162float(b1[n]), 0.f);
              v1 = fmaxf(acc[i][j][2 * h + 1] + __bfloat162float(b1[n + 1]), 0.f);
            }
            *reinterpret_cast<__nv_bfloat162*>(y1 + r * ld1 + n) = __floats2bfloat162_rn(v0, v1);
          }
        }
    }
  }

  const int wm = warp >> 2, wnq = warp & 3;  // 2 x 4 warps over (rows, columns)

  // ---- 2. y2 = relu(sum_t shift_t(y1) @ w2[t] + b2) -----------------------
  // (y1's last writes are ordered before the first reads by the pipeline's
  // first barrier)
  {
    const int nks = Cw / KS;
    const int wn = wnq * NT2 * 8;
    for (int n0 = 0; n0 < Cw; n0 += NC12) {
      float acc[2][NT2][4];
      zero(acc);
      pipeline<S>(
          9 * nks,
          [&](int s, int slot) {
            const int t = s / nks, k0 = (s - t * nks) * KS;
            load_w_slab<NC12>(wslab + slot * WSLAB, w2 + (size_t)t * Cw * Cw, Cw, k0, n0);
          },
          [&](int s, int slot) {
            const int t = s / nks, k0 = (s - t * nks) * KS;
            const int dy = t / 3, dx = t - dy * 3;
            uint32_t a_addr[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              // output pixel of the tile; rows past NPIX repeat the last one
              const int p = min((wm * 2 + i) * 16 + lrow, NPIX - 1);
              const int hr = (p / TW + dy) * HW + (p % TW) + dx;
              a_addr[i] = smem_u32(y1 + hr * ld1 + k0 + lcol);
            }
            const bf16* wb = wslab + slot * WSLAB;
            warp_slab<2, NT2>(acc, a_addr, smem_u32(wb + lrow * LDB + wn + lcol),
                              smem_u32(wb + lrow * LDB + wn + (NT2 - 1) * 8));
          });
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = (wm * 2 + i) * 16 + g + h * 8;
#pragma unroll
          for (int j = 0; j < NT2; ++j) {
            const int n = n0 + wn + j * 8 + 2 * tig;
            const float v0 = fmaxf(acc[i][j][2 * h] + __bfloat162float(b2[n]), 0.f);
            const float v1 = fmaxf(acc[i][j][2 * h + 1] + __bfloat162float(b2[n + 1]), 0.f);
            *reinterpret_cast<__nv_bfloat162*>(y2 + p * ld1 + n) = __floats2bfloat162_rn(v0, v1);
          }
        }
    }
  }

  // ---- 3. out = relu((x + y2 @ w3) + b3) ----------------------------------
  {
    const int wn = wnq * NT3 * 8;
    uint32_t a_base[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) a_base[i] = smem_u32(y2 + ((wm * 2 + i) * 16 + lrow) * ld1 + lcol);
    for (int n0 = 0; n0 < C; n0 += NC3) {
      float acc[2][NT3][4];
      zero(acc);
      pipeline<S>(
          Cw / KS,
          [&](int s, int slot) { load_w_slab<NC3>(wslab + slot * WSLAB, w3, C, s * KS, n0); },
          [&](int s, int slot) {
            const uint32_t a_addr[2] = {a_base[0] + s * KS * 2, a_base[1] + s * KS * 2};
            const bf16* wb = wslab + slot * WSLAB;
            warp_slab<2, NT3>(acc, a_addr, smem_u32(wb + lrow * LDB + wn + lcol),
                              smem_u32(wb + lrow * LDB + wn + (NT3 - 1) * 8));
          });
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = (wm * 2 + i) * 16 + g + h * 8;
          const int oy = ty0 + p / TW, ox = tx0 + p % TW;
          if (p >= NPIX || oy >= H || ox >= W) continue;
          const size_t base = (img + (size_t)oy * W + ox) * C;
#pragma unroll
          for (int j = 0; j < NT3; ++j) {
            const int n = n0 + wn + j * 8 + 2 * tig;
            const float2 r =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + base + n));
            const float v0 = fmaxf((r.x + acc[i][j][2 * h]) + __bfloat162float(b3[n]), 0.f);
            const float v1 = fmaxf((r.y + acc[i][j][2 * h + 1]) + __bfloat162float(b3[n + 1]), 0.f);
            *reinterpret_cast<__nv_bfloat162*>(out + base + n) = __floats2bfloat162_rn(v0, v1);
          }
        }
    }
  }
}

template <class T>
size_t smem_bf16(int Cw, int S) {
  const int ld1 = Cw + PAD;
  const int region = MROWS * ld1 > S * T::MT1 * 16 * LDA ? MROWS * ld1 : S * T::MT1 * 16 * LDA;
  return (size_t)(T::NHALO * ld1 + region + S * KS * LDB) * sizeof(bf16);
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

// The ring is 4 deep where one CTA fills a SM (Cw > 256), else 3 deep (two
// CTAs a SM up to Cw = 256).
template <class T>
cudaError_t launch_bf16(const bf16* x, bf16* out, bf16* scratch, const bf16* w1, const bf16* b1,
                        const bf16* w2, const bf16* b2, const bf16* w3, const bf16* b3, int B,
                        int H, int W, int C, int Cw, int N, cudaStream_t stream) {
  const bool deep = Cw > 256 && Cw % 128 == 0;
  auto kernel = Cw % 128 ? identity_block_bf16<64, 3, T>
                : deep   ? identity_block_bf16<128, 4, T>
                         : identity_block_bf16<128, 3, T>;
  return launch_blocks<bf16>(kernel, smem_bf16<T>(Cw, deep ? 4 : 3), T::TH, T::TW, x, out,
                             scratch, w1, b1, w2, b2, w3, b3, B, H, W, C, Cw, N, stream);
}

}  // namespace

// x, out, scratch [B, H, W, C]; the stacked weights w1 [N, C, Cw], b1 [N, Cw],
// w2 [N, 9, Cw, Cw], b2 [N, Cw], w3 [N, Cw, C], b3 [N, C], all contiguous and
// of one type: bf16 (is_bf16 = 1) or float32.  Runs the N blocks in order on
// `stream`; the result lands in `out` (scratch may alias out when N = 1).
// Needs C % 128 == 0, Cw % 64 == 0 and 64 <= Cw <= 512.  Returns
// cudaGetLastError() of the first failing launch, or 0.
extern "C" int fused_identity_stage_launch(const void* x, void* out, void* scratch,
                                           const void* w1, const void* b1, const void* w2,
                                           const void* b2, const void* w3, const void* b3,
                                           int B, int H, int W, int C, int Cw, int N,
                                           int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || N <= 0 || C % NC3 != 0 || Cw % 64 != 0 || Cw < 64 ||
      Cw > 512 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (is_bf16) {
    typedef const bf16* P;
    // 4x14 tiles where they divide the width and 8x8 ones do not (28, 14)
    e = (W % 8 && W % 14 == 0 ? launch_bf16<Wide> : launch_bf16<Square>)(
        (P)x, (bf16*)out, (bf16*)scratch, (P)w1, (P)b1, (P)w2, (P)b2, (P)w3, (P)b3, B, H, W, C,
        Cw, N, s);
  } else {
    typedef const float* P;
    const size_t smem = (size_t)(FHALO + FPIX) * Cw * sizeof(float);
    e = launch_blocks<float>(identity_block_f32, smem, FH, FW, (P)x, (float*)out,
                             (float*)scratch, (P)w1, (P)b1, (P)w2, (P)b2, (P)w3, (P)b3, B, H, W,
                             C, Cw, N, s);
  }
  return (int)e;
}
