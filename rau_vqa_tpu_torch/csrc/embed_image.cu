// The serving step's image embedding, for sm_90a: float32 products on the
// tensor cores in 3xTF32, with the bias, the tanh and the bf16 outputs fused.
//
// Replaces no TPU kernel: the JAX package leaves embed_image to XLA
// (rau_vqa_tpu/models/rau.py embed_image, called by rau_vqa_tpu/eval/predict.py
// predict_fused).  The port ran it as two cuBLAS float32 products (TF32 off)
// and five elementwise passes over 100-200 MB tensors.
//
// Computes, over the R = B S rows of feats [R, Dc]:
//   ifeat = tanh(feats W_i + b_i)      [R, M]   phase 1
//   iatt  = ifeat W_a + b_a            [R, F]   phase 2, from the float32 ifeat
// and writes ifeat and iatt as bf16 (round to nearest even, as .to(bfloat16)),
// the two tensors the hop loop reads.
//
// Precision: float32, as the configurations state it.  Each float32 operand x
// is split into big = tf32(x) and small = tf32(x - big) (cvt.rna: 10 mantissa
// bits), and a product a b is summed as a_small b_big + a_big b_small +
// a_big b_big on the tensor cores: what is dropped (a_small b_small and the
// rounding of small) is ~2^-22 of |a b|, under float32's own rounding of a sum
// over K = 512-2048.  The tensor cores' float32 sums round at every step of 8
// K; so that a long sum does not gather their error, each warpgroup sums 16 K
// at a time from zero on the tensor cores and adds that into a second set of
// float32 registers.  The weights are split once, on the host
// (ops/embed_image.py pack_embed_weights: big and small planes, K-major); the
// features are split here, in registers, as each tile arrives.
//
// What bounds it on an H100: operations.  3 x 2 R (Dc M + M F) at 495 TFLOP/s
// of TF32: 1.44 ms at R = 512 x 196, Dc = 2048 (Ours_ResNet's serving batch),
// 0.48 ms at Dc = 512 (Ours_MS); the features, 822 and 205 MB, take 0.25 and
// 0.06 ms at 3.35 TB/s.
//
// Design.  One C entry enqueues the two phases as two launches of one kernel
// template; phase 1 also writes the float32 ifeat to a scratch buffer that
// phase 2 reads (205 MB each way at Dc = 512, M = 512, B = 512).  Each launch
// is a persistent grid, at most one CTA per SM's worth of shared memory, that
// walks output tiles of BM rows x BN columns, the column tiles of one row tile
// next to each other so that neighbouring CTAs share its features in L2.
//   - One producer warp keeps an S-deep ring full through TMA: a slot holds A
//     [BM rows x 32 K] float32 and the big and small planes of B [BN x 32 K],
//     all with the 128-byte swizzle, behind a full and an empty mbarrier.
//   - One or two consumer warpgroups of 64 rows each.  For each slot a thread
//     loads its A fragments (16 floats) from shared memory and splits them in
//     registers, then issues 12 wgmma m64nBNk8 (A from registers, B from the
//     slot through descriptors); all of a slot's fragments are in registers
//     before its first product, so that no A register changes between them.
//     Every 16 K the products are waited for and added into the float32 sum;
//     a slot is released once its products are done, and the other warpgroup
//     keeps the tensor cores busy meanwhile.
//   - The epilogue adds the bias, takes tanhf (phase 1), and stores bf16 pairs
//     (and float32 pairs to the scratch); rows past R and columns past N are
//     not stored.  TMA reads what lies past the operands as zeros: rows of A
//     past R, K past the last slot's end, rows of the small plane past 2 N.
//     The last column tile's big-plane box runs on into the small plane's
//     first rows; those products land in columns past N, which are dropped.
//     So the kernel takes any R, any K a multiple of 4 (TMA's 16-byte row
//     pitch) and any N a multiple of 8 (an 8-column group is all in or out).
//   - ops/embed_image.py embed_plan picks (BM, BN) per phase from R: the
//     largest tile whose tiles still fill the SMs, down to 64 x 64.
// Sums run in a fixed order (no split K), so two calls give the same bits.

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

constexpr int SK = 32;                   // K a slot: one 128-byte swizzle row of float32
constexpr int ROWB = SK * 4;             // bytes a slot row
constexpr int KSUM = 2;                  // k8 steps summed on the tensor cores from zero
constexpr int SMEM_LIMIT = 232448;       // dynamic shared memory a block can have
constexpr int MAX_RING = 4;
constexpr int MAX_DEVICES = 64;

// The tile's shared memory: S slots of A [BM][32] and B's big and small planes
// [BN][32], then the ring's mbarriers.
template <int WGS, int BN>
struct Tile {
  static constexpr int BM = 64 * WGS, NCONS = 128 * WGS, NTHREADS = NCONS + 32;
  static constexpr int ASLOT = BM * ROWB, BSLOT = BN * ROWB, SLOT = ASLOT + 2 * BSLOT;
  static constexpr int S0 = (SMEM_LIMIT - 1024 - 16 * MAX_RING) / SLOT;
  static constexpr int S = S0 < MAX_RING ? S0 : MAX_RING;
  static constexpr int SMEM = S * SLOT + 16 * S + 1024;   // + slack to align the base
  static_assert(S >= 2, "ring");
};

template <int R>
__device__ __forceinline__ void wg_tf32(float (&d)[R], const uint32_t (&a)[4], uint64_t b,
                                        int scale_d);
template <>
__device__ __forceinline__ void wg_tf32<32>(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
  wgmma_rs_tf32_n64(d, a, b, scale_d);
}
template <>
__device__ __forceinline__ void wg_tf32<64>(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
  wgmma_rs_tf32_n128(d, a, b, scale_d);
}

__device__ __forceinline__ float ld_shared_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// out [R, N] bf16 (and out32 [R, N] float32 where not null) = act(A B + bias)
// for A [R, K] (amap, box 32 x BM) and B's planes [2 N, K] (bmap: big rows
// 0..N-1, small rows N..2N-1; box 32 x BN).
template <int WGS, int BN, bool TANH>
__global__ void __launch_bounds__(Tile<WGS, BN>::NTHREADS, 1)
embed_image_tf32x3(const __grid_constant__ CUtensorMap amap,
                   const __grid_constant__ CUtensorMap bmap, const float* __restrict__ bias,
                   bf16* __restrict__ out, float* __restrict__ out32, int rows, int K, int N,
                   int col_tiles, int tiles) {
  typedef Tile<WGS, BN> T;
  constexpr int S = T::S, BM = T::BM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = base + S * T::SLOT, empty = full + 8 * S;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nslab = (K + SK - 1) / SK;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, T::NCONS / 32);   // every consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == T::NCONS / 32) {
    // ---- the producer: one lane issues every slot, in the consumers' order
    if (lane == 0) {
      int i = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int row0 = (t / col_tiles) * BM, n0 = (t % col_tiles) * BN;
        for (int s = 0; s < nslab; ++s, ++i) {
          const int slot = i % S;
          mbar_wait(empty + 8 * slot, ((i / S) & 1) ^ 1);
          const uint32_t fb = full + 8 * slot, dst = base + slot * T::SLOT;
          mbar_arrive_expect_tx(fb, T::SLOT);
          tma_load_2d(dst, &amap, fb, s * SK, row0);
          tma_load_2d(dst + T::ASLOT, &bmap, fb, s * SK, n0);
          tma_load_2d(dst + T::ASLOT + T::BSLOT, &bmap, fb, s * SK, N + n0);
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroups: warpgroup wg takes rows 64 wg.. of the tile
  const int wg = tid >> 7, wq = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int r_in = wg * 64 + wq * 16 + g;   // this thread's first row (and r_in + 8)
  int i = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int row0 = (t / col_tiles) * BM, n0 = (t % col_tiles) * BN;
    float sum[BN / 2], part[BN / 2];
#pragma unroll
    for (int k = 0; k < BN / 2; ++k) sum[k] = 0.f;
    for (int s = 0; s < nslab; ++s, ++i) {
      const int slot = i % S;
      mbar_wait(full + 8 * slot, (i / S) & 1);
      const uint32_t sa = base + slot * T::SLOT;
      // the slot's A fragments, split: hi = tf32(a), lo = tf32(a - hi).  Row
      // r_in & 7 = g: the 16-byte group of column c in row r is (c / 4) ^ g.
      uint32_t hi[SK / 8][4], lo[SK / 8][4];
#pragma unroll
      for (int ks = 0; ks < SK / 8; ++ks)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int row = r_in + 8 * (v & 1), grp = 2 * ks + (v >> 1);
          const float a = ld_shared_f32(sa + row * ROWB + ((grp ^ g) << 4) + t4 * 4);
          hi[ks][v] = tf32_rna(a);
          lo[ks][v] = tf32_rna(a - __uint_as_float(hi[ks][v]));
        }
#pragma unroll
      for (int ks = 0; ks < SK / 8; ++ks) {
        fence_regs(hi[ks]);
        fence_regs(lo[ks]);
      }
      const uint64_t dbig = desc_sw128(sa + T::ASLOT), dsmall = desc_sw128(sa + T::ASLOT + T::BSLOT);
#pragma unroll
      for (int c = 0; c < SK / 8; c += KSUM) {
        fence_regs(part);
        wgmma_fence();
#pragma unroll
        for (int ks = c; ks < c + KSUM; ++ks) {
          wg_tf32(part, lo[ks], dbig + 2 * ks, ks != c);
          wg_tf32(part, hi[ks], dsmall + 2 * ks, 1);
          wg_tf32(part, hi[ks], dbig + 2 * ks, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(part);
#pragma unroll
        for (int k = 0; k < BN / 2; ++k) sum[k] += part[k];
      }
      // the warp is done with the slot: one arrival on its empty barrier
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * slot);
    }

    // the epilogue: d[4j + 2h + e] is row r_in + 8h, column 8j + 2 t4 + e
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + r_in + 8 * h;
      if (r >= rows) continue;
      const size_t at = (size_t)r * N + n0 + 2 * t4;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        if (n0 + 8 * j >= N) break;
        const float2 b = __ldg(reinterpret_cast<const float2*>(bias + n0 + 8 * j + 2 * t4));
        float v0 = sum[4 * j + 2 * h] + b.x, v1 = sum[4 * j + 2 * h + 1] + b.y;
        if (TANH) {
          v0 = tanhf(v0);
          v1 = tanhf(v1);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + at + 8 * j) = __floats2bfloat162_rn(v0, v1);
        if (out32) *reinterpret_cast<float2*>(out32 + at + 8 * j) = make_float2(v0, v1);
      }
    }
  }
}

// One phase: out = act(a W + bias) for a [rows, K] float32, W given as its
// planes [2 N, K]; grid = min(tiles, the CTAs the SMs hold).
template <int WGS, int BN, bool TANH>
cudaError_t launch_phase(const float* a, const float* planes, const float* bias, bf16* out,
                         float* out32, int rows, int K, int N, int n_sm, cudaStream_t stream) {
  typedef Tile<WGS, BN> T;
  auto kernel = embed_image_tf32x3<WGS, BN, TANH>;
  // the shared memory attribute and the CTAs a SM holds, found at this
  // instantiation's first launch on each device (a serving step's host time
  // is part of its latency)
  static int per_sm[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (per_sm[dev] < 1) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return e;
    int n = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, T::NTHREADS, T::SMEM);
    if (e != cudaSuccess) return e;
    if (n < 1) return cudaErrorInvalidConfiguration;
    per_sm[dev] = n;
  }
  CUtensorMap amap, bmap;
  const uint64_t ad[2] = {(uint64_t)K, (uint64_t)rows}, bd[2] = {(uint64_t)K, 2 * (uint64_t)N};
  const uint32_t ab[2] = {SK, (uint32_t)T::BM}, bb[2] = {SK, (uint32_t)BN};
  if (!tma_encode(&amap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a, 2, ad, ab) ||
      !tma_encode(&bmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, planes, 2, bd, bb))
    return cudaErrorInvalidValue;
  const int col_tiles = (N + BN - 1) / BN;
  const long long tiles = (long long)((rows + T::BM - 1) / T::BM) * col_tiles;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const long long most = (long long)n_sm * per_sm[dev];
  const int grid = (int)(tiles < most ? tiles : most);
  kernel<<<grid, T::NTHREADS, T::SMEM, stream>>>(amap, bmap, bias, out, out32, rows, K, N,
                                                 col_tiles, (int)tiles);
  return cudaGetLastError();
}

// The tiles ops/embed_image.py EMBED_TILES lists, (BM, BN).
template <bool TANH>
cudaError_t launch_tile(int bm, int bn, const float* a, const float* planes, const float* bias,
                        bf16* out, float* out32, int rows, int K, int N, int n_sm,
                        cudaStream_t s) {
  if (bm == 128 && bn == 128)
    return launch_phase<2, 128, TANH>(a, planes, bias, out, out32, rows, K, N, n_sm, s);
  if (bm == 64 && bn == 128)
    return launch_phase<1, 128, TANH>(a, planes, bias, out, out32, rows, K, N, n_sm, s);
  if (bm == 64 && bn == 64)
    return launch_phase<1, 64, TANH>(a, planes, bias, out, out32, rows, K, N, n_sm, s);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// feats [rows, Dc] float32; wi [2 M, Dc] and wa [2 F, M] the big and small
// planes of W_i and W_a, K-major (pack_embed_weights); bi [M], ba [F] float32;
// ifeat [rows, M] and iatt [rows, F] bf16; scratch [rows, M] float32 (phase
// 1's ifeat, which phase 2 reads).  (bm1, bn1) and (bm2, bn2) the two phases'
// tiles (embed_plan).  Needs Dc a multiple of 4, M and F multiples of 8, and
// 16-byte aligned operands.  Enqueues both phases on `stream`; returns the
// error of the first failing check or launch, or 0.
extern "C" int embed_image_launch(const float* feats, const float* wi, const float* bi,
                                  const float* wa, const float* ba, void* ifeat, void* iatt,
                                  float* scratch, int rows, int Dc, int M, int F, int bm1,
                                  int bn1, int bm2, int bn2, int n_sm, void* stream) {
  if (rows < 1 || Dc < 4 || M < 8 || F < 8 || Dc % 4 || M % 8 || F % 8 || n_sm < 1 ||
      !aligned16(feats) || !aligned16(wi) || !aligned16(bi) || !aligned16(wa) ||
      !aligned16(ba) || !aligned16(ifeat) || !aligned16(iatt) || !aligned16(scratch))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = launch_tile<true>(bm1, bn1, feats, wi, bi, (bf16*)ifeat, scratch, rows, Dc, M,
                                    n_sm, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_tile<false>(bm2, bn2, scratch, wa, ba, (bf16*)iatt, nullptr, rows, M, F,
                                 n_sm, s);
}
