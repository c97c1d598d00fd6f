// Counter-hash dropout masks on the device, shared by the training hop-loop
// kernels (rau_train_hops_fwd.cu, rau_train_hops_bwd.cu) and maskgen.cu.
//
// Device side of rau_vqa_tpu/ops/maskgen.py (:34-87) in native uint32_t
// arithmetic: the murmur3 fmix32 finalizer over an element's GLOBAL linear
// index, salted per (seed, hop, site).  The bits depend only on the global
// index, so any split of the batch over blocks gives the same masks, and the
// backward kernel regenerates the forward's masks instead of reading them.
// rau_vqa_tpu_torch/ops/maskgen.py computes the same bits in PyTorch.

#pragma once

#include <cstdint>

namespace maskgen {

__host__ __device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// site_salt (:45-50): the hop times the golden ratio, the site times the
// first fmix constant, both wrapping in 32 bits
__host__ __device__ __forceinline__ uint32_t site_salt(uint32_t seed, int hop,
                                                       int site) {
  const uint32_t h = (uint32_t)hop * 0x9E3779B9u;
  const uint32_t s = (uint32_t)(site + 1) * 0x85EBCA6Bu;
  return mix32(seed ^ h ^ s);
}

// counter_bits (:73): the product binds before the xor
__host__ __device__ __forceinline__ uint32_t counter_bits(uint32_t idx,
                                                          uint32_t salt) {
  return mix32((idx * 2654435761u) ^ salt);
}

// One site's mask for one hop: keep where bits >= thresh (:83-84).
struct Site {
  uint32_t salt, thresh;
  float scale;
  bool on;  // false when the rate is 0: the element passes unscaled
  __device__ __forceinline__ float operator()(uint32_t idx) const {
    return counter_bits(idx, salt) >= thresh ? scale : 0.f;
  }
  __device__ __forceinline__ float apply(float x, uint32_t idx) const {
    return on ? x * (*this)(idx) : x;
  }
};

// the three sites of the training hop loop (rau_train_hops.py:82)
enum { SITE_FEATS = 0, SITE_Q = 1, SITE_MERGE = 2 };

}  // namespace maskgen
