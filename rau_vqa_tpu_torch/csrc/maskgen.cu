// Writes one dropout scale mask with the device hash of maskgen.cuh.
//
// Replaces: nothing on its own.  rau_vqa_tpu/ops/maskgen.py (:34-87) has no
// pallas_call; its hash runs inside the two training hop-loop kernels, which
// include maskgen.cuh.  This entry exists so that the device hash can be held
// against the plain version (ops/maskgen.py dropout_scale_mask) bit for bit.
//
// What bounds it on an H100: bytes, one float32 written per element.  One
// thread per element, grid-stride loop; nothing is kept on chip.

#include <cuda_runtime.h>

#include "maskgen.cuh"

namespace {

__global__ void dropout_mask_kernel(float* __restrict__ out,
                                    const int* __restrict__ seed, int hop,
                                    int site, long long n, int row_len,
                                    int row_offset, uint32_t thresh,
                                    float scale) {
  const uint32_t salt = maskgen::site_salt((uint32_t)seed[0], hop, site);
  const maskgen::Site m{salt, thresh, scale, true};
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const uint32_t row = (uint32_t)(i / row_len) + (uint32_t)row_offset;
    const uint32_t idx = row * (uint32_t)row_len + (uint32_t)(i % row_len);
    out[i] = m(idx);
  }
}

}  // namespace

// out [rows, row_len] float32; seed: one int32 on the device.  Element
// (r, j) gets the mask of global index (r + row_offset) * row_len + j.
// Returns cudaGetLastError().
extern "C" int dropout_mask_launch(void* out, const void* seed, int hop,
                                   int site, int rows, int row_len,
                                   int row_offset, uint32_t thresh, float scale,
                                   void* stream) {
  if (rows <= 0 || row_len <= 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)rows * row_len;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  dropout_mask_kernel<<<(int)(blocks < 4096 ? blocks : 4096), threads, 0,
                        (cudaStream_t)stream>>>(
      (float*)out, (const int*)seed, hop, site, n, row_len, row_offset, thresh,
      scale);
  return (int)cudaGetLastError();
}
