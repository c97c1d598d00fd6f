// Probe builds of the identity-stage kernel for bench_torch_stage.py: the
// library's kernel (fused_resnet.cu, included whole) instantiated with a
// probe in place of NoProbe.  No path of the port loads this library.
//
//   fused_identity_stage_no_loads         the producer issues no TMA, so the
//                                         products and their synchronisation
//                                         run alone on stale shared memory
//                                         (the output is garbage);
//   fused_identity_stage_cycles           thread 0 of the first and of the
//                                         middle CTA of block 0 prints the
//                                         cycles of the reduce, the 3x3 and
//                                         the expand, and the cycles it
//                                         waited on full slots;
//   fused_identity_stage_cycles_no_loads  both.
//
// Each takes fused_identity_stage_launch's arguments; a float32 call runs
// the library's float32 kernel.  bench_torch_stage.py rebuilds this library
// on every run: ops/_build.py's staleness check does not follow the include.

#include <cstdio>

#include "fused_resnet.cu"

namespace {

__device__ __forceinline__ long long cycles() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t));
  return t;
}

struct NoLoads : NoProbe {
  static constexpr bool LOADS = false;
};

template <bool Loads>
struct Cycles {
  static constexpr bool LOADS = Loads;
  long long start, waited = 0, at[3] = {0, 0, 0};
  __device__ Cycles() : start(cycles()) {}
  template <class F>
  __device__ __forceinline__ void wait(F f) {
    const long long t0 = cycles();
    f();
    waited += cycles() - t0;
  }
  __device__ __forceinline__ void mark(int phase) { at[phase] = cycles(); }
  __device__ __forceinline__ void report(int slabs, int n) {
    if (threadIdx.x == 0 && n == 0 && (blockIdx.x == 0 || blockIdx.x == gridDim.x / 2))
      printf("profile cta %d slabs %d: reduce %lld 3x3 %lld expand %lld cycles, "
             "waiting on full %lld\n",
             blockIdx.x, slabs, at[0] - start, at[1] - at[0], at[2] - at[1], waited);
  }
};

}  // namespace

#define PROBE_ENTRY(NAME, PROBE)                                                           \
  extern "C" int NAME(const void* x, void* out, void* scratch, const void* w1,            \
                      const void* b1, const void* w2, const void* b2, const void* w3,     \
                      const void* b3, int B, int H, int W, int C, int Cw, int N,          \
                      int is_bf16, int th, int tw, int nb, int ring, void* stream) {      \
    return stage_launch<PROBE>(x, out, scratch, w1, b1, w2, b2, w3, b3, B, H, W, C, Cw, N, \
                               is_bf16, th, tw, nb, ring, stream);                        \
  }

PROBE_ENTRY(fused_identity_stage_no_loads, NoLoads)
PROBE_ENTRY(fused_identity_stage_cycles, Cycles<true>)
PROBE_ENTRY(fused_identity_stage_cycles_no_loads, Cycles<false>)
