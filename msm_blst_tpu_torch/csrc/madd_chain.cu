// K7: chained elementwise multiply-adds, acc = acc * b + a, the multiply-add
// throughput probe of the measurement driver (drivers/microbench.py).
//
// Replaces drivers/microbench.py bench_vpu_mul (its Pallas kernel runs
// `chain` multiply-adds a step of a fori_loop of `iters` steps over a
// (256, 1024) block held on chip). Here one thread owns one element and
// runs the whole chain in registers: 16 dependent multiply-adds a step of
// a loop of `iters` steps, then one store, so the loop cannot be dropped.
// A warp's chain is serial; the card's many resident warps hide the
// latency, so the kernel is bound by the multiply-add issue rate: IMAD
// for the integer types, FFMA for float32.
//
// uint32 and int32 both compute in unsigned 32-bit arithmetic (the same
// IMAD; signed overflow would be undefined in C++), int32 storing the same
// bits. float32 is an explicit fused multiply-add (__fmaf_rn): one rounding
// a step, which the plain version reproduces.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHAIN = 16;

__device__ __forceinline__ uint32_t madd(uint32_t acc, uint32_t b, uint32_t a) {
  return acc * b + a;
}

__device__ __forceinline__ float madd(float acc, float b, float a) {
  return __fmaf_rn(acc, b, a);
}

template <class T>
__global__ void __launch_bounds__(THREADS)
    madd_chain_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      T* __restrict__ out, int64_t n, int64_t iters) {
  int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const T av = a[i], bv = b[i];
  T acc = av;
  for (int64_t it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CHAIN; ++c) acc = madd(acc, bv, av);
  }
  out[i] = acc;
}

template <class T>
int launch(const void* a, const void* b, void* out, int64_t n, int64_t iters,
           void* stream) {
  if (n > 0) {
    unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
    madd_chain_kernel<T><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const T*)a, (const T*)b, (T*)out, n, iters);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// `iters` steps of CHAIN multiply-adds each, over n elements.
extern "C" int msm_madd_chain_u32(const void* a, const void* b, void* out,
                                  int64_t n, int64_t iters, void* stream) {
  return launch<uint32_t>(a, b, out, n, iters, stream);
}

extern "C" int msm_madd_chain_i32(const void* a, const void* b, void* out,
                                  int64_t n, int64_t iters, void* stream) {
  return launch<uint32_t>(a, b, out, n, iters, stream);
}

extern "C" int msm_madd_chain_f32(const void* a, const void* b, void* out,
                                  int64_t n, int64_t iters, void* stream) {
  return launch<float>(a, b, out, n, iters, stream);
}
