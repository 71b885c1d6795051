// K1: batched Montgomery multiply over BLS12-381's base field.
//
// Replaces msm_blst_tpu/fields/pallas_mont.py make_mont_mul (cios_kernel,
// _mont_mul_body): the TPU kernel runs 24 rounds of 16-bit-limb CIOS with
// deferred carries and a Kogge-Stone resolve, because the TPU's vector unit
// has no 32x32->64 multiply. Hopper has one, so this kernel runs CIOS over
// twelve 32-bit words with 64-bit partial sums (fp.cuh fp_mul). The residues
// are the same numbers: R = 2^384 in both.
//
// Bound on the H100: integer multiply throughput, 2 * 144 32-bit partial
// products per element against 24 bytes * 3 of memory traffic. One thread
// per element keeps the whole product in registers; the [12, B] column
// layout makes every word load and store coalesced across a warp.

#include <cuda_runtime.h>

#include "fp.cuh"

namespace {

// Templated on the word count: the 12-word base field is instantiated; the
// 8-word scalar field needs only its msm::Modulus<8> specialisation.
template <int N>
__global__ void mont_mul_kernel(const uint32_t* __restrict__ a,
                                const uint32_t* __restrict__ b,
                                uint32_t* __restrict__ out, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) msm::mont_mul_elem<N>(a, b, out, n, i);
}

constexpr int THREADS = 128;

}  // namespace

extern "C" int msm_mont_mul(const void* a, const void* b, void* out, int64_t n,
                            void* stream) {
  if (n > 0) {
    unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
    mont_mul_kernel<msm::NW><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}
