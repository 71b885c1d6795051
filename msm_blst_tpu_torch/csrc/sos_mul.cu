// K6: batched SOS Montgomery multiply over BLS12-381's base field, with the
// reduction on the integer tensor cores.
//
// Replaces msm_blst_tpu/fields/pallas_mont.py sos_kernel
// (_mont_mul_body_sos): the TPU kernel computes the full product on its
// vector unit and the reduction's two products by constants as bf16
// byte-Toeplitz matmuls on its matrix unit. Here the full product runs per
// thread on 32-bit words (sos.cuh mul_wide), and the two Toeplitz products
// run as mma.sync m16n8k32 u8 x u8 -> s32, exact without the 2^24-mantissa
// argument, with the E and O rows of the JAX matrices fused into one
// matrix in byte order (drivers/mxu_experiment.py sos_wide); the warp's
// steps are in sos.cuh. The words equal K1's.
//
// Templated on the stage, so one source also serves the staged bodies of
// drivers/mxu_experiment.py `make`: PROD writes a*b mod R, BYTES the same
// value rebuilt from the staged B operand, MM1 m = a*b*P' mod R, FULL the
// Montgomery product.
//
// Bound on the H100: bytes, 3 * 48 an element, against the full product's
// 144 word products (two IMADs each) and 72 mmas a warp (9,216 u8 MACs an
// element, 6,912 without the k padding). mma.sync is warp-collective: the
// tail of the batch is computed as zeros by lanes that stay in the warp,
// and only their stores are masked.

#include <cuda_runtime.h>

#include "sos.cuh"

namespace {

using namespace msm::sos;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;

__device__ __forceinline__ void mma_u8(int32_t* d, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The warp's B operand (sB) times `tiles` m16 tiles of sA from row `row0`:
// each lane stores its accumulators into sD, a column per element, rows
// 0 .. 16 * tiles - 1. The B fragments of all four n8 tiles stay in
// registers, and each A fragment is loaded once for all of them.
template <int TILES>
__device__ __forceinline__ void warp_product(int32_t* sD, const uint32_t* sA,
                                             const uint32_t* sB, int row0,
                                             int lane) {
  constexpr int KS = KB / 32;
  uint32_t b[4][KS][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) frag_b(b[nt][ks], sB, 8 * nt, ks, lane);
  }
#pragma unroll
  for (int mt = 0; mt < TILES; ++mt) {
    uint32_t a[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) frag_a(a[ks], sA, row0 + 16 * mt, ks, lane);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      int32_t acc[4] = {};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) mma_u8(acc, a[ks], b[nt][ks]);
      store_d(sD, acc, 16 * mt, 8 * nt, lane);
    }
  }
}

template <int STAGE>
__global__ void __launch_bounds__(THREADS)
    sos_mul_kernel(const uint32_t* __restrict__ a,
                   const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                   const uint32_t* __restrict__ toeplitz, int64_t n) {
  __shared__ uint32_t sA[(M1 + M2) * APITCH];
  __shared__ uint32_t sB_all[WARPS][32 * BPITCH];
  __shared__ int32_t sD_all[WARPS][32 * DPITCH];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const bool valid = i < n;

  if (STAGE != PROD) {
    for (int k = threadIdx.x; k < (M1 + M2) * KW; k += THREADS)
      sA[(k / KW) * APITCH + k % KW] = toeplitz[k];
  }
  uint32_t x[msm::NW], y[msm::NW], t[2 * msm::NW];
#pragma unroll
  for (int k = 0; k < msm::NW; ++k) {
    x[k] = valid ? a[k * n + i] : 0u;
    y[k] = valid ? b[k * n + i] : 0u;
  }
  mul_wide<msm::NW>(t, x, y);
  if (STAGE == PROD) {
    if (valid) {
#pragma unroll
      for (int k = 0; k < msm::NW; ++k) out[k * n + i] = t[k];
    }
    return;
  }
  __syncthreads();  // sA is loaded

  uint32_t* sB = sB_all[warp];
  int32_t* sD = sD_all[warp];
  uint32_t* col = sB + lane * BPITCH;
#pragma unroll
  for (int k = 0; k < KW; ++k) col[k] = k < msm::NW ? t[k] : 0u;
  __syncwarp();

  if (STAGE == BYTES) {
    // every B fragment the first product loads, put back in element order
#pragma unroll
    for (int n0 = 0; n0 < 32; n0 += 8) {
#pragma unroll
      for (int ks = 0; ks < KB / 32; ++ks) {
        uint32_t f[2];
        frag_b(f, sB, n0, ks, lane);
        uint32_t* dst = (uint32_t*)sD + (n0 + (lane >> 2)) * DPITCH + ks * 8 +
                        (lane & 3);
        dst[0] = f[0];
        dst[4] = f[1];
      }
    }
    __syncwarp();
    if (valid) {
#pragma unroll
      for (int k = 0; k < msm::NW; ++k)
        out[k * n + i] = ((const uint32_t*)sD)[lane * DPITCH + k];
    }
    return;
  }

  // m = (T mod R) * P' mod R
  warp_product<M1 / 16>(sD, sA, sB, 0, lane);
  __syncwarp();
  uint32_t m[msm::NW] = {};
  uint64_t carry = 0;
  add_positions(m, sD + lane * DPITCH, carry);  // the carry out is >= R: dropped
  if (STAGE == MM1) {
    if (valid) {
#pragma unroll
      for (int k = 0; k < msm::NW; ++k) out[k * n + i] = m[k];
    }
    return;
  }
  __syncwarp();  // every lane has read its sums and its last B fragment
#pragma unroll
  for (int k = 0; k < msm::NW; ++k) col[k] = m[k];
  __syncwarp();

  // T + m p, 48 byte positions at a time; the low half ends at zero
  carry = 0;
#pragma unroll
  for (int h = 0; h < M2 / HALF; ++h) {
    warp_product<HALF / 16>(sD, sA, sB, M1 + h * HALF, lane);
    __syncwarp();
    add_positions(t + h * msm::NW, sD + lane * DPITCH, carry);
    __syncwarp();
  }
  uint32_t r[msm::NW];
  msm::reduce_once<msm::NW>(r, t + msm::NW);  // (T + m p) / R < 2p
  if (valid) {
#pragma unroll
    for (int k = 0; k < msm::NW; ++k) out[k * n + i] = r[k];
  }
}

template <int STAGE>
int launch(const void* a, const void* b, void* out, const void* toeplitz,
           int64_t n, void* stream) {
  if (n > 0) {
    unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
    sos_mul_kernel<STAGE><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out,
        (const uint32_t*)toeplitz, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int msm_sos_mul(const void* a, const void* b, void* out,
                           const void* toeplitz, int64_t n, void* stream) {
  return launch<FULL>(a, b, out, toeplitz, n, stream);
}

extern "C" int msm_sos_mul_prod(const void* a, const void* b, void* out,
                                const void* toeplitz, int64_t n,
                                void* stream) {
  return launch<PROD>(a, b, out, toeplitz, n, stream);
}

extern "C" int msm_sos_mul_bytes(const void* a, const void* b, void* out,
                                 const void* toeplitz, int64_t n,
                                 void* stream) {
  return launch<BYTES>(a, b, out, toeplitz, n, stream);
}

extern "C" int msm_sos_mul_mm1(const void* a, const void* b, void* out,
                               const void* toeplitz, int64_t n, void* stream) {
  return launch<MM1>(a, b, out, toeplitz, n, stream);
}
