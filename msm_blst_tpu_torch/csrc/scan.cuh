// K3: the level kernel of the prefix-scan bucket pipeline, as a kernel
// template over the coordinate field (Fp for G1 in scan.cu, Fp2 for G2 in
// scan_g2.cu).
//
// K3 replaces msm_blst_tpu/msm/pallas_scan.py _affine_prefix_kernel
// (entered through affine_prefix_level): an inclusive prefix of a signed
// affine stream down c columns per lane, run += +-P with the mixed add,
// emitting every local prefix as a row and each lane's tail.
//
// On the TPU the grid walks the columns in order and carries the run in
// VMEM scratch. Blocks on Hopper run in no order, so each thread owns one
// lane and loops over the c columns with its run in registers: nothing
// carries between blocks.
//
// Bound on the H100: integer multiplies (the mixed add's Montgomery
// products; on G2 three per Fp2 product) and the serial dependence down a
// lane. The stream shape is kept from the JAX package so intermediates
// match it; at the CHES path's shape (c = 112, n_ch = 8192) that gives 8192
// threads, 64 blocks of 128 on 132 SMs, which leaves most of the card idle.
// Retuning the shape is later work.

#pragma once

#include <cuda_runtime.h>

#include "fp.cuh"

namespace msm {
namespace scan {

template <class F>
__global__ void affine_prefix_kernel(const uint32_t* rows_x,
                                     const uint32_t* rows_y,
                                     const int32_t* signs, uint32_t* local,
                                     XyzzColsOut tails, int c, int64_t n_ch) {
  int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k < n_ch)
    affine_prefix_lane<F>(rows_x, rows_y, signs, local, tails, c, n_ch, k);
}

constexpr int THREADS = 128;

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + THREADS - 1) / THREADS);
}

template <class F>
int affine_prefix_level(const void* rows_x, const void* rows_y,
                        const void* signs, void* local, void* tx, void* ty,
                        void* tzzz, void* tzz, int c, int64_t n_ch,
                        void* stream) {
  if (c > 0 && n_ch > 0) {
    XyzzColsOut tails = {(uint32_t*)tx, (uint32_t*)ty, (uint32_t*)tzzz,
                         (uint32_t*)tzz};
    affine_prefix_kernel<F><<<blocks_for(n_ch), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)rows_x, (const uint32_t*)rows_y, (const int32_t*)signs,
        (uint32_t*)local, tails, c, n_ch);
  }
  return (int)cudaGetLastError();
}

}  // namespace scan
}  // namespace msm
