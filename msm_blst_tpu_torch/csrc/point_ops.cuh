// K2: the fused xyzz point formulas, one launch per batched op, as kernel
// templates over the coordinate field (Fp for G1 in point_ops.cu, Fp2 for G2
// in point_ops_g2.cu).
//
// Replaces msm_blst_tpu/curves/pallas_point.py _kernel(curve, op): the TPU
// kernel traces the whole branch-free formula of curves/ops.py into one
// pallas_call so the multiplies and the case analysis stay in VMEM.
// Here one thread owns one lane and runs the formula (fp.cuh) in registers:
// dadd_affine (signed madd-2008-s), dadd (add-2008-s), double (dbl-2008-s-1),
// with the infinity, P == Q and P == -Q cases chosen per thread.
//
// Bound on the H100: integer multiplies (G1: 12 to 21 Montgomery products
// per lane; G2: three per Fp2 product) and register pressure from the live
// field temporaries, which spill to local memory (a G2 xyzz point alone is
// 96 words). Coordinates stay in the column layout ([12, B] words, [2, 12,
// B] for G2) so the loads and stores are coalesced.

#pragma once

#include <cuda_runtime.h>

#include "fp.cuh"

namespace msm {
namespace point_ops {

template <class F>
__global__ void dadd_affine_kernel(XyzzCols p1, const uint32_t* x2,
                                   const uint32_t* y2, const int32_t* sign,
                                   XyzzColsOut o, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) dadd_affine_elem<F>(p1, x2, y2, sign, o, n, i);
}

template <class F>
__global__ void dadd_kernel(XyzzCols p1, XyzzCols p2, XyzzColsOut o, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) dadd_elem<F>(p1, p2, o, n, i);
}

template <class F>
__global__ void double_kernel(XyzzCols p1, XyzzColsOut o, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) double_elem<F>(p1, o, n, i);
}

constexpr int THREADS = 128;

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + THREADS - 1) / THREADS);
}

inline XyzzCols cols(const void* x, const void* y, const void* zzz,
                     const void* zz) {
  return {(const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)zzz,
          (const uint32_t*)zz};
}

inline XyzzColsOut cols_out(void* x, void* y, void* zzz, void* zz) {
  return {(uint32_t*)x, (uint32_t*)y, (uint32_t*)zzz, (uint32_t*)zz};
}

template <class F>
int dadd_affine(const void* x1, const void* y1, const void* zzz1,
                const void* zz1, const void* x2, const void* y2,
                const void* sign, void* ox, void* oy, void* ozzz, void* ozz,
                int64_t n, void* stream) {
  if (n > 0) {
    dadd_affine_kernel<F><<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        cols(x1, y1, zzz1, zz1), (const uint32_t*)x2, (const uint32_t*)y2,
        (const int32_t*)sign, cols_out(ox, oy, ozzz, ozz), n);
  }
  return (int)cudaGetLastError();
}

template <class F>
int dadd(const void* x1, const void* y1, const void* zzz1, const void* zz1,
         const void* x2, const void* y2, const void* zzz2, const void* zz2,
         void* ox, void* oy, void* ozzz, void* ozz, int64_t n, void* stream) {
  if (n > 0) {
    dadd_kernel<F><<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        cols(x1, y1, zzz1, zz1), cols(x2, y2, zzz2, zz2),
        cols_out(ox, oy, ozzz, ozz), n);
  }
  return (int)cudaGetLastError();
}

template <class F>
int dbl(const void* x1, const void* y1, const void* zzz1, const void* zz1,
        void* ox, void* oy, void* ozzz, void* ozz, int64_t n, void* stream) {
  if (n > 0) {
    double_kernel<F><<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        cols(x1, y1, zzz1, zz1), cols_out(ox, oy, ozzz, ozz), n);
  }
  return (int)cudaGetLastError();
}

}  // namespace point_ops
}  // namespace msm
