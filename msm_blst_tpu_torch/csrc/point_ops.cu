// K2: the fused G1 xyzz point formulas, one launch per batched op.
//
// Replaces msm_blst_tpu/curves/pallas_point.py _kernel(curve, op): the TPU
// kernel traces the whole branch-free formula of curves/ops.py into one
// pallas_call so the ~17 multiplies and the case analysis stay in VMEM.
// Here one thread owns one lane and runs the formula (fp.cuh) in registers:
// dadd_affine (signed madd-2008-s), dadd (add-2008-s), double (dbl-2008-s-1),
// with the infinity, P == Q and P == -Q cases chosen per thread.
//
// Bound on the H100: integer multiplies (12 to 21 Montgomery products per
// lane) and register pressure from the live field temporaries, which can
// spill to local memory. Coordinates stay in the [12, B] column layout so
// the loads and stores are coalesced.

#include <cuda_runtime.h>

#include "fp.cuh"

namespace {

using msm::XyzzCols;
using msm::XyzzColsOut;

__global__ void dadd_affine_kernel(XyzzCols p1, const uint32_t* x2,
                                   const uint32_t* y2, const int32_t* sign,
                                   XyzzColsOut o, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) msm::dadd_affine_elem(p1, x2, y2, sign, o, n, i);
}

__global__ void dadd_kernel(XyzzCols p1, XyzzCols p2, XyzzColsOut o, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) msm::dadd_elem(p1, p2, o, n, i);
}

__global__ void double_kernel(XyzzCols p1, XyzzColsOut o, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) msm::double_elem(p1, o, n, i);
}

constexpr int THREADS = 128;

unsigned blocks_for(int64_t n) { return (unsigned)((n + THREADS - 1) / THREADS); }

XyzzCols cols(const void* x, const void* y, const void* zzz, const void* zz) {
  return {(const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)zzz,
          (const uint32_t*)zz};
}

XyzzColsOut cols_out(void* x, void* y, void* zzz, void* zz) {
  return {(uint32_t*)x, (uint32_t*)y, (uint32_t*)zzz, (uint32_t*)zz};
}

}  // namespace

extern "C" int msm_xyzz_dadd_affine(const void* x1, const void* y1,
                                    const void* zzz1, const void* zz1,
                                    const void* x2, const void* y2,
                                    const void* sign, void* ox, void* oy,
                                    void* ozzz, void* ozz, int64_t n,
                                    void* stream) {
  if (n > 0) {
    dadd_affine_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        cols(x1, y1, zzz1, zz1), (const uint32_t*)x2, (const uint32_t*)y2,
        (const int32_t*)sign, cols_out(ox, oy, ozzz, ozz), n);
  }
  return (int)cudaGetLastError();
}

extern "C" int msm_xyzz_dadd(const void* x1, const void* y1, const void* zzz1,
                             const void* zz1, const void* x2, const void* y2,
                             const void* zzz2, const void* zz2, void* ox,
                             void* oy, void* ozzz, void* ozz, int64_t n,
                             void* stream) {
  if (n > 0) {
    dadd_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        cols(x1, y1, zzz1, zz1), cols(x2, y2, zzz2, zz2),
        cols_out(ox, oy, ozzz, ozz), n);
  }
  return (int)cudaGetLastError();
}

extern "C" int msm_xyzz_double(const void* x1, const void* y1, const void* zzz1,
                               const void* zz1, void* ox, void* oy, void* ozzz,
                               void* ozz, int64_t n, void* stream) {
  if (n > 0) {
    double_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        cols(x1, y1, zzz1, zz1), cols_out(ox, oy, ozzz, ozz), n);
  }
  return (int)cudaGetLastError();
}
