// K5: one level of the segmented bucket reduction, as kernel templates over
// the coordinate field (Fp for G1 in seg.cu, Fp2 for G2 in seg_g2.cu).
//
// Replaces msm_blst_tpu/msm/pallas_scan.py _seg_kernel (entered through
// _run_level / segmented_reduce). Down the c columns of each lane of a
// key-sorted stream it carries a running xyzz sum and three keys (run key,
// head key, from0); a key change closes the run, which becomes the lane's
// head if it touched column 0 and is otherwise complete. The affine variant
// lifts and adds signed affine points (dadd_affine), the xyzz variant xyzz
// points (dadd); both take the full case analysis, so a bucket holding
// equal or opposite points doubles or cancels.
//
// On the TPU the grid walks the columns in order with the run and head in
// VMEM scratch, and the kernel writes every column's emission to a
// (c, 4, *lead, n_ch) output that a scatter then drops into the buckets.
// Here one thread owns one lane and loops over the columns with the run in
// registers (fp.cuh seg_level_lane), and a complete run is stored straight
// into the bucket array at its key. Real emission keys are unique within a
// level and across levels (msm_blst_tpu/msm/scan.py:7-17), so these are
// plain stores with no atomics; the bucket array is updated in place.
//
// Bound on the H100: integer multiply-adds. An added affine element costs
// 10 Montgomery products on G1 (dadd_affine) and 30 on G2, an added xyzz
// element 14 and 42 (dadd), a lifted one none; the doubling branch runs
// only in lanes that double, and each lane is a serial chain of c such
// steps. Memory per element: a row (96 B on G1, 192 B on G2) or xyzz
// coordinates (192 B, 384 B), the sign and the key; at most one xyzz point
// written per emission. At BGMW's first level (c = 60, n_ch = 16,384) the
// 16,384 lanes give 128 blocks of 128 threads on 132 SMs; stock's 2,048
// lanes leave most of the card idle. Retuning the shape is later work.

#pragma once

#include <cuda_runtime.h>

#include "fp.cuh"

namespace msm {
namespace seg {

template <class F>
__global__ void seg_level_affine_kernel(const uint32_t* rows_x,
                                        const uint32_t* rows_y,
                                        const int32_t* signs,
                                        const int32_t* keys, XyzzColsOut buckets,
                                        int64_t n_buckets, XyzzColsOut head,
                                        XyzzColsOut tail, int32_t* head_key,
                                        int32_t* tail_key, int c, int64_t n_ch) {
  int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k < n_ch)
    seg_level_affine_lane<F>(rows_x, rows_y, signs, keys, buckets, n_buckets,
                             head, tail, head_key, tail_key, c, n_ch, k);
}

template <class F>
__global__ void seg_level_xyzz_kernel(XyzzCols in, const int32_t* keys,
                                      XyzzColsOut buckets, int64_t n_buckets,
                                      XyzzColsOut head, XyzzColsOut tail,
                                      int32_t* head_key, int32_t* tail_key,
                                      int c, int64_t n_ch) {
  int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k < n_ch)
    seg_level_xyzz_lane<F>(in, keys, buckets, n_buckets, head, tail, head_key,
                           tail_key, c, n_ch, k);
}

constexpr int THREADS = 128;

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + THREADS - 1) / THREADS);
}

inline XyzzColsOut cols_out(void* x, void* y, void* zzz, void* zz) {
  return {(uint32_t*)x, (uint32_t*)y, (uint32_t*)zzz, (uint32_t*)zz};
}

template <class F>
int seg_level_affine(const void* rows_x, const void* rows_y, const void* signs,
                     const void* keys, void* bx, void* by, void* bzzz,
                     void* bzz, int64_t n_buckets, void* hx, void* hy,
                     void* hzzz, void* hzz, void* tx, void* ty, void* tzzz,
                     void* tzz, void* head_key, void* tail_key, int c,
                     int64_t n_ch, void* stream) {
  if (c > 0 && n_ch > 0) {
    seg_level_affine_kernel<F>
        <<<blocks_for(n_ch), THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)rows_x, (const uint32_t*)rows_y,
            (const int32_t*)signs, (const int32_t*)keys,
            cols_out(bx, by, bzzz, bzz), n_buckets, cols_out(hx, hy, hzzz, hzz),
            cols_out(tx, ty, tzzz, tzz), (int32_t*)head_key,
            (int32_t*)tail_key, c, n_ch);
  }
  return (int)cudaGetLastError();
}

template <class F>
int seg_level_xyzz(const void* x, const void* y, const void* zzz,
                   const void* zz, const void* keys, void* bx, void* by,
                   void* bzzz, void* bzz, int64_t n_buckets, void* hx, void* hy,
                   void* hzzz, void* hzz, void* tx, void* ty, void* tzzz,
                   void* tzz, void* head_key, void* tail_key, int c,
                   int64_t n_ch, void* stream) {
  if (c > 0 && n_ch > 0) {
    XyzzCols in = {(const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)zzz,
                   (const uint32_t*)zz};
    seg_level_xyzz_kernel<F>
        <<<blocks_for(n_ch), THREADS, 0, (cudaStream_t)stream>>>(
            in, (const int32_t*)keys, cols_out(bx, by, bzzz, bzz), n_buckets,
            cols_out(hx, hy, hzzz, hzz), cols_out(tx, ty, tzzz, tzz),
            (int32_t*)head_key, (int32_t*)tail_key, c, n_ch);
  }
  return (int)cudaGetLastError();
}

}  // namespace seg
}  // namespace msm
