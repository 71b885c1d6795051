// K5: the segmented bucket reduction, as kernel templates over the
// coordinate field (Fp for G1 in seg.cu, Fp2 for G2 in seg_g2.cu). Two
// parts, three C calls' worth of launches at most a reduction:
//
//  * the affine level (this file, level_kernel): one launch over the
//    key-sorted signed affine stream cut into n_ch lanes of c columns;
//  * the segmented block scan (seg_scan.cuh) over the 2 n_ch heads and
//    tails that level leaves: one launch, or three (up, carry, down).
//
// Replaces msm_blst_tpu/msm/pallas_scan.py _seg_kernel (entered through
// _run_level / segmented_reduce) and the XLA levels and two-element merge
// of msm_blst_tpu/msm/scan.py _segmented_reduce_xyzz that follow it. On the
// TPU the grid walks the columns in order with the run and head in VMEM
// scratch, writes every column's emission to a (c, 4, *lead, n_ch) output
// that a scatter drops into the buckets, and reduces the heads and tails by
// more such levels, about 32 columns each, until two elements are left.
//
// Level lane k walks its c columns with the run in registers. A key change
// closes the run: the run that touched column 0 becomes the lane's head,
// any other is complete and is stored straight into the bucket array at
// its key (keys >= n_buckets are pads or "no bucket" and are skipped). The
// head (infinity if the lane is one run, with that run's key) and the tail
// (the run open at the last column) go to elements 2k and 2k + 1 of the
// next stream, which is still key-sorted, so the scan reads it as it is.
// Real keys are unique across the two parts (msm_blst_tpu/msm/scan.py:7-17):
// every store is a plain store, with no atomics, into the array in place.
//
// Bound on the H100: an added affine element is a dependent chain of 10
// Montgomery products on G1 (dadd_affine) and 30 on G2, so a lane costs
// its c - 1 serial adds and the level its depth, not its work or bytes. The
// host therefore shapes the level (msm/cuda_scan.py seg_level_shape) as it
// shapes K3's: the c of least c + the scan's depth over the 2 n_ch heads
// and tails, with the n_ch lanes in one wave of this kernel (132 SMs x 2
// resident blocks of THREADS, K4's wave, msm/scan.py FOLD_WAVE). At BGMW's
// stream (983,040 digits) that is 30 columns over 32,768 lanes, 256 blocks,
// in place of the JAX package's 60 over 16,384 and its chain of xyzz
// levels; at a stock window's 65,536 digits 4 columns over 16,384 lanes.
// __launch_bounds__ asks for two resident blocks an SM, and
// msm_seg_occupancy lets a run check it on the card. The column loads of
// neighbouring lanes are neighbouring rows, so each warp's loads coalesce.

#pragma once

#include "fp.cuh"
#include "seg_scan.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace msm {
namespace seg {

// The level's mixed add, by field, in the form K3 measured faster on each
// curve (csrc/scan.cuh add): inlined on G1, one out-of-line body on G2.
MSM_HD void madd(XyzzT<Fp>& o, const XyzzT<Fp>& a, const AffT<Fp>& b,
                 bool sub) {
  xyzz_dadd_affine(o, a, b, sub);
}

MSM_HD_NOINLINE void madd(XyzzT<Fp2>& o, const XyzzT<Fp2>& a,
                          const AffT<Fp2>& b, bool sub) {
  xyzz_dadd_affine(o, a, b, sub);
}

// Element (j, k) of the level: row j * n_ch + k of rows_x / rows_y
// ((c, n_ch, W) words) and its sign.
template <class F>
MSM_HD bool load_elem(AffT<F>& p, const uint32_t* rows_x,
                      const uint32_t* rows_y, const int32_t* signs,
                      int64_t e) {
  load_row(p.x, rows_x + e * Words<F>::value);
  load_row(p.y, rows_y + e * Words<F>::value);
  return signs[e] != 0;
}

// Lane k of the level (msm_blst_tpu/msm/pallas_scan.py:149-234). keys and
// signs: (c, n_ch); buckets: four [W, n_buckets] batches, updated in place;
// out: four [W, 2 n_ch] batches and out_key (2 n_ch,): the lane's head at
// 2k, its tail at 2k + 1.
template <class F>
MSM_HD void level_lane(const uint32_t* rows_x, const uint32_t* rows_y,
                       const int32_t* signs, const int32_t* keys,
                       XyzzColsOut buckets, int64_t n_buckets,
                       XyzzColsOut out, int32_t* out_key, int c, int64_t n_ch,
                       int64_t k) {
  const int64_t n_out = 2 * n_ch;
  XyzzT<F> run;
  AffT<F> p;
  bool sub = load_elem(p, rows_x, rows_y, signs, k);
  xyzz_from_affine(run, p, sub);
  int32_t run_key = keys[k];
  bool from0 = true;
  for (int j = 1; j < c; ++j) {
    const int64_t e = (int64_t)j * n_ch + k;
    const int32_t ky = keys[e];
    sub = load_elem(p, rows_x, rows_y, signs, e);
    if (ky != run_key) {
      if (from0) {
        store_xyzz(out, run, n_out, 2 * k);
        out_key[2 * k] = run_key;
        from0 = false;
      } else if ((uint32_t)run_key < (uint64_t)n_buckets) {
        store_xyzz(buckets, run, n_buckets, run_key);
      }
      xyzz_from_affine(run, p, sub);
    } else {
      madd(run, run, p, sub);
    }
    run_key = ky;
  }
  if (from0) {  // one run down the whole lane: the head stays infinity
    XyzzT<F> inf;
    xyzz_set_inf(inf);
    store_xyzz(out, inf, n_out, 2 * k);
    out_key[2 * k] = run_key;
  }
  store_xyzz(out, run, n_out, 2 * k + 1);
  out_key[2 * k + 1] = run_key;
}

#ifdef __CUDACC__

template <class F>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    level_kernel(const uint32_t* rows_x, const uint32_t* rows_y,
                 const int32_t* signs, const int32_t* keys,
                 XyzzColsOut buckets, int64_t n_buckets, XyzzColsOut out,
                 int32_t* out_key, int c, int64_t n_ch) {
  int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k < n_ch)
    level_lane<F>(rows_x, rows_y, signs, keys, buckets, n_buckets, out,
                  out_key, c, n_ch, k);
}

inline XyzzColsOut cols_out(void* x, void* y, void* zzz, void* zz) {
  return {(uint32_t*)x, (uint32_t*)y, (uint32_t*)zzz, (uint32_t*)zz};
}

template <class F>
int seg_level_affine(const void* rows_x, const void* rows_y, const void* signs,
                     const void* keys, void* bx, void* by, void* bzzz,
                     void* bzz, int64_t n_buckets, void* ox, void* oy,
                     void* ozzz, void* ozz, void* out_key, int c, int64_t n_ch,
                     void* stream) {
  if (c > 0 && n_ch > 0) {
    level_kernel<F><<<(unsigned)((n_ch + THREADS - 1) / THREADS), THREADS, 0,
                      (cudaStream_t)stream>>>(
        (const uint32_t*)rows_x, (const uint32_t*)rows_y,
        (const int32_t*)signs, (const int32_t*)keys,
        cols_out(bx, by, bzzz, bzz), n_buckets, cols_out(ox, oy, ozzz, ozz),
        (int32_t*)out_key, c, n_ch);
  }
  return (int)cudaGetLastError();
}

// The resident blocks an SM of K5's kernels as built, into blocks[0..4]:
// the level, then the scan's one-block kernel over a stream, its up pass,
// its carry pass and its down pass.
template <class F>
int occupancy(int* blocks) {
  cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, level_kernel<F>, THREADS, 0);
  if (rc == cudaSuccess) rc = (cudaError_t)scan_occupancy<F>(blocks + 1);
  return (int)rc;
}

#endif  // __CUDACC__

}  // namespace seg
}  // namespace msm
