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
// Bound on the H100: one mixed add is a dependent chain of Montgomery
// products (10 on G1, 28 on G2) in one thread, so the level costs its c
// serial adds, not its work or its bytes (176 MB of local rows on G1 are
// 0.05 ms at 3.35 TB/s). The host therefore shapes the level
// (msm/prefix_pipeline.py stream_shape): with K4's scan over the n_ch lane
// tails as the level above it, it picks the c of least c +
// scan_depth(n_ch) with the n_ch lanes in one wave of this kernel, 132 SMs
// x 2 resident blocks of THREADS (K4's wave, msm/scan.py FOLD_WAVE). At the
// CHES stream (917,504 elements) that is c = 28 columns over 32,768 lanes,
// 256 blocks, in place of 112 over 8,192 (64 blocks on 132 SMs).
// __launch_bounds__ asks the compiler for two resident blocks an SM, and
// msm_affine_prefix_occupancy lets a run check it on the card. A lane's
// run is private to its thread, so shared memory, TMA and the tensor cores
// have nothing to carry; the column loads and row stores of neighbouring
// lanes are neighbouring rows, so each warp's accesses coalesce.

#pragma once

#include "fp.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace msm {
namespace scan {

constexpr int THREADS = 128;
constexpr int MIN_BLOCKS = 2;  // resident blocks an SM: K4's wave

// K3's mixed add, by field: inlined on G1, one out-of-line body on G2 (as
// K4's block_scan.cuh add). Both forms were built and timed on both curves
// on the H100 (scripts/scan_timing.py, the two in turns): inlined, G1's
// level runs about 6% faster than with a call; out of line, G2's drops
// from 255 registers with spills to 222 without and runs about 7% faster.
// fp.cuh's xyzz_dadd_affine stays inlined into K2, K5 and K9.
MSM_HD void add(XyzzT<Fp>& o, const XyzzT<Fp>& a, const AffT<Fp>& b,
                bool sub) {
  xyzz_dadd_affine(o, a, b, sub);
}

MSM_HD_NOINLINE void add(XyzzT<Fp2>& o, const XyzzT<Fp2>& a,
                         const AffT<Fp2>& b, bool sub) {
  xyzz_dadd_affine(o, a, b, sub);
}

// Lane k: the inclusive prefix of the signed affine stream down c columns.
// With W = Words<F>: rows_x/rows_y: (c, n_ch, W) words; signs: (c, n_ch);
// local: (c, n_ch, 4*W) rows X||Y||ZZZ||ZZ; tails: four [W, n_ch] batches.
template <class F>
MSM_HD void affine_prefix_lane(const uint32_t* rows_x, const uint32_t* rows_y,
                               const int32_t* signs, uint32_t* local,
                               XyzzColsOut tails, int c, int64_t n_ch,
                               int64_t k) {
  constexpr int W = Words<F>::value;
  XyzzT<F> run;
  for (int j = 0; j < c; ++j) {
    int64_t e = (int64_t)j * n_ch + k;
    AffT<F> pt;
    load_row(pt.x, rows_x + e * W);
    load_row(pt.y, rows_y + e * W);
    bool sub = signs[e] != 0;
    if (j == 0) {
      xyzz_from_affine(run, pt, sub);
    } else {
      add(run, run, pt, sub);
    }
    uint32_t* row = local + e * (4 * W);
    store_row(row, run.x);
    store_row(row + W, run.y);
    store_row(row + 2 * W, run.zzz);
    store_row(row + 3 * W, run.zz);
  }
  store_xyzz(tails, run, n_ch, k);
}

#ifdef __CUDACC__

template <class F>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    affine_prefix_kernel(const uint32_t* rows_x, const uint32_t* rows_y,
                         const int32_t* signs, uint32_t* local,
                         XyzzColsOut tails, int c, int64_t n_ch) {
  int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k < n_ch)
    affine_prefix_lane<F>(rows_x, rows_y, signs, local, tails, c, n_ch, k);
}

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

// The resident blocks an SM of the kernel as built, into blocks[0].
template <class F>
int occupancy(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, affine_prefix_kernel<F>, THREADS, 0);
}

#endif  // __CUDACC__

}  // namespace scan
}  // namespace msm
