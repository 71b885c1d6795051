// K9: the segmented xyzz fold, one pass per launch, as a kernel template
// over the coordinate field (Fp for G1 in fold.cu, Fp2 for G2 in
// fold_g2.cu).
//
// Replaces msm_blst_tpu/curves/pallas_point.py _kernel(curve, "dadd") as
// msm_blst_tpu/utils/scans.py fold calls it: the TPU fold reshapes a stream
// into c columns and adds them one after another, c - 1 launches of the
// formula kernel a level (lax.scan). On Hopper one such add is a dependent
// chain of 14 (G1) or 42 (G2) Montgomery products run by one thread, so a
// fold costs its serial depth times that latency. This kernel sums many
// segments at once with a depth of (k - 1) + log2(THREADS) adds a pass:
//
//  * a block of THREADS threads takes one tile of THREADS * k elements of
//    one segment, [start, end) of the pass's input stream (the host's tile
//    table, int64 pairs);
//  * serial stage: thread j adds elements start + j + i * THREADS, i = 0..k-1,
//    in order (coalesced loads in the column layout); past `end` there is
//    nothing to add, and a thread with no element holds infinity;
//  * tree stage: for s = THREADS/2 .. 1, thread j < s adds thread j + s's
//    sum to its own (xyzz_dadd(own, other)), the other sum passing through
//    shared memory, THREADS/2 points of it;
//  * thread 0 stores the tile's partial at the tile's index.
//
// The partials of a segment are contiguous and form that segment in the
// next pass; passes repeat on the host until each segment is one element.
// In the first pass the input may be read through an int64 index.
//
// Bound on the H100: the serial depth of the adds, not their number. The
// host picks k so that a pass's tiles about fill the card at two blocks of
// 128 an SM (255 registers a thread, as K2's dadd). The tree wastes half
// its threads at every level; it costs log2(THREADS) = 7 adds of depth.

#pragma once

#include "fp.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace msm {
namespace fold {

constexpr int THREADS = 128;
constexpr int HALF = THREADS / 2;

// Element `pos` of the pass's input (through `index` when it is given), or
// infinity at or past `end`.
template <class F>
MSM_HD void load_elem(XyzzT<F>& p, const XyzzCols& in, const int64_t* index,
                      int64_t n_in, int64_t pos, int64_t end) {
  if (pos < end) {
    load_xyzz(p, in, n_in, index ? index[pos] : pos);
  } else {
    xyzz_set_inf(p);
  }
}

// The serial stage of thread j in the tile [start, end).
template <class F>
MSM_HD void serial_stage(XyzzT<F>& acc, const XyzzCols& in,
                         const int64_t* index, int64_t n_in, int64_t start,
                         int64_t end, int j, int k) {
  load_elem(acc, in, index, n_in, start + j, end);
  for (int i = 1; i < k; ++i) {
    int64_t pos = start + j + (int64_t)i * THREADS;
    if (pos >= end) break;
    XyzzT<F> b;
    load_xyzz(b, in, n_in, index ? index[pos] : pos);
    xyzz_dadd(acc, acc, b);
  }
}

#ifdef __CUDACC__

// Shared memory of a block: HALF points in column layout, coordinate c's
// word w of point i at (c * Words<F> + w) * HALF + i; 12 KB on G1, 24 KB on
// G2, so no block needs more than the default 48 KB.
template <class F>
constexpr int shared_bytes() {
  return 4 * Words<F>::value * HALF * (int)sizeof(uint32_t);
}

template <class F>
__global__ void __launch_bounds__(THREADS)
    fold_kernel(XyzzCols in, const int64_t* index, const int64_t* tiles,
                XyzzColsOut out, int64_t n_in, int64_t n_tiles, int k) {
  extern __shared__ uint32_t sm[];
  constexpr int S = Words<F>::value * HALF;
  const XyzzColsOut put = {sm, sm + S, sm + 2 * S, sm + 3 * S};
  const XyzzCols get = {sm, sm + S, sm + 2 * S, sm + 3 * S};
  const int j = threadIdx.x;
  const int64_t t = blockIdx.x;
  XyzzT<F> acc;
  serial_stage<F>(acc, in, index, n_in, tiles[2 * t], tiles[2 * t + 1], j, k);
  // Every thread reaches every barrier: none returns early.
  for (int s = HALF; s >= 1; s >>= 1) {
    if (j >= s && j < 2 * s) store_xyzz(put, acc, HALF, j - s);
    __syncthreads();
    if (j < s) {
      XyzzT<F> b;
      load_xyzz(b, get, HALF, j);
      xyzz_dadd(acc, acc, b);
    }
    __syncthreads();
  }
  if (j == 0) store_xyzz(out, acc, n_tiles, t);
}

// One pass: n_tiles blocks over the input's n_in elements; `index` may be
// null. Launched on `stream`.
template <class F>
int fold_pass(const void* x, const void* y, const void* zzz, const void* zz,
              const void* index, const void* tiles, void* ox, void* oy,
              void* ozzz, void* ozz, int64_t n_in, int64_t n_tiles, int k,
              void* stream) {
  if (n_tiles > 0) {
    constexpr int bytes = shared_bytes<F>();
    static_assert(bytes <= 48 * 1024, "above the default shared memory limit");
    XyzzCols in = {(const uint32_t*)x, (const uint32_t*)y,
                   (const uint32_t*)zzz, (const uint32_t*)zz};
    XyzzColsOut out = {(uint32_t*)ox, (uint32_t*)oy, (uint32_t*)ozzz,
                       (uint32_t*)ozz};
    fold_kernel<F><<<(unsigned)n_tiles, THREADS, bytes, (cudaStream_t)stream>>>(
        in, (const int64_t*)index, (const int64_t*)tiles, out, n_in, n_tiles,
        k);
  }
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__

}  // namespace fold
}  // namespace msm
