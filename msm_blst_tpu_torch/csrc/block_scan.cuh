// The block scan: the inclusive prefix sums of a 1-D xyzz stream, as kernel
// templates over the coordinate field (Fp for G1 in block_scan.cu, Fp2 for
// G2 in block_scan_g2.cu).
//
// Replaces msm_blst_tpu/msm/pallas_scan.py _scan_kernel (entered through
// prefix_scan_xyzz) together with what the TPU runs around it: the chunk
// tails' scan (utils/scans.py prefix_scan, one formula launch a column) and
// the carry combine. The TPU walks the columns of each lane in grid order.
// On Hopper one xyzz add is a dependent chain of 14 (G1) or 42 (G2)
// Montgomery products in one thread, so a scan costs its serial depth in
// adds, not its work. This one keeps the depth to a few dozen adds for any
// stream up to one wave of tiles:
//
//  * tile t (a block of THREADS threads) covers the elements
//    [t * THREADS * k, (t + 1) * THREADS * k); thread j owns the k
//    consecutive elements from (t * THREADS + j) * k; past n, infinity;
//  * up (tile_up_kernel): thread j sums its k elements in order; then a
//    Kogge-Stone inclusive scan of the THREADS sums through shared memory,
//    log2(THREADS) = 7 levels: at distance d = 1, 2, .., THREADS/2 thread
//    j >= d adds thread j - d's sum in front of its own. Each thread's
//    within-tile prefix and each tile's total go to the scratch;
//  * carry (tile_scan_kernel over the n_tiles totals, one block, k_carry
//    totals a thread): the inclusive prefixes of the tile totals;
//  * down (tile_down_kernel): thread j's offset is the carry of the tiles
//    before t plus the prefix of the threads before j in its tile (one
//    add); it then adds its k elements in order and stores each sum.
//
// A stream that one tile holds takes one launch, tile_scan_kernel: the up
// step, then the down step from the neighbouring thread's prefix, read from
// shared memory behind a barrier. Depth in adds: (k - 1) + 7 + k for one
// tile; (k - 1) + 7 + [(k_carry - 1) + 7 + k_carry] + 1 + k for more.
// A decoupled look-back would chain the tiles' prefixes one add apart; the
// host instead keeps the tiles within one wave (msm/scan.py scan_schedule:
// 132 SMs x 2 blocks of 128 at 255 registers) and picks k for the least
// depth, so the carry pass is one block.
//
// Every add is xyzz_dadd with the full case analysis (P + P doubles, P - P
// is infinity, an infinite operand yields the other), the earlier sum its
// first operand. Every thread of a block with barriers reaches each one.

#pragma once

#include "fp.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace msm {
namespace block_scan {

constexpr int THREADS = 128;

// One out-of-line body of the add for the source's three kernels. Inlined at
// all seven call sites, the G1 source took 157 s to build on the H100's
// host; this way the whole library builds in about 63 s, and K4 runs within
// 2.5% of the inlined kernels on G1 and 8-12% faster on G2 (fewer registers
// and spills).
template <class F>
MSM_HD_NOINLINE void add(XyzzT<F>& o, const XyzzT<F>& a, const XyzzT<F>& b) {
  xyzz_dadd(o, a, b);
}

// The sum of the elements first .. first + k - 1 that lie before n, in order.
template <class F>
MSM_HD void thread_sum(XyzzT<F>& acc, const XyzzCols& in, int64_t n,
                       int64_t first, int k) {
  if (first < n) {
    load_xyzz(acc, in, n, first);
  } else {
    xyzz_set_inf(acc);
  }
  for (int e = 1; e < k; ++e) {
    if (first + e >= n) break;
    XyzzT<F> b;
    load_xyzz(b, in, n, first + e);
    add(acc, acc, b);
  }
}

// For e = 0 .. k - 1 while first + e < n: run += element first + e, stored
// as that element's inclusive sum.
template <class F>
MSM_HD void emit(XyzzT<F>& run, const XyzzCols& in, const XyzzColsOut& out,
                 int64_t n, int64_t first, int k) {
  for (int e = 0; e < k; ++e) {
    if (first + e >= n) break;
    XyzzT<F> b;
    load_xyzz(b, in, n, first + e);
    add(run, run, b);
    store_xyzz(out, run, n, first + e);
  }
}

// The down step's offset of thread j in tile t: the inclusive sum of the
// tiles before t (carry t - 1) plus the prefix of the threads before j in
// the tile (partial t * THREADS + j - 1); infinity for thread 0 of tile 0.
template <class F>
MSM_HD void down_offset(XyzzT<F>& off, const XyzzCols& part,
                        const XyzzCols& carry, int64_t n_tiles, int64_t t,
                        int j) {
  if (t > 0) {
    load_xyzz(off, carry, n_tiles, t - 1);
  } else {
    xyzz_set_inf(off);
  }
  if (j > 0) {
    XyzzT<F> p;
    load_xyzz(p, part, n_tiles * THREADS, t * THREADS + j - 1);
    if (t > 0) {
      add(off, off, p);
    } else {
      off = p;
    }
  }
}

MSM_HD XyzzCols reading(const XyzzColsOut& c) {
  return {c.x, c.y, c.zzz, c.zz};
}

// The scratch of a scan over n_tiles tiles, one buffer of
// 4 * W * (n_tiles * (THREADS + 2)) words: the threads' within-tile prefixes
// (four [W, n_tiles * THREADS] batches), the tile totals and their inclusive
// prefixes (four [W, n_tiles] batches each).
struct Scratch {
  XyzzColsOut part, tot, carry;
};

template <class F>
MSM_HD Scratch scratch_layout(uint32_t* s, int64_t n_tiles) {
  const int64_t P = (int64_t)Words<F>::value * n_tiles * THREADS;
  const int64_t Q = (int64_t)Words<F>::value * n_tiles;
  uint32_t* u = s + 4 * P;
  uint32_t* v = u + 4 * Q;
  return {{s, s + P, s + 2 * P, s + 3 * P},
          {u, u + Q, u + 2 * Q, u + 3 * Q},
          {v, v + Q, v + 2 * Q, v + 3 * Q}};
}

#ifdef __CUDACC__

// Shared memory of a block: THREADS points in column layout, coordinate c's
// word w of thread i at (c * Words<F> + w) * THREADS + i; 24 KB on G1, 48 KB
// (the default limit) on G2.
template <class F>
constexpr int shared_bytes() {
  return 4 * Words<F>::value * THREADS * (int)sizeof(uint32_t);
}

template <class F>
struct Shared {
  XyzzColsOut put;
  XyzzCols get;

  __device__ explicit Shared(uint32_t* sm) {
    constexpr int S = Words<F>::value * THREADS;
    put = {sm, sm + S, sm + 2 * S, sm + 3 * S};
    get = reading(put);
  }
};

// Kogge-Stone: acc (thread j's value) becomes the sum of threads 0..j's.
template <class F>
__device__ void block_inclusive(XyzzT<F>& acc, const Shared<F>& sh, int j) {
  for (int d = 1; d < THREADS; d <<= 1) {
    store_xyzz(sh.put, acc, THREADS, j);
    __syncthreads();
    if (j >= d) {
      XyzzT<F> b;
      load_xyzz(b, sh.get, THREADS, j - d);
      add(acc, b, acc);
    }
    __syncthreads();
  }
}

// One block scans a whole stream of n <= THREADS * k elements: the up step,
// then the down step from thread j - 1's inclusive sum.
template <class F>
__global__ void __launch_bounds__(THREADS)
    tile_scan_kernel(XyzzCols in, XyzzColsOut out, int64_t n, int k) {
  extern __shared__ uint32_t sm[];
  const Shared<F> sh(sm);
  const int j = threadIdx.x;
  const int64_t first = (int64_t)j * k;
  XyzzT<F> acc;
  thread_sum(acc, in, n, first, k);
  block_inclusive<F>(acc, sh, j);
  store_xyzz(sh.put, acc, THREADS, j);
  __syncthreads();
  if (j > 0) {
    load_xyzz(acc, sh.get, THREADS, j - 1);
  } else {
    xyzz_set_inf(acc);
  }
  emit(acc, in, out, n, first, k);
}

// The up step of tile blockIdx.x: each thread's within-tile inclusive prefix
// into `part`, the tile's total into `tot`.
template <class F>
__global__ void __launch_bounds__(THREADS)
    tile_up_kernel(XyzzCols in, XyzzColsOut part, XyzzColsOut tot, int64_t n,
                   int64_t n_tiles, int k) {
  extern __shared__ uint32_t sm[];
  const Shared<F> sh(sm);
  const int j = threadIdx.x;
  const int64_t t = blockIdx.x;
  XyzzT<F> acc;
  thread_sum(acc, in, n, (t * THREADS + j) * k, k);
  block_inclusive<F>(acc, sh, j);
  store_xyzz(part, acc, n_tiles * THREADS, t * THREADS + j);
  if (j == THREADS - 1) store_xyzz(tot, acc, n_tiles, t);
}

// The down step of tile blockIdx.x (no barriers: idle threads leave).
template <class F>
__global__ void __launch_bounds__(THREADS)
    tile_down_kernel(XyzzCols in, XyzzCols part, XyzzCols carry,
                     XyzzColsOut out, int64_t n, int64_t n_tiles, int k) {
  const int j = threadIdx.x;
  const int64_t t = blockIdx.x;
  const int64_t first = (t * THREADS + j) * k;
  if (first >= n) return;
  XyzzT<F> off;
  down_offset(off, part, carry, n_tiles, t, j);
  emit(off, in, out, n, first, k);
}

// The inclusive scan of n elements on `stream`: one launch when one tile
// holds them (n_tiles == 1), else up, carry and down. The schedule (k,
// n_tiles, k_carry) is the host's; one that does not cover the stream is
// refused with cudaErrorInvalidValue.
template <class F>
int prefix_scan(const void* x, const void* y, const void* zzz, const void* zz,
                void* ox, void* oy, void* ozzz, void* ozz, void* scratch,
                int64_t n, int64_t n_tiles, int k, int k_carry, void* stream) {
  constexpr int bytes = shared_bytes<F>();
  static_assert(bytes <= 48 * 1024, "above the default shared memory limit");
  if (n <= 0) return (int)cudaGetLastError();
  if (k < 1 || n_tiles < 1 || n_tiles * THREADS * k < n ||
      (n_tiles - 1) * THREADS * k >= n ||
      (n_tiles > 1 && ((int64_t)k_carry * THREADS < n_tiles || !scratch)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const XyzzCols in = {(const uint32_t*)x, (const uint32_t*)y,
                       (const uint32_t*)zzz, (const uint32_t*)zz};
  const XyzzColsOut out = {(uint32_t*)ox, (uint32_t*)oy, (uint32_t*)ozzz,
                           (uint32_t*)ozz};
  if (n_tiles == 1) {
    tile_scan_kernel<F><<<1, THREADS, bytes, s>>>(in, out, n, k);
    return (int)cudaGetLastError();
  }
  const Scratch sc = scratch_layout<F>((uint32_t*)scratch, n_tiles);
  tile_up_kernel<F><<<(unsigned)n_tiles, THREADS, bytes, s>>>(
      in, sc.part, sc.tot, n, n_tiles, k);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  tile_scan_kernel<F><<<1, THREADS, bytes, s>>>(reading(sc.tot), sc.carry,
                                                n_tiles, k_carry);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  tile_down_kernel<F><<<(unsigned)n_tiles, THREADS, 0, s>>>(
      in, reading(sc.part), reading(sc.carry), out, n, n_tiles, k);
  return (int)cudaGetLastError();
}

// The resident blocks an SM of tile_scan_kernel, tile_up_kernel and
// tile_down_kernel as built, with their shared memory, into blocks[0..2].
template <class F>
int occupancy(int* blocks) {
  constexpr int bytes = shared_bytes<F>();
  cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, tile_scan_kernel<F>, THREADS, bytes);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks + 1, tile_up_kernel<F>, THREADS, bytes);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks + 2, tile_down_kernel<F>, THREADS, 0);
  return (int)rc;
}

#endif  // __CUDACC__

}  // namespace block_scan
}  // namespace msm
