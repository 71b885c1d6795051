// K2: the fused xyzz point formulas, as kernel templates over K2's
// coordinate field (k2_mul.cuh: FpK2 for G1 in point_ops.cu, Fp2K2 for G2 in
// point_ops_g2.cu).
//
// Replaces msm_blst_tpu/curves/pallas_point.py _kernel(curve, op): the TPU
// kernel traces the whole branch-free formula of curves/ops.py into one
// pallas_call so the multiplies and the case analysis stay in VMEM.
// Here one thread owns one lane and runs the formula (fp.cuh) in registers:
// dadd_affine (signed madd-2008-s), dadd (add-2008-s), double (dbl-2008-s-1),
// with the infinity, P == Q and P == -Q cases chosen per thread. Two more
// launches carry the CHES query's own uses of the formulas, each in one
// kernel where the TPU's code runs a formula launch per step:
//
//  * bucket_diffs (msm/prefix_pipeline.py buckets_from_boundaries): bucket k
//    of a key-sorted stream is P(right_k) - P(right_{k-1}), P(i) the sum of
//    the first i stream elements, read off the prefix level: P(i) =
//    incl[kch - 1] + local[j n_ch + kch] for the element i - 1 = kch c + j
//    (incl the inclusive scan of the level's lane tails, infinity before
//    lane 0), P(0) infinity. A block takes TILE = THREADS - 1 buckets and
//    one before them: thread t forms P of bucket b0 - 1 + t (the gathered
//    row read from shared memory, where its warp copied its 32 rows in
//    16-byte words, one row after another), the prefixes meet in shared
//    memory, and thread t > 0 writes P_t + (-P_{t-1}). Two adds a bucket in
//    the order of the TPU's code (the boundary's prefix, then the
//    difference), so the words are those of the torch code it replaces
//    (cuda_point.bucket_diffs_plain), with no gather, concatenation or
//    select between launches;
//  * gap_horner (msm/engine.py integrate_gapped): sum_g g S_g over the d_max
//    folded gap groups S_g present (a bit mask): thread b sums the groups
//    with bit b of g set, in ascending g; then thread 0 runs Horner from the
//    top bit, doubling once a part has been taken and adding each part.
//    The adds and doublings of the torch loop it replaces, in its order, in
//    one launch: 2 + 4 formulas deep at d_max = 6 instead of ten launches.
//
// Bound on the H100: integer multiplies (G1: 12 to 21 Montgomery products
// per lane; G2: three per Fp2 product), run on the card's carry chains
// (k2_mul.cuh), and register pressure from the live field temporaries,
// which spill to local memory (a G2 xyzz point alone is 96 words).
// __launch_bounds__ asks for MIN_BLOCKS resident blocks an SM of the wide
// kernels (msm_point_occupancy reports them as built). Coordinates stay in
// the column layout ([12, B] words, [2, 12, B] for G2) so the loads and
// stores are coalesced. The kernels but dadd_affine share one add and one
// doubling a field (below), inlined on G1 and out of line on G2.

#pragma once

#include "k2_mul.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace msm {
namespace point_ops {

constexpr int THREADS = 128;
constexpr int TILE = THREADS - 1;  // buckets a block of bucket_diffs
// Two resident blocks an SM: with three (at most 168 registers) the adds
// spill and no launch ran faster on the H100 (scripts/k2_timing.py). The
// host reads it through msm_point_min_blocks.
constexpr int MIN_BLOCKS = 2;
constexpr int HORNER_BITS = 6;     // gap_horner: d_max < 2^6
constexpr int HORNER_THREADS = 32;

// The add and the doubling of the dadd, double, boundary and Horner
// kernels, by field: inlined on G1, one out-of-line body on G2 (as K3's
// scan.cuh add), the faster form of each curve on the H100
// (scripts/k2_timing.py; a call in G1's dadd and double kernels saved no
// build time). G2's Horner kernel with the add inlined (255 registers, a
// 4.3 KB stack frame) gave other words than its plain twin with either
// product, for a cause not found (PERF.md section 7): that form is not
// built.
MSM_HD void add(XyzzT<FpK2>& o, const XyzzT<FpK2>& a,
                const XyzzT<FpK2>& b) {
  xyzz_dadd(o, a, b);
}

MSM_HD_NOINLINE void add(XyzzT<Fp2K2>& o, const XyzzT<Fp2K2>& a,
                         const XyzzT<Fp2K2>& b) {
  xyzz_dadd(o, a, b);
}

MSM_HD void twice(XyzzT<FpK2>& o, const XyzzT<FpK2>& a) {
  xyzz_double(o, a);
}

MSM_HD_NOINLINE void twice(XyzzT<Fp2K2>& o, const XyzzT<Fp2K2>& a) {
  xyzz_double(o, a);
}

// P(idx1) of bucket_diffs: the level's row of the stream element idx1 - 1
// (-1 when idx1 is 0: P is infinity) and its lane.
MSM_HD int64_t boundary_row(int32_t idx1, int c, int64_t n_ch, int64_t& kch) {
  if (idx1 <= 0) {
    kch = 0;
    return -1;
  }
  const int64_t pos = (int64_t)idx1 - 1;
  kch = pos / c;
  return (pos - kch * c) * n_ch + kch;
}

// P from the lane's exclusive carry (incl[kch - 1], infinity in lane 0) and
// the element's local prefix row (X || Y || ZZZ || ZZ words).
template <class F>
MSM_HD void boundary_prefix(XyzzT<F>& P, const uint32_t* row,
                            const XyzzCols& incl, int64_t n_ch, int64_t kch) {
  constexpr int W = Words<F>::value;
  XyzzT<F> loc, ex;
  load_row(loc.x, row);
  load_row(loc.y, row + W);
  load_row(loc.zzz, row + 2 * W);
  load_row(loc.zz, row + 3 * W);
  if (kch > 0) {
    load_xyzz(ex, incl, n_ch, kch - 1);
  } else {
    xyzz_set_inf(ex);
  }
  add(P, ex, loc);
}

// gap_horner's part of bit b: the sum of the present groups g with bit b
// set, in ascending g (`sums` column g - 1); false if there is none.
template <class F>
MSM_HD bool horner_part(XyzzT<F>& part, const XyzzCols& sums,
                        uint64_t present, int d_max, int b) {
  bool any = false;
  for (int g = 1; g <= d_max; ++g) {
    if (!((g >> b) & 1) || !((present >> (g - 1)) & 1)) continue;
    XyzzT<F> s;
    load_xyzz(s, sums, d_max, g - 1);
    if (any) {
      add(part, part, s);
    } else {
      part = s;
    }
    any = true;
  }
  return any;
}

#ifdef __CUDACC__

template <class F>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    dadd_affine_kernel(XyzzCols p1, const uint32_t* x2, const uint32_t* y2,
                       const int32_t* sign, XyzzColsOut o, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) dadd_affine_elem<F>(p1, x2, y2, sign, o, n, i);
}

template <class F>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    dadd_kernel(XyzzCols p1, XyzzCols p2, XyzzColsOut o, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    XyzzT<F> a, b, r;
    load_xyzz(a, p1, n, i);
    load_xyzz(b, p2, n, i);
    add(r, a, b);
    store_xyzz(o, r, n, i);
  }
}

template <class F>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    double_kernel(XyzzCols p1, XyzzColsOut o, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    XyzzT<F> a, r;
    load_xyzz(a, p1, n, i);
    twice(r, a);
    store_xyzz(o, r, n, i);
  }
}

// Shared memory of bucket_diffs: THREADS rows of 4 W words (24 KB on G1, the
// default limit of 48 KB on G2), first the gathered rows, then the
// prefixes in column layout (coordinate c's word w of thread t at
// (c W + w) THREADS + t).
template <class F>
constexpr int diffs_shared_bytes() {
  return 4 * Words<F>::value * THREADS * (int)sizeof(uint32_t);
}

// Every thread reaches every barrier: none returns early.
template <class F>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    bucket_diffs_kernel(const int32_t* right, const uint32_t* local,
                        XyzzCols incl, XyzzColsOut out, int c, int64_t n_ch,
                        int64_t n_buckets) {
  constexpr int W = Words<F>::value;
  constexpr int Q = W;  // 16-byte words of a row of 4 W words
  extern __shared__ uint4 sm4[];
  uint32_t* sm = reinterpret_cast<uint32_t*>(sm4);
  const int t = threadIdx.x;
  const int64_t kb = (int64_t)blockIdx.x * TILE + t - 1;
  const bool in_range = kb >= 0 && kb < n_buckets;
  int64_t kch;
  const int64_t row = boundary_row(in_range ? right[kb] : 0, c, n_ch, kch);
  // warp copies: 16-byte word u of the warp's rows, row u / Q, coalesced
  const int lane = t & 31, first = t - lane;
  const uint4* src = reinterpret_cast<const uint4*>(local);
  for (int u = lane; u < 32 * Q; u += 32) {
    const int r = u / Q;
    const int64_t g = __shfl_sync(0xffffffffu, row, r);
    if (g >= 0) sm4[(first + r) * Q + (u - r * Q)] = src[g * Q + (u - r * Q)];
  }
  __syncwarp();
  XyzzT<F> P;
  if (row >= 0) {
    boundary_prefix<F>(P, sm + t * 4 * W, incl, n_ch, kch);
  } else {
    xyzz_set_inf(P);
  }
  constexpr int S = W * THREADS;
  const XyzzColsOut put = {sm, sm + S, sm + 2 * S, sm + 3 * S};
  const XyzzCols get = {sm, sm + S, sm + 2 * S, sm + 3 * S};
  __syncthreads();  // every row read: the buffer takes the prefixes
  store_xyzz(put, P, THREADS, t);
  __syncthreads();
  if (t > 0 && in_range) {
    XyzzT<F> prev, b;
    load_xyzz(prev, get, THREADS, t - 1);
    fp_neg(prev.y, prev.y);
    add(b, P, prev);
    store_xyzz(out, b, n_buckets, kb);
  }
}

template <class F>
__global__ void __launch_bounds__(HORNER_THREADS)
    gap_horner_kernel(XyzzCols sums, XyzzColsOut out, uint64_t present,
                      int d_max) {
  constexpr int S = Words<F>::value * HORNER_BITS;
  __shared__ uint32_t sm[4 * S];
  __shared__ int have[HORNER_BITS];
  const XyzzColsOut put = {sm, sm + S, sm + 2 * S, sm + 3 * S};
  const XyzzCols get = {sm, sm + S, sm + 2 * S, sm + 3 * S};
  const int b = threadIdx.x;
  int bits = 0;
  while ((d_max >> bits) > 0) ++bits;
  if (b < bits) {
    XyzzT<F> part;
    have[b] = horner_part<F>(part, sums, present, d_max, b);
    if (have[b]) store_xyzz(put, part, HORNER_BITS, b);
  }
  __syncthreads();
  if (b != 0) return;
  XyzzT<F> acc;
  bool started = false;
  for (int k = bits - 1; k >= 0; --k) {
    if (started) {
      twice(acc, acc);
      if (have[k]) {
        XyzzT<F> part;
        load_xyzz(part, get, HORNER_BITS, k);
        add(acc, acc, part);
      }
    } else if (have[k]) {
      load_xyzz(acc, get, HORNER_BITS, k);
      started = true;
    }
  }
  if (!started) xyzz_set_inf(acc);
  store_xyzz(out, acc, 1, 0);
}

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

// The n_buckets bucket sums from the level's boundaries `right` (int32),
// its local rows `local` ((c n_ch, 4 W) words, 16-byte aligned) and the
// inclusive scan of its lane tails (four [W, n_ch] batches).
template <class F>
int bucket_diffs(const void* right, const void* local, const void* ix,
                 const void* iy, const void* izzz, const void* izz, void* ox,
                 void* oy, void* ozzz, void* ozz, int c, int64_t n_ch,
                 int64_t n_buckets, void* stream) {
  constexpr int bytes = diffs_shared_bytes<F>();
  static_assert(bytes <= 48 * 1024, "above the default shared memory limit");
  if (n_buckets <= 0) return (int)cudaGetLastError();
  if (c < 1 || n_ch < 1 || ((uintptr_t)local & 15))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n_buckets + TILE - 1) / TILE);
  bucket_diffs_kernel<F><<<blocks, THREADS, bytes, (cudaStream_t)stream>>>(
      (const int32_t*)right, (const uint32_t*)local, cols(ix, iy, izzz, izz),
      cols_out(ox, oy, ozzz, ozz), c, n_ch, n_buckets);
  return (int)cudaGetLastError();
}

// sum_g g S_g over the present groups of `sums` (four [W, d_max] batches,
// group g in column g - 1; bit g - 1 of `present`), into four [W, 1] batches.
template <class F>
int gap_horner(const void* x, const void* y, const void* zzz, const void* zz,
               void* ox, void* oy, void* ozzz, void* ozz, int64_t present,
               int d_max, void* stream) {
  if (d_max < 1 || (d_max >> HORNER_BITS) != 0)
    return (int)cudaErrorInvalidValue;
  gap_horner_kernel<F><<<1, HORNER_THREADS, 0, (cudaStream_t)stream>>>(
      cols(x, y, zzz, zz), cols_out(ox, oy, ozzz, ozz), (uint64_t)present,
      d_max);
  return (int)cudaGetLastError();
}

// The resident blocks an SM of the wide kernels as built, with their shared
// memory, at THREADS threads: dadd_affine, dadd, double, bucket_diffs.
template <class F>
int occupancy(int* blocks) {
  cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, dadd_affine_kernel<F>, THREADS, 0);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks + 1, dadd_kernel<F>, THREADS, 0);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks + 2, double_kernel<F>, THREADS, 0);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks + 3, bucket_diffs_kernel<F>, THREADS, diffs_shared_bytes<F>());
  return (int)rc;
}

#endif  // __CUDACC__

}  // namespace point_ops
}  // namespace msm
