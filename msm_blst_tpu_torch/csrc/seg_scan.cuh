// K5's second part: the segmented block scan that finishes the bucket
// reduction, as kernel templates over the coordinate field (instantiated in
// seg.cu for G1 and seg_g2.cu for G2 beside the affine level, seg.cuh).
//
// Its input is the level's stream of heads and tails: n xyzz points, key
// sorted, each key's pieces contiguous. Element e starts a run when e == 0
// or its key differs from element e - 1's (its flag). The scan is the
// inclusive scan of the pairs (flag, point) under the head-flag operator
//
//     (f1, a) . (f2, b) = (f1 or f2, f2 ? b : a + b),
//
// so element e's value is the sum of its run up to e; the thread holding
// the last element of a run stores that value into the bucket array at the
// run's key (keys >= n_buckets are pads and are dropped). Keys are unique
// across the level and the scan (msm_blst_tpu/msm/scan.py:7-17), so the
// stores are plain stores into the array in place. An infinite head (a
// lane that was one run) is the operator's identity inside its run; it
// never ends one, since its lane's tail follows it with the same key.
//
// The tiles are K4's (block_scan.cuh), with its schedule (msm/scan.py
// scan_schedule): tile t of THREADS threads covers THREADS * k elements,
// thread j the k consecutive ones from (t * THREADS + j) * k; past n,
// infinity with a clear flag (the identity).
//
//  * up (up_kernel): thread j combines its k elements in order; then a
//    Kogge-Stone scan of the THREADS pairs through shared memory, seven
//    levels: at distance d, thread j >= d whose flag is still clear adds
//    thread j - d's sum in front of its own and takes its flag. Each
//    thread's within-tile pair and each tile's total go to the scratch;
//  * carry (carry_kernel over the n_tiles totals, one block, k_carry a
//    thread, the totals' own flags): the inclusive values of the totals;
//  * down (down_kernel): a thread whose first element continues a run
//    takes as offset the value before it, thread j - 1's pair in the tile
//    put after the carry of tile t - 1 (one add, none if that pair is
//    flagged); then it combines its k elements in order, storing each run
//    that ends in them.
//
// A stream that one tile holds takes one launch, one_tile_kernel: the up
// step, then the down step from the neighbouring thread's pair, read from
// shared memory behind a barrier. The depth in adds is K4's at most
// (msm/scan.py scan_depth) and in practice the length of the longest run,
// since an add happens only inside a run: the heads and tails of a level
// are mostly pairs (a tail and the next lane's head).
//
// One out-of-line body of the add (xyzz_dadd with the full case analysis:
// equal points double, opposite points cancel, an infinite operand yields
// the other), the earlier sum its first operand, as K4 learned: an add
// inlined at every call site multiplies the build time. Every thread of a
// block with barriers reaches each one.

#pragma once

#include "fp.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace msm {
namespace seg {

constexpr int THREADS = 128;
constexpr int MIN_BLOCKS = 2;  // resident blocks an SM: K4's wave

template <class F>
MSM_HD_NOINLINE void add(XyzzT<F>& o, const XyzzT<F>& a, const XyzzT<F>& b) {
  xyzz_dadd(o, a, b);
}

// The flags of the stream: element e starts a run.
struct KeyFlags {
  const int32_t* keys;
  MSM_HD bool operator()(int64_t e) const {
    return e == 0 || keys[e] != keys[e - 1];
  }
};

// The flags of the tile totals, as the up pass wrote them.
struct ArrayFlags {
  const int32_t* flags;
  MSM_HD bool operator()(int64_t e) const { return flags[e] != 0; }
};

// Where an element's inclusive value goes: into the bucket array at its
// key when the element ends its run (the stream), ...
struct BucketSink {
  const int32_t* keys;
  XyzzColsOut buckets;
  int64_t n_buckets;
  template <class F>
  MSM_HD void put(const XyzzT<F>& run, int64_t n, int64_t e) const {
    if (e + 1 < n && keys[e + 1] == keys[e]) return;
    if ((uint32_t)keys[e] < (uint64_t)n_buckets)
      store_xyzz(buckets, run, n_buckets, keys[e]);
  }
};

// ... or every one of them, in order (the carry pass over the totals).
struct OutSink {
  XyzzColsOut out;
  template <class F>
  MSM_HD void put(const XyzzT<F>& run, int64_t n, int64_t e) const {
    store_xyzz(out, run, n, e);
  }
};

// Thread sum: elements first .. first + k - 1 that lie before n combined in
// order; returns the pair's flag (clear, with infinity, for no element).
template <class F, class Flags>
MSM_HD bool thread_sum(XyzzT<F>& acc, const XyzzCols& in, const Flags& flag,
                       int64_t n, int64_t first, int k) {
  if (first >= n) {
    xyzz_set_inf(acc);
    return false;
  }
  load_xyzz(acc, in, n, first);
  bool f = flag(first);
  for (int e = 1; e < k; ++e) {
    if (first + e >= n) break;
    XyzzT<F> b;
    load_xyzz(b, in, n, first + e);
    if (flag(first + e)) {
      acc = b;
      f = true;
    } else {
      add(acc, acc, b);
    }
  }
  return f;
}

// From the value before element `first` (run), combine elements first ..
// first + k - 1 that lie before n in order, handing each inclusive value to
// the sink.
template <class F, class Flags, class Sink>
MSM_HD void emit(XyzzT<F>& run, const XyzzCols& in, const Flags& flag,
                 const Sink& sink, int64_t n, int64_t first, int k) {
  for (int e = 0; e < k; ++e) {
    const int64_t i = first + e;
    if (i >= n) break;
    XyzzT<F> b;
    load_xyzz(b, in, n, i);
    if (flag(i)) {
      run = b;
    } else {
      add(run, run, b);
    }
    sink.put(run, n, i);
  }
}

// The down step's offset of thread j in tile t whose first element
// continues a run: the inclusive value before it. Thread j - 1's pair
// (part, part_flag) put after carry t - 1 (infinity for tile 0); the pair
// alone when it is flagged or t is 0; carry t - 1 alone for thread 0.
template <class F>
MSM_HD void down_offset(XyzzT<F>& off, const XyzzCols& part,
                        const int32_t* part_flag, const XyzzCols& carry,
                        int64_t n_tiles, int64_t t, int j) {
  const int64_t p = t * THREADS + j - 1;
  if (j > 0 && (t == 0 || part_flag[p])) {
    load_xyzz(off, part, n_tiles * THREADS, p);
    return;
  }
  if (t > 0) {
    load_xyzz(off, carry, n_tiles, t - 1);
  } else {
    xyzz_set_inf(off);
  }
  if (j > 0) {
    XyzzT<F> q;
    load_xyzz(q, part, n_tiles * THREADS, p);
    add(off, off, q);
  }
}

MSM_HD XyzzCols reading(const XyzzColsOut& c) {
  return {c.x, c.y, c.zzz, c.zz};
}

// The scratch of a scan over n_tiles tiles, one buffer of
// 4 * W * n_tiles * (THREADS + 2) + n_tiles * (THREADS + 1) words: the
// threads' within-tile values (four [W, n_tiles * THREADS] batches), the
// tile totals and the carries (four [W, n_tiles] batches each), then the
// threads' flags (n_tiles * THREADS) and the totals' (n_tiles).
struct Scratch {
  XyzzColsOut part, tot, carry;
  int32_t *part_flag, *tot_flag;
};

template <class F>
MSM_HD Scratch scratch_layout(uint32_t* s, int64_t n_tiles) {
  const int64_t P = (int64_t)Words<F>::value * n_tiles * THREADS;
  const int64_t Q = (int64_t)Words<F>::value * n_tiles;
  uint32_t* u = s + 4 * P;
  uint32_t* v = u + 4 * Q;
  int32_t* f = (int32_t*)(v + 4 * Q);
  return {{s, s + P, s + 2 * P, s + 3 * P},
          {u, u + Q, u + 2 * Q, u + 3 * Q},
          {v, v + Q, v + 2 * Q, v + 3 * Q},
          f,
          f + n_tiles * THREADS};
}

// Shared memory holds THREADS points in column layout, coordinate c's word
// w of thread i at (c * Words<F> + w) * THREADS + i (24 KB on G1, 48 KB,
// the default limit, on G2), and each point's flag in bit 31 of X's top
// word (the top word of component 0 on G2), which a canonical value (below
// p < 2^381) leaves clear.
constexpr int FLAG_WORD = NW - 1;
constexpr uint32_t FLAG_BIT = 0x80000000u;

MSM_HD uint32_t& top_word(Fp& a) { return a.w[FLAG_WORD]; }

template <class B>
MSM_HD uint32_t& top_word(Fp2T<B>& a) {
  return a.c0.w[FLAG_WORD];
}

template <class F>
MSM_HD void put_pair(const XyzzColsOut& sh, XyzzT<F> p, bool f, int j) {
  if (f) top_word(p.x) |= FLAG_BIT;
  store_xyzz(sh, p, THREADS, j);
}

template <class F>
MSM_HD bool get_pair(XyzzT<F>& p, const XyzzCols& sh, int i) {
  load_xyzz(p, sh, THREADS, i);
  const bool f = (top_word(p.x) & FLAG_BIT) != 0;
  top_word(p.x) &= ~FLAG_BIT;
  return f;
}

#ifdef __CUDACC__

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

// Segmented Kogge-Stone: (f, acc), thread j's pair, becomes the combination
// of threads 0..j's; returns its flag. (Stopping the levels once every pair
// of the block is flagged, with __syncthreads_or on the barrier that ends a
// level, was measured on the H100 and gained nothing, so every level runs.)
template <class F>
__device__ bool block_inclusive(XyzzT<F>& acc, bool f, const Shared<F>& sh,
                                int j) {
  for (int d = 1; d < THREADS; d <<= 1) {
    put_pair(sh.put, acc, f, j);
    __syncthreads();
    if (j >= d && !f) {
      XyzzT<F> b;
      f = get_pair(b, sh.get, j - d);
      add(acc, b, acc);
    }
    __syncthreads();
  }
  return f;
}

// One block scans a whole stream of n <= THREADS * k elements: the up step,
// then the down step from thread j - 1's inclusive value.
template <class F, class Flags, class Sink>
__device__ void tile_scan(XyzzCols in, Flags flag, Sink sink, int64_t n,
                          int k) {
  extern __shared__ uint32_t sm[];
  const Shared<F> sh(sm);
  const int j = threadIdx.x;
  const int64_t first = (int64_t)j * k;
  XyzzT<F> acc;
  bool f = thread_sum(acc, in, flag, n, first, k);
  f = block_inclusive<F>(acc, f, sh, j);
  put_pair(sh.put, acc, f, j);
  __syncthreads();
  if (j > 0) {
    get_pair(acc, sh.get, j - 1);
  } else {
    xyzz_set_inf(acc);
  }
  emit(acc, in, flag, sink, n, first, k);
}

// A stream that one tile holds, its runs stored into the buckets.
template <class F>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    one_tile_kernel(XyzzCols in, KeyFlags flag, BucketSink sink, int64_t n,
                    int k) {
  tile_scan<F>(in, flag, sink, n, k);
}

// The carry pass: the inclusive values of the tile totals.
template <class F>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    carry_kernel(XyzzCols in, ArrayFlags flag, OutSink sink, int64_t n, int k) {
  tile_scan<F>(in, flag, sink, n, k);
}

// The up step of tile blockIdx.x: each thread's within-tile pair into
// part / part_flag, the tile's total into tot / tot_flag.
template <class F>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    up_kernel(XyzzCols in, KeyFlags flag, Scratch sc, int64_t n,
              int64_t n_tiles, int k) {
  extern __shared__ uint32_t sm[];
  const Shared<F> sh(sm);
  const int j = threadIdx.x;
  const int64_t t = blockIdx.x;
  XyzzT<F> acc;
  bool f = thread_sum(acc, in, flag, n, (t * THREADS + j) * k, k);
  f = block_inclusive<F>(acc, f, sh, j);
  store_xyzz(sc.part, acc, n_tiles * THREADS, t * THREADS + j);
  sc.part_flag[t * THREADS + j] = f;
  if (j == THREADS - 1) {
    store_xyzz(sc.tot, acc, n_tiles, t);
    sc.tot_flag[t] = f;
  }
}

// The down step of tile blockIdx.x (no barriers: idle threads leave).
template <class F>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    down_kernel(XyzzCols in, KeyFlags flag, BucketSink sink, Scratch sc,
                int64_t n, int64_t n_tiles, int k) {
  const int j = threadIdx.x;
  const int64_t t = blockIdx.x;
  const int64_t first = (t * THREADS + j) * k;
  if (first >= n) return;
  XyzzT<F> off;
  if (flag(first)) {  // the thread's first element starts a run
    xyzz_set_inf(off);
  } else {
    down_offset(off, reading(sc.part), sc.part_flag, reading(sc.carry),
                n_tiles, t, j);
  }
  emit(off, in, flag, sink, n, first, k);
}

// The scan of n elements with their keys on `stream`, storing each run's
// sum into the bucket array: one launch when one tile holds them
// (n_tiles == 1), else up, carry and down. The schedule (k, n_tiles,
// k_carry) is the host's; one that does not cover the stream is refused
// with cudaErrorInvalidValue.
template <class F>
int seg_scan(const void* x, const void* y, const void* zzz, const void* zz,
             const void* keys, void* bx, void* by, void* bzzz, void* bzz,
             int64_t n_buckets, void* scratch, int64_t n, int64_t n_tiles,
             int k, int k_carry, void* stream) {
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
  const KeyFlags flag = {(const int32_t*)keys};
  const BucketSink sink = {(const int32_t*)keys,
                           {(uint32_t*)bx, (uint32_t*)by, (uint32_t*)bzzz,
                            (uint32_t*)bzz},
                           n_buckets};
  if (n_tiles == 1) {
    one_tile_kernel<F><<<1, THREADS, bytes, s>>>(in, flag, sink, n, k);
    return (int)cudaGetLastError();
  }
  const Scratch sc = scratch_layout<F>((uint32_t*)scratch, n_tiles);
  up_kernel<F><<<(unsigned)n_tiles, THREADS, bytes, s>>>(in, flag, sc, n,
                                                         n_tiles, k);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  carry_kernel<F><<<1, THREADS, bytes, s>>>(reading(sc.tot),
                                            ArrayFlags{sc.tot_flag},
                                            OutSink{sc.carry}, n_tiles, k_carry);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  down_kernel<F><<<(unsigned)n_tiles, THREADS, 0, s>>>(in, flag, sink, sc, n,
                                                       n_tiles, k);
  return (int)cudaGetLastError();
}

// The resident blocks an SM of the scan's kernels as built, with their
// shared memory, into blocks[0..3]: one block over a stream, up, carry,
// down.
template <class F>
int scan_occupancy(int* blocks) {
  constexpr int bytes = shared_bytes<F>();
  cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, one_tile_kernel<F>, THREADS, bytes);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks + 1, up_kernel<F>, THREADS, bytes);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks + 2, carry_kernel<F>, THREADS, bytes);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks + 3, down_kernel<F>, THREADS, 0);
  return (int)rc;
}

#endif  // __CUDACC__

}  // namespace seg
}  // namespace msm
