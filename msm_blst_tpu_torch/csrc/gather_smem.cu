// K8: a 1-D gather, out[j] = table[idx[j]], from a table held in on-chip
// shared memory: the gather of the measurement driver
// (drivers/gather_bench.py).
//
// Replaces drivers/gather_bench.py kern_vmem (kern2): the TPU kernel keeps
// the whole int32[65537] table in VMEM and takes along it per lane. One
// H100 block can hold at most 227 KB of shared memory and the table is
// 262,148 B, so here a thread-block cluster of two CTAs holds it in
// distributed shared memory: CTA 0 holds table[0, slice), CTA 1
// table[slice, T), slice = 4 * ceil(T / 8) (a multiple of 4 entries, the
// bulk copy's 16-byte step), so entry v lies in CTA (v >= slice).
//
// Bound on the H100: bytes (the table, the indices and the output, each
// once: 4.5 MB at T = 65537, N = 2^19). What the design does about it:
// - one wave of clusters (cudaOccupancyMaxActiveClusters), each filling
//   its copy of the table once by TMA bulk copies (cp.async.bulk, 16-byte
//   multiples; the last 1-3 entries of the table by plain loads),
//   completing on an mbarrier; meanwhile each thread loads its first four
//   indices (int4);
// - then one cluster barrier (every slice is in), four lookups a thread
//   (mapa + ld.shared::cluster) and an int4 store; the closing barrier
//   keeps every CTA resident while another may still read its slice;
// - two CTAs, not more: wider clusters copy less of the table in, but a
//   warp's lookups then reach more CTAs, and on the H100 that costs more
//   than the copies save (PERF.md §6);
// - the function attributes and each table size's cluster capacity are
//   read once, not on every call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int CLUSTER = 2;
constexpr int CHUNK = 16384;  // entries a bulk copy (64 KB)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;" ::: "memory");
}

// Waits for the phase `parity` of the mbarrier to complete; a fill that
// never completes faults (after some 2^20 tries) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 20)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// The entry v of the table, from the shared memory of the CTA that holds
// it. An index outside [0, T) reads some entry of the table, never outside
// the cluster's shared memory.
__device__ __forceinline__ int32_t lookup(uint32_t part, int32_t v,
                                          uint32_t slice) {
  const uint32_t r = (uint32_t)v >= slice;
  uint32_t off = (uint32_t)v - r * slice;
  off = off < slice ? off : slice - 1;
  uint32_t addr;
  int32_t x;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(addr)
               : "r"(part + 4 * off), "r"(r));
  asm volatile("ld.shared::cluster.b32 %0, [%1];" : "=r"(x) : "r"(addr));
  return x;
}

__global__ void __launch_bounds__(THREADS)
    gather_smem_kernel(const int32_t* __restrict__ table,
                       const int4* __restrict__ idx4,
                       const int32_t* __restrict__ idx,
                       int4* __restrict__ out4, int32_t* __restrict__ out,
                       int T, int64_t N, int slice) {
  extern __shared__ __align__(16) int32_t part[];
  __shared__ __align__(8) uint64_t bar;
  const uint32_t rank = cluster_rank();
  const int lo = (int)rank * slice;
  const int len = T - lo < 0 ? 0 : (T - lo < slice ? T - lo : slice);
  const int bulk = len & ~3;  // entries the bulk copies bring
  const uint32_t bar_a = smem_u32(&bar), part_a = smem_u32(part);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar_a)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                     bar_a),
                 "r"(bulk * 4)
                 : "memory");
    for (int k = 0; k < bulk; k += CHUNK) {
      const int n = bulk - k < CHUNK ? bulk - k : CHUNK;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];" ::"r"(part_a + 4 * k),
          "l"(table + lo + k), "r"(n * 4), "r"(bar_a)
          : "memory");
    }
  }
  if ((int)threadIdx.x < len - bulk)
    part[bulk + threadIdx.x] = table[lo + bulk + threadIdx.x];

  // the first four indices of this thread, in flight during the fill
  const int64_t n4 = N >> 2;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  const int64_t g = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  int64_t j = g;
  int4 v = make_int4(0, 0, 0, 0);
  if (j < n4) v = __ldg(idx4 + j);
  const int64_t tj = 4 * n4 + g;  // the 1-3 indices past the last int4
  const int32_t tv = tj < N ? __ldg(idx + tj) : 0;

  __syncthreads();  // the mbarrier is initialised
  mbar_wait(bar_a, 0);
  cluster_arrive();  // this slice is in: the bulk copy and the plain tail
  cluster_wait();    // and every other slice of the cluster

  for (; j < n4; j += stride) {
    int4 o;
    o.x = lookup(part_a, v.x, slice);
    o.y = lookup(part_a, v.y, slice);
    o.z = lookup(part_a, v.z, slice);
    o.w = lookup(part_a, v.w, slice);
    if (j + stride < n4) v = __ldg(idx4 + j + stride);
    out4[j] = o;
  }
  int32_t t = 0;
  if (tj < N) t = lookup(part_a, tv, slice);
  cluster_arrive();  // this CTA's reads of the other slices are done
  if (tj < N) out[tj] = t;
  cluster_wait();  // no CTA leaves while another may read its slice
}

// Per device: whether the attributes are set, the largest dynamic shared
// memory a block may take, and the last cluster capacity read.
struct DeviceState {
  bool ready = false;
  int max_dynamic = 0;
  int cap_slice = 0, cap = 0;
};
constexpr int MAX_DEVICES = 64;
DeviceState states[MAX_DEVICES];

cudaError_t device_state(DeviceState** out) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  DeviceState& s = states[device];
  if (!s.ready) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, (const void*)gather_smem_kernel);
    if (err != cudaSuccess) return err;
    s.max_dynamic = optin - (int)attr.sharedSizeBytes;
    err = cudaFuncSetAttribute((const void*)gather_smem_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               s.max_dynamic);
    if (err != cudaSuccess) return err;
    s.ready = true;
  }
  *out = &s;
  return cudaSuccess;
}

cudaLaunchConfig_t config(int clusters, int slice, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * CLUSTER), 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = (size_t)slice * sizeof(int32_t);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CLUSTER;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The slice of a table of T entries (CTA 0's share), or 0 when the
// cluster cannot hold T entries.
int slice_of(DeviceState* s, int64_t T) {
  const int64_t slice = (T + 7) / 8 * 4;
  return T < 1 || slice * (int64_t)sizeof(int32_t) > s->max_dynamic
             ? 0
             : (int)slice;
}

// The clusters holding `slice` entries a CTA that the card keeps resident
// at once, read once a slice.
cudaError_t capacity(DeviceState* s, int slice, int* out) {
  if (s->cap_slice != slice) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = config(1, slice, 0, &attr);
    int n = 0;
    cudaError_t err = cudaOccupancyMaxActiveClusters(
        &n, (const void*)gather_smem_kernel, &cfg);
    if (err != cudaSuccess) return err;
    s->cap_slice = slice;
    s->cap = n;
  }
  *out = s->cap;
  return cudaSuccess;
}

}  // namespace

// Writes the clusters of K8 for a table of T entries that the card keeps
// resident at once (0: it cannot launch them).
extern "C" int msm_gather_smem_clusters(int64_t T, int* clusters) {
  DeviceState* s = nullptr;
  cudaError_t err = device_state(&s);
  if (err != cudaSuccess) return (int)err;
  const int slice = slice_of(s, T);
  if (slice == 0) return (int)cudaErrorInvalidValue;
  return (int)capacity(s, slice, clusters);
}

// idx in [0, T); table, idx and out 16-byte aligned. One wave of clusters
// walks the indices four at a time with a grid stride.
extern "C" int msm_gather_smem(const void* table, const void* idx, void* out,
                               int64_t T, int64_t N, void* stream) {
  if (N <= 0) return 0;
  if (((uintptr_t)table | (uintptr_t)idx | (uintptr_t)out) & 15)
    return (int)cudaErrorInvalidValue;
  DeviceState* s = nullptr;
  cudaError_t err = device_state(&s);
  if (err != cudaSuccess) return (int)err;
  const int slice = slice_of(s, T);
  if (slice == 0) return (int)cudaErrorInvalidValue;
  int cap = 0;
  err = capacity(s, slice, &cap);
  if (err != cudaSuccess) return (int)err;
  if (cap < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t per_cluster = (int64_t)CLUSTER * THREADS * 4;
  int64_t clusters = (N + per_cluster - 1) / per_cluster;
  if (clusters > cap) clusters = cap;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      config((int)clusters, slice, (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(&cfg, gather_smem_kernel, (const int32_t*)table,
                           (const int4*)idx, (const int32_t*)idx, (int4*)out,
                           (int32_t*)out, (int)T, N, slice);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
