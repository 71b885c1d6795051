// K8: a 1-D gather, out[j] = table[idx[j]], from a table held in on-chip
// shared memory: the gather of the measurement driver
// (drivers/gather_bench.py).
//
// Replaces drivers/gather_bench.py kern_vmem (kern2): the TPU kernel keeps
// the whole int32[65537] table in VMEM and takes along it per lane. One
// H100 block can hold at most 227 KB of shared memory and the table is
// 262,148 B, so here a thread-block cluster of two CTAs holds it in
// distributed shared memory, half in each: every CTA copies its half in
// once, then each thread reads its indices' entries from whichever CTA of
// its cluster owns them (cluster.map_shared_rank). One cluster runs on each
// pair of SMs and walks the indices with a grid stride.
//
// Bound on the H100: bytes (the table, the indices and the output, each
// once: 4.5 MB at T = 65537, N = 2^19). Each cluster copies the table in
// from L2 once, 66 copies over the card, which a gather of this size does
// not amortise; the design keeps every lookup on chip, as the TPU kernel
// did, not the bytes down.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;
constexpr int CLUSTER = 2;

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
    gather_smem_kernel(const int32_t* __restrict__ table,
                       const int32_t* __restrict__ idx,
                       int32_t* __restrict__ out, int64_t T, int64_t N,
                       int64_t half) {
  extern __shared__ int32_t part[];
  cg::cluster_group cluster = cg::this_cluster();
  const int64_t lo = (int64_t)cluster.block_rank() * half;
  const int64_t len = T - lo < half ? T - lo : half;
  for (int64_t k = threadIdx.x; k < len; k += THREADS) part[k] = table[lo + k];
  cluster.sync();  // both halves are in
  int32_t* parts[CLUSTER] = {cluster.map_shared_rank(part, 0),
                             cluster.map_shared_rank(part, 1)};
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t j = (int64_t)blockIdx.x * THREADS + threadIdx.x; j < N;
       j += stride) {
    const int64_t v = idx[j];
    const int owner = v >= half;
    out[j] = parts[owner][v - owner * half];
  }
  cluster.sync();  // no CTA leaves while the other may read its half
}

}  // namespace

// idx in [0, T); T <= 2 * 227 KB / 4. One cluster a pair of SMs.
extern "C" int msm_gather_smem(const void* table, const void* idx, void* out,
                               int64_t T, int64_t N, void* stream) {
  if (T <= 0 || N <= 0) return 0;
  const int64_t half = (T + CLUSTER - 1) / CLUSTER;
  const size_t smem = (size_t)half * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      gather_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int64_t clusters = (N + (int64_t)CLUSTER * THREADS - 1) / (CLUSTER * THREADS);
  if (clusters > sms / CLUSTER) clusters = sms / CLUSTER;
  gather_smem_kernel<<<(unsigned)(clusters * CLUSTER), THREADS, smem,
                       (cudaStream_t)stream>>>(
      (const int32_t*)table, (const int32_t*)idx, (int32_t*)out, T, N, half);
  return (int)cudaGetLastError();
}
