// K6: batched SOS Montgomery multiply over BLS12-381's base field, with the
// reduction on the integer tensor cores.
//
// Replaces msm_blst_tpu/fields/pallas_mont.py sos_kernel
// (_mont_mul_body_sos): the TPU kernel computes the full product on its
// vector unit and the reduction's two products by constants as bf16
// byte-Toeplitz matmuls on its matrix unit. Here the full product runs per
// lane on PTX carry chains, and the two Toeplitz products run as mma.sync
// m16n8k32 + m16n8k16 u8 x u8 -> s32 (48 bytes deep: exact without the
// 2^24-mantissa argument), with the elements as the rows of the mma and
// the Toeplitz as its B operand, built in registers from P' and p. T
// reaches its quad's lanes through the warp's rows in shared memory; every
// position sum lands in the accumulators of the quad that holds its
// element, and is resolved into words there, by shuffles: nothing of the
// reduction goes through shared memory. The steps are in sos.cuh.
//
// Templated on the stage, so one source also serves the staged bodies of
// drivers/mxu_experiment.py `make`: PROD writes a*b mod R, BYTES the same
// value rebuilt from the A fragments of the first product, MM1
// m = a*b*P' mod R, FULL the Montgomery product. The words equal K1's.
//
// Bound on the H100: bytes, 3 * 48 an element, against the full product's
// 144 word products (two IMADs each) and 26 mmas a warp-tile of 16
// elements. A persistent grid of MIN_BLOCKS blocks an SM; each warp walks
// groups of 32 elements, the next group's operands loaded while it
// multiplies the current one. mma.sync and the shuffles are
// warp-collective: the tail of the batch is computed as zeros by lanes
// that stay in the warp, and only their stores are masked.

#include <cuda_runtime.h>

#include "sos.cuh"

namespace {

using namespace msm::sos;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int MIN_BLOCKS = 3;  // resident blocks an SM the grid is sized for

// The warp's collective operations, as sos.cuh's body calls them.
struct Warp {
  __device__ __forceinline__ uint32_t shfl(uint32_t v, int src) const {
    return __shfl_sync(0xffffffffu, v, src);
  }
  __device__ __forceinline__ void sync() const { __syncwarp(); }
  // d += A (16 x 32 u8, 4 registers) B (32 x 8 u8, 2 registers)
  __device__ __forceinline__ void mma32(int32_t* d, const uint32_t* a,
                                        const uint32_t* b) const {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  // d += A (16 x 16 u8, 2 registers) B (16 x 8 u8, 1 register)
  __device__ __forceinline__ void mma16(int32_t* d, const uint32_t* a,
                                        uint32_t b) const {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.s32.u8.u8.s32 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(b));
  }
};

template <int STAGE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    sos_mul_kernel(const uint32_t* __restrict__ a,
                   const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                   int64_t n) {
  __shared__ uint32_t tab[TABLE_WORDS];
  __shared__ uint32_t rows[WARPS][GROUP * TPITCH];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Consts k;
  if (STAGE == MM1 || STAGE == FULL) {
    if (threadIdx.x == 0) fill_table(tab);
    __syncthreads();
    lane_consts(k, tab, lane);
  }
  Warp w;
  const int64_t groups = (n + GROUP - 1) / GROUP;
  const int64_t stride = (int64_t)gridDim.x * WARPS;
  const int slot = elem_of(lane >> 2, lane & 3);
  int64_t gi = (int64_t)blockIdx.x * WARPS + warp;
  uint32_t x[msm::NW], y[msm::NW];
  load_operands(x, y, a, b, n, gi * GROUP + slot);
  for (; gi < groups; gi += stride) {
    uint32_t nx[msm::NW], ny[msm::NW];
    load_operands(nx, ny, a, b, n, (gi + stride) * GROUP + slot);
    group<STAGE>(w, k, rows[warp], x, y, out, n, gi * GROUP, lane);
#pragma unroll
    for (int j = 0; j < msm::NW; ++j) {
      x[j] = nx[j];
      y[j] = ny[j];
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

template <int STAGE>
int launch(const void* a, const void* b, void* out, int64_t n, void* stream) {
  if (n > 0) {
    const int64_t warps = (n + GROUP - 1) / GROUP;
    const int64_t want = (warps + WARPS - 1) / WARPS;
    const int64_t cap = (int64_t)sm_count() * MIN_BLOCKS;
    const unsigned blocks = (unsigned)(want < cap ? want : cap);
    sos_mul_kernel<STAGE><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

template <int STAGE>
int occupancy(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, sos_mul_kernel<STAGE>, THREADS, 0);
}

}  // namespace

extern "C" int msm_sos_mul(const void* a, const void* b, void* out, int64_t n,
                           void* stream) {
  return launch<FULL>(a, b, out, n, stream);
}

extern "C" int msm_sos_mul_prod(const void* a, const void* b, void* out,
                                int64_t n, void* stream) {
  return launch<PROD>(a, b, out, n, stream);
}

extern "C" int msm_sos_mul_bytes(const void* a, const void* b, void* out,
                                 int64_t n, void* stream) {
  return launch<BYTES>(a, b, out, n, stream);
}

extern "C" int msm_sos_mul_mm1(const void* a, const void* b, void* out,
                               int64_t n, void* stream) {
  return launch<MM1>(a, b, out, n, stream);
}

// The resident blocks an SM of the four stage kernels (prod, bytes, mm1,
// full), as built, and the blocks an SM the launch sizes its grid for.
extern "C" int msm_sos_occupancy(int* blocks) {
  int rc = occupancy<PROD>(blocks);
  if (!rc) rc = occupancy<BYTES>(blocks + 1);
  if (!rc) rc = occupancy<MM1>(blocks + 2);
  if (!rc) rc = occupancy<FULL>(blocks + 3);
  return rc;
}

extern "C" int msm_sos_min_blocks() { return MIN_BLOCKS; }
