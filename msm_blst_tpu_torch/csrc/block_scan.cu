// The block scan for G1 (coordinates in Fp): the C entry point of
// block_scan.cuh.

#include "block_scan.cuh"

using msm::Fp;

extern "C" int msm_xyzz_prefix_scan(const void* x, const void* y,
                                    const void* zzz, const void* zz, void* ox,
                                    void* oy, void* ozzz, void* ozz,
                                    void* scratch, int64_t n, int64_t n_tiles,
                                    int k, int k_carry, void* stream) {
  return msm::block_scan::prefix_scan<Fp>(x, y, zzz, zz, ox, oy, ozzz, ozz,
                                          scratch, n, n_tiles, k, k_carry,
                                          stream);
}

// The resident blocks an SM of the three kernels as built: tile_scan,
// tile_up, tile_down.
extern "C" int msm_xyzz_prefix_scan_occupancy(int* blocks) {
  return msm::block_scan::occupancy<Fp>(blocks);
}
