// K5 for G1 (coordinates in Fp): the C entry points of seg.cuh (the affine
// level) and seg_scan.cuh (the segmented block scan).

#include "seg.cuh"

using msm::Fp;

extern "C" int msm_seg_level_affine(const void* rows_x, const void* rows_y,
                                    const void* signs, const void* keys,
                                    void* bx, void* by, void* bzzz, void* bzz,
                                    int64_t n_buckets, void* ox, void* oy,
                                    void* ozzz, void* ozz, void* out_key,
                                    int c, int64_t n_ch, void* stream) {
  return msm::seg::seg_level_affine<Fp>(rows_x, rows_y, signs, keys, bx, by,
                                        bzzz, bzz, n_buckets, ox, oy, ozzz,
                                        ozz, out_key, c, n_ch, stream);
}

extern "C" int msm_seg_scan(const void* x, const void* y, const void* zzz,
                            const void* zz, const void* keys, void* bx,
                            void* by, void* bzzz, void* bzz, int64_t n_buckets,
                            void* scratch, int64_t n, int64_t n_tiles, int k,
                            int k_carry, void* stream) {
  return msm::seg::seg_scan<Fp>(x, y, zzz, zz, keys, bx, by, bzzz, bzz,
                                n_buckets, scratch, n, n_tiles, k, k_carry,
                                stream);
}

// The resident blocks an SM of K5's five kernels as built: the level, the
// scan's one-block kernel, up, carry and down.
extern "C" int msm_seg_occupancy(int* blocks) {
  return msm::seg::occupancy<Fp>(blocks);
}
