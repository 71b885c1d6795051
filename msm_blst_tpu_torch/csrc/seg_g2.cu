// K5 for G2 (coordinates in Fp2: 24-word row halves, [2, 12, n] columns):
// the C entry points of seg.cuh.

#include "seg.cuh"

using msm::Fp2;

extern "C" int msm_g2_seg_level_affine(const void* rows_x, const void* rows_y,
                                       const void* signs, const void* keys,
                                       void* bx, void* by, void* bzzz,
                                       void* bzz, int64_t n_buckets, void* hx,
                                       void* hy, void* hzzz, void* hzz,
                                       void* tx, void* ty, void* tzzz,
                                       void* tzz, void* head_key,
                                       void* tail_key, int c, int64_t n_ch,
                                       void* stream) {
  return msm::seg::seg_level_affine<Fp2>(
      rows_x, rows_y, signs, keys, bx, by, bzzz, bzz, n_buckets, hx, hy, hzzz,
      hzz, tx, ty, tzzz, tzz, head_key, tail_key, c, n_ch, stream);
}

extern "C" int msm_g2_seg_level_xyzz(const void* x, const void* y,
                                     const void* zzz, const void* zz,
                                     const void* keys, void* bx, void* by,
                                     void* bzzz, void* bzz, int64_t n_buckets,
                                     void* hx, void* hy, void* hzzz, void* hzz,
                                     void* tx, void* ty, void* tzzz, void* tzz,
                                     void* head_key, void* tail_key, int c,
                                     int64_t n_ch, void* stream) {
  return msm::seg::seg_level_xyzz<Fp2>(x, y, zzz, zz, keys, bx, by, bzzz, bzz,
                                       n_buckets, hx, hy, hzzz, hzz, tx, ty,
                                       tzzz, tzz, head_key, tail_key, c, n_ch,
                                       stream);
}
