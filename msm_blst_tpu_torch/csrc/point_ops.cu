// K2 for G1 (coordinates in Fp): the C entry points of point_ops.cuh.

#include "point_ops.cuh"

using msm::Fp;

extern "C" int msm_xyzz_dadd_affine(const void* x1, const void* y1,
                                    const void* zzz1, const void* zz1,
                                    const void* x2, const void* y2,
                                    const void* sign, void* ox, void* oy,
                                    void* ozzz, void* ozz, int64_t n,
                                    void* stream) {
  return msm::point_ops::dadd_affine<Fp>(x1, y1, zzz1, zz1, x2, y2, sign, ox,
                                         oy, ozzz, ozz, n, stream);
}

extern "C" int msm_xyzz_dadd(const void* x1, const void* y1, const void* zzz1,
                             const void* zz1, const void* x2, const void* y2,
                             const void* zzz2, const void* zz2, void* ox,
                             void* oy, void* ozzz, void* ozz, int64_t n,
                             void* stream) {
  return msm::point_ops::dadd<Fp>(x1, y1, zzz1, zz1, x2, y2, zzz2, zz2, ox, oy,
                                  ozzz, ozz, n, stream);
}

extern "C" int msm_xyzz_double(const void* x1, const void* y1, const void* zzz1,
                               const void* zz1, void* ox, void* oy, void* ozzz,
                               void* ozz, int64_t n, void* stream) {
  return msm::point_ops::dbl<Fp>(x1, y1, zzz1, zz1, ox, oy, ozzz, ozz, n,
                                 stream);
}
