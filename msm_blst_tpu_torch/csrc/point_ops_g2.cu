// K2 for G2 (coordinates in k2_mul.cuh's Fp2K2, each a [2, 12, B] column
// batch): the C entry points of point_ops.cuh.

#include "point_ops.cuh"

using msm::Fp2K2;

extern "C" int msm_g2_xyzz_dadd_affine(const void* x1, const void* y1,
                                       const void* zzz1, const void* zz1,
                                       const void* x2, const void* y2,
                                       const void* sign, void* ox, void* oy,
                                       void* ozzz, void* ozz, int64_t n,
                                       void* stream) {
  return msm::point_ops::dadd_affine<Fp2K2>(x1, y1, zzz1, zz1, x2, y2, sign, ox,
                                            oy, ozzz, ozz, n, stream);
}

extern "C" int msm_g2_xyzz_dadd(const void* x1, const void* y1,
                                const void* zzz1, const void* zz1,
                                const void* x2, const void* y2,
                                const void* zzz2, const void* zz2, void* ox,
                                void* oy, void* ozzz, void* ozz, int64_t n,
                                void* stream) {
  return msm::point_ops::dadd<Fp2K2>(x1, y1, zzz1, zz1, x2, y2, zzz2, zz2, ox,
                                     oy, ozzz, ozz, n, stream);
}

extern "C" int msm_g2_xyzz_double(const void* x1, const void* y1,
                                  const void* zzz1, const void* zz1, void* ox,
                                  void* oy, void* ozzz, void* ozz, int64_t n,
                                  void* stream) {
  return msm::point_ops::dbl<Fp2K2>(x1, y1, zzz1, zz1, ox, oy, ozzz, ozz, n,
                                    stream);
}

extern "C" int msm_g2_xyzz_bucket_diffs(const void* right, const void* local,
                                        const void* ix, const void* iy,
                                        const void* izzz, const void* izz,
                                        void* ox, void* oy, void* ozzz,
                                        void* ozz, int c, int64_t n_ch,
                                        int64_t n_buckets, void* stream) {
  return msm::point_ops::bucket_diffs<Fp2K2>(right, local, ix, iy, izzz, izz,
                                             ox, oy, ozzz, ozz, c, n_ch,
                                             n_buckets, stream);
}

extern "C" int msm_g2_xyzz_gap_horner(const void* x, const void* y,
                                      const void* zzz, const void* zz, void* ox,
                                      void* oy, void* ozzz, void* ozz,
                                      int64_t present, int d_max,
                                      void* stream) {
  return msm::point_ops::gap_horner<Fp2K2>(x, y, zzz, zz, ox, oy, ozzz, ozz,
                                           present, d_max, stream);
}

// The resident blocks an SM of the wide kernels as built: dadd_affine,
// dadd, double, bucket_diffs.
extern "C" int msm_g2_point_occupancy(int* blocks) {
  return msm::point_ops::occupancy<Fp2K2>(blocks);
}
