// K3 for G1 (coordinates in Fp): the C entry point of scan.cuh.

#include "scan.cuh"

using msm::Fp;

extern "C" int msm_affine_prefix_level(const void* rows_x, const void* rows_y,
                                       const void* signs, void* local, void* tx,
                                       void* ty, void* tzzz, void* tzz, int c,
                                       int64_t n_ch, void* stream) {
  return msm::scan::affine_prefix_level<Fp>(rows_x, rows_y, signs, local, tx,
                                            ty, tzzz, tzz, c, n_ch, stream);
}

extern "C" int msm_affine_prefix_occupancy(int* blocks) {
  return msm::scan::occupancy<Fp>(blocks);
}
