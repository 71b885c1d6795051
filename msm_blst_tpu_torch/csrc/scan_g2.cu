// K3 for G2 (coordinates in Fp2: 24-word row halves, [2, 12, n_ch]
// columns): the C entry point of scan.cuh.

#include "scan.cuh"

using msm::Fp2;

extern "C" int msm_g2_affine_prefix_level(const void* rows_x,
                                          const void* rows_y,
                                          const void* signs, void* local,
                                          void* tx, void* ty, void* tzzz,
                                          void* tzz, int c, int64_t n_ch,
                                          void* stream) {
  return msm::scan::affine_prefix_level<Fp2>(rows_x, rows_y, signs, local, tx,
                                             ty, tzzz, tzz, c, n_ch, stream);
}

extern "C" int msm_g2_affine_prefix_occupancy(int* blocks) {
  return msm::scan::occupancy<Fp2>(blocks);
}
