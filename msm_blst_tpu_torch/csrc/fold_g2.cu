// K9 for G2 (coordinates in Fp2, each a [2, 12, n] column batch): the C
// entry point of fold.cuh.

#include "fold.cuh"

using msm::Fp2;

extern "C" int msm_g2_xyzz_fold(const void* x, const void* y, const void* zzz,
                                const void* zz, const void* index,
                                const void* tiles, void* ox, void* oy,
                                void* ozzz, void* ozz, int64_t n_in,
                                int64_t n_tiles, int k, void* stream) {
  return msm::fold::fold_pass<Fp2>(x, y, zzz, zz, index, tiles, ox, oy, ozzz,
                                   ozz, n_in, n_tiles, k, stream);
}
