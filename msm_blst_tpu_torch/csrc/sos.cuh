// K6's per-lane arithmetic and its mma fragment addressing, written once as
// host-and-device functions (as fp.cuh) so that a host compiler can run the
// whole kernel body against the plain version with the warp's matrix
// product done in software.
//
// A warp multiplies 32 elements, one a lane:
//   1. each lane: the full product T = a*b, 24 words (mul_wide);
//   2. each lane stages T mod R as 48 clean bytes (K padded to 64) in its
//      column of the warp's B operand in shared memory;
//   3. the warp: positions = A1 x B, A1 the 48 x 64 byte Toeplitz of
//      P' = -p^-1 mod R (row r: byte r of T*P' before carries);
//   4. each lane: m = its 48 position sums resolved into words, mod R; m is
//      staged as the next B operand;
//   5. the warp: A2 x B, A2 the 96 x 64 Toeplitz of p, in two halves of 48
//      rows; each lane adds its half's position sums into T with one carry
//      chain (add_positions);
//   6. each lane: (T + m p) / R = T's words 12..23, below 2p since m < R;
//      one conditional subtract.
// A position sum is at most 48 * 255^2 < 2^22, exact in s32.

#pragma once

#include "fp.cuh"

namespace msm {
namespace sos {

constexpr int KB = 64;       // k bytes of a column: 48 bytes of T, zero pad
constexpr int KW = KB / 4;   // its 32-bit words
constexpr int M1 = 48;       // rows of A1: byte positions of m mod R
constexpr int M2 = 96;       // rows of A2: byte positions of m * p
constexpr int HALF = 48;     // rows of A2 a lane adds at a time
// Shared-memory pitches in words. 20 puts the eight rows (or columns) that
// one fragment load touches on distinct banks; 49 staggers the output
// columns.
constexpr int APITCH = 20;
constexpr int BPITCH = 20;
constexpr int DPITCH = 49;

enum Stage { PROD = 0, BYTES = 1, MM1 = 2, FULL = 3 };

// t = a * b, 2N words: schoolbook rows with 64-bit partial sums (a word
// product plus two words never exceeds 2^64 - 1).
template <int N>
MSM_HD void mul_wide(uint32_t* t, const uint32_t* a, const uint32_t* b) {
  MSM_UNROLL
  for (int i = 0; i < 2 * N; ++i) t[i] = 0;
  MSM_UNROLL
  for (int i = 0; i < N; ++i) {
    uint64_t c = 0;
    MSM_UNROLL
    for (int j = 0; j < N; ++j) {
      uint64_t s = (uint64_t)a[i] * b[j] + t[i + j] + c;
      t[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    t[i + N] = (uint32_t)c;
  }
}

// w[0..11] += the words of sum_r v[r] 2^(8r), r < 48, with `carry` in
// and out. v[r] < 2^22, so a step's sum stays below 2^48.
MSM_HD void add_positions(uint32_t* w, const int32_t* v, uint64_t& carry) {
  MSM_UNROLL
  for (int k = 0; k < NW; ++k) {
    uint64_t s = carry + w[k] + (uint64_t)(uint32_t)v[4 * k] +
                 ((uint64_t)(uint32_t)v[4 * k + 1] << 8) +
                 ((uint64_t)(uint32_t)v[4 * k + 2] << 16) +
                 ((uint64_t)(uint32_t)v[4 * k + 3] << 24);
    w[k] = (uint32_t)s;
    carry = s >> 32;
  }
}

// The fragments of mma.m16n8k32.row.col.s32.u8.u8.s32 for lane `lane`
// (group g = lane / 4, thread t = lane % 4; PTX ISA, "Matrix fragments for
// mma.m16n8k32"). A (16 x 32, row major) holds rows r0 + g and r0 + g + 8 at
// k bytes 4t..4t+3 and 16+4t..16+4t+3 of the k step; B (32 x 8, column
// major) column n0 + g at the same k bytes. Four consecutive k bytes are one
// little-endian word of a row of sA or a column of sB, so a fragment
// register is one 32-bit shared load.
MSM_HD void frag_a(uint32_t* a, const uint32_t* sA, int r0, int ks, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const uint32_t* lo = sA + (r0 + g) * APITCH + ks * 8 + t;
  const uint32_t* hi = sA + (r0 + g + 8) * APITCH + ks * 8 + t;
  a[0] = lo[0];
  a[1] = hi[0];
  a[2] = lo[4];
  a[3] = hi[4];
}

MSM_HD void frag_b(uint32_t* b, const uint32_t* sB, int n0, int ks, int lane) {
  const uint32_t* col = sB + (n0 + (lane >> 2)) * BPITCH + ks * 8 + (lane & 3);
  b[0] = col[0];
  b[1] = col[4];
}

// The accumulator: d[0], d[1] at row r0 + g, columns n0 + 2t, n0 + 2t + 1;
// d[2], d[3] at row r0 + g + 8. Stored transposed, a column per element,
// rows relative to the half (`rel`).
MSM_HD void store_d(int32_t* sD, const int32_t* d, int rel, int n0,
                    int lane) {
  const int g = lane >> 2, t = lane & 3;
  int32_t* c0 = sD + (n0 + 2 * t) * DPITCH + rel + g;
  int32_t* c1 = c0 + DPITCH;
  c0[0] = d[0];
  c1[0] = d[1];
  c0[8] = d[2];
  c1[8] = d[3];
}

}  // namespace sos
}  // namespace msm
