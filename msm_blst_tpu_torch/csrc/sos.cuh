// K6's warp body, written once as host-and-device code over a warp type W,
// so that a host compiler can run every lane of it against the plain
// version with the warp emulated in software.
//
// The warp type W supplies shfl(v, src), sync() (the warp's barrier),
// mma32 (m16n8k32 u8) and mma16 (m16n8k16 u8).
//
// A warp multiplies a group of 32 elements. Lane l = 4g + t (group g, thread
// t of its quad) loads and multiplies element slot u = t of quad g: element
// 16 (u >> 1) + 8 (u & 1) + g of the group, so that quad g holds the rows g
// and g + 8 of the group's two m16 tiles: the elements are the rows of every
// mma, and the Toeplitz of P' = -p^-1 mod R (or of p) is its B operand.
//
//   1. each lane: the full product T = a b, 24 words, on carry chains
//      (mul_wide_cc, k2_mul.cuh's Chain);
//   2. the quad's transpose of T through the warp's rows in shared memory
//      (stage_t: 24 stores and 24 loads a lane) gives lane t words
//      3t .. 3t + 2 of T mod R and 12 + 3t .. 14 + 3t of T for each of the
//      quad's four elements: lane t's words of T mod R are its A fragment
//      registers (k bytes 4t.. of the k32 step are word 3t, 16 + 4t.. word
//      3t + 1, 4t.. of the k16 step word 3t + 2). Six 4 x 4 transposes by
//      shuffles do the same with 16 selects each; on the H100 they ran 7%
//      slower (scripts/sos_timing.py). Nothing of the reduction goes
//      through shared memory;
//   3. m = T P' mod R: per m tile six n8 tiles, each one k32 and one k16
//      mma; tile j's columns 2t, 2t + 1 are byte positions 12t + 2j and
//      12t + 2j + 1, so lane t holds all twelve position sums of words
//      3t .. 3t + 2 of each of its elements and resolves them into words
//      in registers (block_words); the carries between the quad's lanes
//      take three shuffle rounds (quad_carry). m lands in the A layout;
//   4. m p: six n8 tiles of the byte positions 48 + 12t + 2j (+1), added
//      to T's words 12 + 3t .. 14 + 3t, and one tile whose columns 6 and 7
//      are positions 46 and 47. The low half of T + m p is 0 mod R, so its
//      carry into word 12 is ceil((T_top16 + S46 + 2^8 S47) / 2^16) (the
//      positions below 46 and T's bits below 368 add less than 2^384):
//      lane 3 holds it and hands it to lane 0;
//   5. (T + m p) / R < 2p: one conditional subtraction of p, its borrows
//      looked ahead over the quad's four blocks (two shuffles);
//   6. each lane stores its three words of each of its quad's elements.
//
// The B registers are Toeplitz windows: four bytes Y[x], Y[x - 1], ...,
// Y[x - 3] of P' or p (zero outside bytes 0..47), x fixed by the lane and
// the tile. Tile j's k32 high half and its k16 step are the k32 low
// halves of tiles j - 2 and j - 4, so 23 registers hold every B fragment
// (lane_consts), built once a thread from a 72-word table of P' and p that
// one thread of the block writes from immediates (fill_table).
// A position sum is at most 48 * 255^2 < 2^22, exact in s32.

#pragma once

#include "fp.cuh"
#include "k2_mul.cuh"

namespace msm {
namespace sos {

enum Stage { PROD = 0, BYTES = 1, MM1 = 2, FULL = 3 };

constexpr int GROUP = 32;  // elements a warp a step
constexpr int TPITCH = 25;  // words of a lane's row of T in shared memory
// The table: P' then p, words -12 .. 23 each (zero outside 0 .. 11).
constexpr int PAD = 12;
constexpr int TABLE_WORDS = 2 * 36;

// P' = -p^-1 mod 2^384, little-endian words
MSM_HD uint32_t pprime_word(int i) {
  switch (i) {
    case 0: return 0xfffcfffdu;
    case 1: return 0x89f3fffcu;
    case 2: return 0xd9d113e8u;
    case 3: return 0x286adb92u;
    case 4: return 0xc8e30b48u;
    case 5: return 0x16ef2ef0u;
    case 6: return 0x8eb2db4cu;
    case 7: return 0x19ecca0eu;
    case 8: return 0xe268cf58u;
    case 9: return 0x68b316feu;
    case 10: return 0xfeaafc94u;
    default: return 0xceb06106u;
  }
}

// One thread's table fill: the loop unrolls into stores of immediates.
MSM_HD void fill_table(uint32_t* tab) {
  MSM_UNROLL
  for (int k = 0; k < 36; ++k) {
    const int i = k - PAD;
    const bool in = i >= 0 && i < NW;
    tab[k] = in ? pprime_word(i) : 0u;
    tab[36 + k] = in ? Modulus<NW>::word(i) : 0u;
  }
}

MSM_HD uint32_t funnel_l(uint32_t lo, uint32_t hi, int s) {
#ifdef __CUDA_ARCH__
  return __funnelshift_l(lo, hi, s);
#else
  return s == 0 ? hi : (hi << s) | (lo >> (32 - s));
#endif
}

MSM_HD uint32_t byte_reverse(uint32_t v) {
#ifdef __CUDA_ARCH__
  return __byte_perm(v, 0, 0x0123);
#else
  return (v >> 24) | ((v >> 8) & 0xff00u) | ((v << 8) & 0xff0000u) | (v << 24);
#endif
}

// Bytes Y[x], Y[x-1], Y[x-2], Y[x-3] of the table's number Y (`tab` its word
// -12), as the bytes 0..3 of a word.
MSM_HD uint32_t window(const uint32_t* tab, int x) {
  const int k = x >> 2, e = x & 3;  // x = 4k + e, floor division
  return byte_reverse(funnel_l(tab[PAD + k - 1], tab[PAD + k], 8 * (3 - e)));
}

// A lane's B registers and p's words of its block.
struct Consts {
  uint32_t g1[10];  // window of P' at x1 + 2y, y = -4..5 (index y + 4)
  uint32_t g2[10];  // window of p at 48 + x1 + 2y
  uint32_t e[3];    // the carry tile's: p at 46 + (g & 1) - 12t - 4z
  uint32_t pw[3];   // p's words 3t .. 3t + 2
};

// B column g of a tile is byte position 12 (g >> 1) + 2j + (g & 1) (+ 48 for
// m p's tiles); its k bytes 4t.. (k32 low half), 16 + 4t.. (k32 high half)
// and 4t.. (k16) multiply words 3t, 3t + 1, 3t + 2 of the A element, bytes
// 12t, 12t + 4, 12t + 8: entry (k, col) is Y[col - k].
MSM_HD void lane_consts(Consts& c, const uint32_t* tab, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int x1 = 12 * ((g >> 1) - t) + (g & 1);
  MSM_UNROLL
  for (int y = -4; y <= 5; ++y) {
    c.g1[y + 4] = window(tab, x1 + 2 * y);
    c.g2[y + 4] = window(tab + 36, 48 + x1 + 2 * y);
  }
  MSM_UNROLL
  for (int z = 0; z < 3; ++z)
    c.e[z] = g >= 6 ? window(tab + 36, 46 + (g & 1) - 12 * t - 4 * z) : 0u;
  MSM_UNROLL
  for (int i = 0; i < 3; ++i) c.pw[i] = tab[36 + PAD + 3 * t + i];
}

// The group element of quad g's slot u.
MSM_HD int elem_of(int g, int u) { return 16 * (u >> 1) + 8 * (u & 1) + g; }

MSM_HD void load_operands(uint32_t* x, uint32_t* y, const uint32_t* a,
                          const uint32_t* b, int64_t n, int64_t i) {
  const bool valid = i < n;
  MSM_UNROLL
  for (int k = 0; k < NW; ++k) {
    x[k] = valid ? a[k * n + i] : 0u;
    y[k] = valid ? b[k * n + i] : 0u;
  }
}

// t = x y, 24 words: per word of y, its even and odd word products in two
// carry chains (k2_mul.cuh add_even / add_odd), one word up each step.
MSM_HD void mul_wide_cc(uint32_t* t, const uint32_t* x, const uint32_t* y) {
  MSM_UNROLL
  for (int i = 0; i < 2 * NW; ++i) t[i] = 0;
  MSM_UNROLL
  for (int i = 0; i < NW; ++i) {
    Chain cc;
    add_even<NW>(cc, t + i, x, y[i]);
    add_odd<NW>(cc, t + i, x, y[i]);
  }
}

// T through the warp's rows in shared memory (sT: 32 rows of TPITCH words):
// each lane writes its element's words as its row; after the warp's sync,
// lane t of quad g reads words 3t .. 3t + 2 of T mod R (tl) and, for the
// full product, 12 + 3t .. 14 + 3t (th) of the rows 4g + u of its quad's
// slots u. TPITCH is odd, so the writes and the reads are conflict-free.
template <class W>
MSM_HD void stage_t(W& w, uint32_t* sT, const uint32_t* T, uint32_t (*tl)[4],
                    uint32_t (*th)[4], bool high, int lane) {
  uint32_t* row = sT + lane * TPITCH;
  MSM_UNROLL
  for (int j = 0; j < 2 * NW; ++j) row[j] = T[j];
  w.sync();
  const int g = lane >> 2, t = lane & 3;
  MSM_UNROLL
  for (int u = 0; u < 4; ++u) {
    const uint32_t* src = sT + (4 * g + u) * TPITCH;
    MSM_UNROLL
    for (int c = 0; c < 3; ++c) {
      tl[c][u] = src[3 * t + c];
      if (high) th[c][u] = src[NW + 3 * t + c];
    }
  }
  w.sync();  // every lane has read its columns before the next group's rows
}

// The words of one lane's block of an element: three words of position
// sums, the accumulators of tiles 2c (bytes 0, 1) and 2c + 1 (bytes 2, 3)
// of word c, each a pair (sum at byte 2h, sum at byte 2h + 1), plus `add`
// (three words; zero for m); b[0..2] the block's words, b[3] its carry out
// (< 2^17). acc[j] points at tile j's two sums of the element. A word's
// sums weigh below 2^47, so 64-bit partial sums hold every step.
MSM_HD void block_words(uint32_t* b, const int32_t* const* acc,
                        const uint32_t* add) {
  uint64_t s = 0;
  MSM_UNROLL
  for (int c = 0; c < 3; ++c) {
    const uint64_t l0 = (uint32_t)acc[2 * c][0] + ((uint32_t)acc[2 * c][1] << 8);
    const uint64_t l1 =
        (uint32_t)acc[2 * c + 1][0] + ((uint32_t)acc[2 * c + 1][1] << 8);
    s += l0 + (l1 << 16) + add[c];
    b[c] = (uint32_t)s;
    s >>= 32;
  }
  b[3] = (uint32_t)s;
}

// The 96-bit block b[0..2] plus cin: its words into r, the carry out.
MSM_HD uint32_t add_in(uint32_t* r, const uint32_t* b, uint32_t cin) {
  uint64_t s = cin;
  MSM_UNROLL
  for (int c = 0; c < 3; ++c) {
    s += b[c];
    r[c] = (uint32_t)s;
    s >>= 32;
  }
  return (uint32_t)s;
}

// The carries between the quad's blocks, lane 0's block first: each lane's
// block (b[3] its carry out) gets the carry in of the blocks below it, `cin`
// at lane 0. A block passes on one more carry than b[3] iff its two top
// words are all ones and b[0] + cin overflows. After round k lanes 0..k
// hold their true carry in; the carry out of lane 3 is dropped. The
// block's words with it into r.
template <class W>
MSM_HD void quad_carry(W& w, uint32_t* r, const uint32_t* b, uint32_t cin,
                       int lane) {
  const int t = lane & 3, below = (lane & ~3) | ((t + 3) & 3);
  const bool ones = (b[1] & b[2]) == 0xffffffffu;
  MSM_UNROLL
  for (int round = 0; round < 3; ++round) {
    const uint32_t out = b[3] + (ones && cin > ~b[0] ? 1u : 0u);
    const uint32_t got = w.shfl(out, below);
    if (t != 0) cin = got;
  }
  add_in(r, b, cin);
}

// r - p on a lane's block, the quad's borrows looked ahead: each lane's
// block borrows (r < p) or passes a borrow on (r == p); two shuffles OR the
// quad's four pairs of bits together. r if the whole r < p, else r - p.
template <class W>
MSM_HD void quad_csub(W& w, uint32_t* res, const uint32_t* r,
                      const uint32_t* pw, int lane) {
  const int t = lane & 3;
  uint32_t d[3];
  uint64_t s = 0;
  MSM_UNROLL
  for (int c = 0; c < 3; ++c) {
    s = (uint64_t)r[c] - pw[c] - (uint32_t)(s >> 63);
    d[c] = (uint32_t)s;
  }
  const uint32_t bo = (uint32_t)(s >> 63);
  const uint32_t eq = (r[0] == pw[0]) & (r[1] == pw[1]) & (r[2] == pw[2]);
  uint32_t bits = (bo << t) | (eq << (t + 8));
  bits |= w.shfl(bits, lane ^ 1);
  bits |= w.shfl(bits, lane ^ 2);
  const uint32_t G = (bits & 0xfu) << 1, P = (bits >> 8) & 0xfu;
  const uint32_t borrow = G | ((G + P) ^ G ^ P);  // bit i: into block i
  const bool ge = ((borrow >> 4) & 1u) == 0;      // no borrow out: r >= p
  s = 0;
  uint32_t bin = (borrow >> t) & 1u;
  MSM_UNROLL
  for (int c = 0; c < 3; ++c) {
    s = (uint64_t)d[c] - bin;
    bin = (uint32_t)(s >> 63);
    res[c] = ge ? (uint32_t)s : r[c];
  }
}

// Lane t's three words 3t .. 3t + 2 of each of its quad's slots (v[c][u]),
// for the elements below n.
MSM_HD void store_words(uint32_t* out, const uint32_t (*v)[4], int64_t n,
                        int64_t base, int lane) {
  const int g = lane >> 2, t = lane & 3;
  MSM_UNROLL
  for (int u = 0; u < 4; ++u) {
    const int64_t i = base + elem_of(g, u);
    if (i < n) {
      MSM_UNROLL
      for (int c = 0; c < 3; ++c) out[(3 * t + c) * n + i] = v[c][u];
    }
  }
}

// The A fragments of m16 tile mt from an operand held as v[c][u] (word 3t
// + c of slot u): rows g and g + 8 are slots 2mt and 2mt + 1; the k32 step's
// k bytes 4t.. and 16 + 4t.. are words 3t and 3t + 1, the k16 step's 3t + 2.
MSM_HD void a_fragments(uint32_t* a32, uint32_t* a16, const uint32_t (*v)[4],
                        int mt) {
  a32[0] = v[0][2 * mt];
  a32[1] = v[0][2 * mt + 1];
  a32[2] = v[1][2 * mt];
  a32[3] = v[1][2 * mt + 1];
  a16[0] = v[2][2 * mt];
  a16[1] = v[2][2 * mt + 1];
}

// One m16 tile's A times the six n8 tiles whose B registers are (b[j + 4],
// b[j + 2]) and b[j], Toeplitz windows two positions apart: acc[j], j < 6.
template <class W>
MSM_HD void toeplitz_tiles(W& w, int32_t (*acc)[4], const uint32_t* a32,
                           const uint32_t* a16, const uint32_t* b) {
  MSM_UNROLL
  for (int j = 0; j < 6; ++j) {
    int32_t* d = acc[j];
    d[0] = d[1] = d[2] = d[3] = 0;
    const uint32_t b32[2] = {b[j + 4], b[j + 2]};
    w.mma32(d, a32, b32);
    w.mma16(d, a16, b[j]);
  }
}

// One group of 32 elements: x, y this lane's element's operands; stores the
// stage's words of the group (elements base .. base + 31, those below n).
template <int STAGE, class W>
MSM_HD void group(W& w, const Consts& k, uint32_t* sT, const uint32_t* x,
                  const uint32_t* y, uint32_t* out, int64_t n, int64_t base,
                  int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t T[2 * NW];
  mul_wide_cc(T, x, y);
  if (STAGE == PROD) {
    const int64_t i = base + elem_of(g, t);
    if (i < n) {
      MSM_UNROLL
      for (int j = 0; j < NW; ++j) out[j * n + i] = T[j];
    }
    return;
  }
  // tl[c][u]: word 3t + c of T of slot u; th[c][u]: word 12 + 3t + c
  uint32_t tl[3][4], th[3][4];
  stage_t(w, sT, T, tl, th, STAGE == FULL, lane);

  if (STAGE == BYTES) {  // the A fragments of m's product, as they stand
    store_words(out, tl, n, base, lane);
    return;
  }

  // m = T P' mod R; acc[mt][j]: tile j of m tile mt (m p adds tile 6)
  int32_t acc[2][7][4];
  uint32_t a32[4], a16[2];
  MSM_UNROLL
  for (int mt = 0; mt < 2; ++mt) {
    a_fragments(a32, a16, tl, mt);
    toeplitz_tiles(w, acc[mt], a32, a16, k.g1);
  }
  uint32_t m[3][4];
  const uint32_t zero[3] = {0u, 0u, 0u};
  MSM_UNROLL
  for (int u = 0; u < 4; ++u) {
    const int32_t* sums[6];
    MSM_UNROLL
    for (int j = 0; j < 6; ++j) sums[j] = acc[u >> 1][j] + 2 * (u & 1);
    uint32_t blk[4], r[3];
    block_words(blk, sums, zero);
    quad_carry(w, r, blk, 0u, lane);
    MSM_UNROLL
    for (int c = 0; c < 3; ++c) m[c][u] = r[c];
  }
  if (STAGE == MM1) {
    store_words(out, m, n, base, lane);
    return;
  }

  // m p: the six high tiles, and the carry tile (positions 46, 47)
  MSM_UNROLL
  for (int mt = 0; mt < 2; ++mt) {
    a_fragments(a32, a16, m, mt);
    toeplitz_tiles(w, acc[mt], a32, a16, k.g2);
    int32_t* d = acc[mt][6];
    d[0] = d[1] = d[2] = d[3] = 0;
    const uint32_t b32[2] = {k.e[0], k.e[1]};
    w.mma32(d, a32, b32);
    w.mma16(d, a16, k.e[2]);
  }
  uint32_t res[3][4];
  MSM_UNROLL
  for (int u = 0; u < 4; ++u) {
    const int32_t* sums[6];
    MSM_UNROLL
    for (int j = 0; j < 6; ++j) sums[j] = acc[u >> 1][j] + 2 * (u & 1);
    const uint32_t tw[3] = {th[0][u], th[1][u], th[2][u]};
    uint32_t blk[4], r[3];
    block_words(blk, sums, tw);
    // lane 3: T's word 11 and positions 46, 47; the low half's carry
    const int32_t* s = acc[u >> 1][6] + 2 * (u & 1);
    const uint32_t top = (tl[2][u] >> 16) + (uint32_t)s[0] +
                         ((uint32_t)s[1] << 8);
    const uint32_t got = w.shfl((top + 0xffffu) >> 16, (lane & ~3) | 3);
    quad_carry(w, r, blk, t == 0 ? got : 0u, lane);
    uint32_t f[3];
    quad_csub(w, f, r, k.pw, lane);
    MSM_UNROLL
    for (int c = 0; c < 3; ++c) res[c][u] = f[c];
  }
  store_words(out, res, n, base, lane);
}

}  // namespace sos
}  // namespace msm
