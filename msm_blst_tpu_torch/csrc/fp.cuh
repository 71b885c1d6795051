// Shared device code of the port's kernels: BLS12-381 base-field arithmetic
// on twelve little-endian 32-bit words, Fp2 = Fp[i]/(i^2 + 1) on two of
// them, the xyzz point formulas, and the per-lane bodies of the kernels
// (mont_mul.cu; point_ops, scan and seg, each for G1 and G2).
//
// The formulas, loads, stores and per-lane bodies are templates over the
// coordinate field F: Fp for G1, Fp2 for G2. They call the field through
// one overload set (fp_add, fp_sub, fp_mul, ...), so the G1 instances are
// the same code as a G1-only header would give.
//
// Every value between operations is canonical (< p), exactly as in the JAX
// package's LimbField (msm_blst_tpu/fields/limb.py), and the Montgomery radix
// is R = 2^384 in both. The formulas below take the same steps, in the same
// order, with the same case selection as msm_blst_tpu/curves/ops.py, so the
// xyzz coordinates they produce are the same words as the JAX bodies give.
//
// Written once as host-and-device functions: the kernels inline them, the
// way the Pallas kernels trace curves/ops.py inside one pallas_call, and a
// host compiler can run the same code for a check without a card.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define MSM_HD __host__ __device__ __forceinline__
#define MSM_HD_NOINLINE static __host__ __device__ __noinline__
#define MSM_UNROLL _Pragma("unroll")
#else
#define MSM_HD inline
#define MSM_HD_NOINLINE static inline
#define MSM_UNROLL
#endif

namespace msm {

constexpr int NW = 12;  // 32-bit words of an Fp element

// A prime modulus of N little-endian 32-bit words: its words, R mod it
// (Montgomery one, R = 2^(32N)) and n0 = -modulus^-1 mod 2^32. BLS12-381's
// base field p is the 12-word instance; the 8-word scalar field takes its
// own specialisation when a kernel needs it.
template <int N>
struct Modulus;

template <>
struct Modulus<12> {
  static MSM_HD uint32_t word(int i) {
    switch (i) {
      case 0: return 0xffffaaabu;
      case 1: return 0xb9feffffu;
      case 2: return 0xb153ffffu;
      case 3: return 0x1eabfffeu;
      case 4: return 0xf6b0f624u;
      case 5: return 0x6730d2a0u;
      case 6: return 0xf38512bfu;
      case 7: return 0x64774b84u;
      case 8: return 0x434bacd7u;
      case 9: return 0x4b1ba7b6u;
      case 10: return 0x397fe69au;
      default: return 0x1a0111eau;
    }
  }
  static MSM_HD uint32_t one_mont(int i) {
    switch (i) {
      case 0: return 0x0002fffdu;
      case 1: return 0x76090000u;
      case 2: return 0xc40c0002u;
      case 3: return 0xebf4000bu;
      case 4: return 0x53c758bau;
      case 5: return 0x5f489857u;
      case 6: return 0x70525745u;
      case 7: return 0x77ce5853u;
      case 8: return 0xa256ec6du;
      case 9: return 0x5c071a97u;
      case 10: return 0xfa80e493u;
      default: return 0x15f65ec3u;
    }
  }
  static constexpr uint32_t n0 = 0xfffcfffdu;
};

using P12 = Modulus<NW>;

struct Fp {
  uint32_t w[NW];
};

// c0 + c1*i; each component canonical, so products are unique words. The
// component type B is Fp, or a field of the same words with a product of
// its own (k2_mul.cuh's FpK2).
template <class B>
struct Fp2T {
  B c0, c1;
};
using Fp2 = Fp2T<Fp>;

// Words of one element in the row and column layouts.
template <class F>
struct Words;
template <>
struct Words<Fp> {
  static constexpr int value = NW;
};
template <class B>
struct Words<Fp2T<B>> {
  static constexpr int value = 2 * NW;
};

template <class F>
struct XyzzT {
  F x, y, zzz, zz;
};

template <class F>
struct AffT {
  F x, y;
};

// ---- field -----------------------------------------------------------------

MSM_HD bool fp_is_zero(const Fp& a) {
  uint32_t acc = 0;
  MSM_UNROLL
  for (int i = 0; i < NW; ++i) acc |= a.w[i];
  return acc == 0;
}

MSM_HD void fp_zero(Fp& r) {
  MSM_UNROLL
  for (int i = 0; i < NW; ++i) r.w[i] = 0;
}

MSM_HD void fp_set_one_mont(Fp& r) {
  MSM_UNROLL
  for (int i = 0; i < NW; ++i) r.w[i] = P12::one_mont(i);
}

// r = t - m if t >= m else t, for t < 2m held in N words (the modulus is
// below 2^(32N) / 4, so a value below 2m never reaches the top bit).
template <int N>
MSM_HD void reduce_once(uint32_t* r, const uint32_t* t) {
  uint32_t d[N];
  uint32_t borrow = 0;
  MSM_UNROLL
  for (int i = 0; i < N; ++i) {
    uint64_t s = (uint64_t)t[i] - Modulus<N>::word(i) - borrow;
    d[i] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  MSM_UNROLL
  for (int i = 0; i < N; ++i) r[i] = borrow ? t[i] : d[i];
}

MSM_HD void fp_add(Fp& r, const Fp& a, const Fp& b) {
  uint32_t s[NW];
  uint64_t c = 0;
  MSM_UNROLL
  for (int i = 0; i < NW; ++i) {
    c += (uint64_t)a.w[i] + b.w[i];
    s[i] = (uint32_t)c;
    c >>= 32;
  }
  reduce_once<NW>(r.w, s);  // a + b < 2p < 2^382: no carry out of word 11
}

MSM_HD void fp_sub(Fp& r, const Fp& a, const Fp& b) {
  uint32_t d[NW];
  uint32_t borrow = 0;
  MSM_UNROLL
  for (int i = 0; i < NW; ++i) {
    uint64_t s = (uint64_t)a.w[i] - b.w[i] - borrow;
    d[i] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  uint32_t mask = 0u - borrow;  // a < b: add p back
  uint64_t c = 0;
  MSM_UNROLL
  for (int i = 0; i < NW; ++i) {
    c += (uint64_t)d[i] + (P12::word(i) & mask);
    r.w[i] = (uint32_t)c;
    c >>= 32;
  }
}

MSM_HD void fp_neg(Fp& r, const Fp& a) {
  Fp z;
  fp_zero(z);
  fp_sub(r, z, a);
}

MSM_HD void fp_mul3(Fp& r, const Fp& a) {
  Fp t;
  fp_add(t, a, a);
  fp_add(r, t, a);
}

// Montgomery product a*b*2^(-32N) mod m: CIOS over 32-bit words with
// 64-bit partial sums (a word product plus two words never exceeds
// 2^64 - 1). With a, b < m < 2^(32N) / 4 every intermediate stays below 2m,
// so the running value fits N words plus one spare word that ends at zero.
template <int N>
MSM_HD void mont_mul(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t t[N + 2];
  MSM_UNROLL
  for (int i = 0; i < N + 2; ++i) t[i] = 0;
  MSM_UNROLL
  for (int i = 0; i < N; ++i) {
    uint64_t c = 0;
    MSM_UNROLL
    for (int j = 0; j < N; ++j) {
      uint64_t s = (uint64_t)a[i] * b[j] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[N] + c;
    t[N] = (uint32_t)s;
    t[N + 1] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * Modulus<N>::n0;
    s = (uint64_t)m * Modulus<N>::word(0) + t[0];
    c = s >> 32;
    MSM_UNROLL
    for (int j = 1; j < N; ++j) {
      s = (uint64_t)m * Modulus<N>::word(j) + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[N] + c;
    t[N - 1] = (uint32_t)s;
    t[N] = t[N + 1] + (uint32_t)(s >> 32);
  }
  reduce_once<N>(r, t);
}

MSM_HD void fp_mul(Fp& r, const Fp& a, const Fp& b) {
  mont_mul<NW>(r.w, a.w, b.w);
}

// ---- Fp2: the same overload set over (c0, c1) --------------------------------

template <class B>
MSM_HD bool fp_is_zero(const Fp2T<B>& a) {
  return fp_is_zero(a.c0) && fp_is_zero(a.c1);
}

template <class B>
MSM_HD void fp_zero(Fp2T<B>& r) {
  fp_zero(r.c0);
  fp_zero(r.c1);
}

template <class B>
MSM_HD void fp_set_one_mont(Fp2T<B>& r) {
  fp_set_one_mont(r.c0);
  fp_zero(r.c1);
}

template <class B>
MSM_HD void fp_add(Fp2T<B>& r, const Fp2T<B>& a, const Fp2T<B>& b) {
  fp_add(r.c0, a.c0, b.c0);
  fp_add(r.c1, a.c1, b.c1);
}

template <class B>
MSM_HD void fp_sub(Fp2T<B>& r, const Fp2T<B>& a, const Fp2T<B>& b) {
  fp_sub(r.c0, a.c0, b.c0);
  fp_sub(r.c1, a.c1, b.c1);
}

template <class B>
MSM_HD void fp_neg(Fp2T<B>& r, const Fp2T<B>& a) {
  fp_neg(r.c0, a.c0);
  fp_neg(r.c1, a.c1);
}

template <class B>
MSM_HD void fp_mul3(Fp2T<B>& r, const Fp2T<B>& a) {
  Fp2T<B> t;
  fp_add(t, a, a);
  fp_add(r, t, a);
}

// Karatsuba, as msm_blst_tpu/fields/fp2.py mul_many: three Montgomery
// products, (a0 b0 - a1 b1) + ((a0 + a1)(b0 + b1) - a0 b0 - a1 b1) i. r may
// alias a or b. Not inlined: a G2 formula calls it a dozen or more times,
// and one body per kernel keeps the kernels' code and build time small
// (static: each source that includes this header has its own copy).
template <class B>
MSM_HD_NOINLINE void fp_mul(Fp2T<B>& r, const Fp2T<B>& a, const Fp2T<B>& b) {
  B t0, t1, t2, sa, sb;
  fp_mul(t0, a.c0, b.c0);
  fp_mul(t1, a.c1, b.c1);
  fp_add(sa, a.c0, a.c1);
  fp_add(sb, b.c0, b.c1);
  fp_mul(t2, sa, sb);
  fp_sub(r.c0, t0, t1);
  fp_sub(t2, t2, t0);
  fp_sub(r.c1, t2, t1);
}

// ---- xyzz point formulas (a = 0; infinity is ZZ == ZZZ == 0) ---------------

template <class F>
MSM_HD bool xyzz_is_inf(const XyzzT<F>& p) {
  return fp_is_zero(p.zz) && fp_is_zero(p.zzz);
}

template <class F>
MSM_HD void xyzz_set_inf(XyzzT<F>& p) {
  fp_zero(p.x);
  fp_zero(p.y);
  fp_zero(p.zzz);
  fp_zero(p.zz);
}

// curves/ops.py xyzz_from_affine(p, negate=sub)
template <class F>
MSM_HD void xyzz_from_affine(XyzzT<F>& o, const AffT<F>& p, bool sub) {
  bool inf = fp_is_zero(p.x) && fp_is_zero(p.y);
  o.x = p.x;
  if (sub) {
    fp_neg(o.y, p.y);
  } else {
    o.y = p.y;
  }
  if (inf) {
    fp_zero(o.zz);
  } else {
    fp_set_one_mont(o.zz);
  }
  o.zzz = o.zz;
}

// dbl-2008-s-1 (curves/ops.py xyzz_double). No infinity case: ZZ3 = V*ZZ
// and ZZZ3 = W*ZZZ stay zero for an infinite input.
template <class F>
MSM_HD void xyzz_double(XyzzT<F>& o, const XyzzT<F>& p) {
  F U, V, A, M, W, S, MM, X3, t, T1, T2, ZZZ3, ZZ3;
  fp_add(U, p.y, p.y);
  fp_mul(V, U, U);
  fp_mul(A, p.x, p.x);
  fp_mul3(M, A);
  fp_mul(W, U, V);
  fp_mul(S, p.x, V);
  fp_mul(MM, M, M);
  fp_add(t, S, S);
  fp_sub(X3, MM, t);
  fp_sub(t, S, X3);
  fp_mul(T1, M, t);
  fp_mul(T2, W, p.y);
  fp_mul(ZZZ3, p.zzz, W);
  fp_mul(ZZ3, p.zz, V);
  o.x = X3;
  fp_sub(o.y, T1, T2);
  o.zzz = ZZZ3;
  o.zz = ZZ3;
}

// add-2008-s with the full case analysis (curves/ops.py xyzz_dadd_body):
// P == Q doubles, P == -Q gives infinity, an infinite operand yields the
// other one. The batch-level cond of the JAX body is a per-thread branch.
template <class F>
MSM_HD void xyzz_dadd(XyzzT<F>& o, const XyzzT<F>& p1, const XyzzT<F>& p2) {
  F U1, S1, U2, S2, ZZp, ZZZp, Pv, Rv, PP, RR, PPP, Q, X3, t, T1, T2;
  XyzzT<F> res;
  fp_mul(U1, p1.x, p2.zz);
  fp_mul(S1, p1.y, p2.zzz);
  fp_mul(U2, p2.x, p1.zz);
  fp_mul(S2, p2.y, p1.zzz);
  fp_mul(ZZp, p1.zz, p2.zz);
  fp_mul(ZZZp, p1.zzz, p2.zzz);
  fp_sub(Pv, U2, U1);
  fp_sub(Rv, S2, S1);
  fp_mul(PP, Pv, Pv);
  fp_mul(RR, Rv, Rv);
  fp_mul(PPP, PP, Pv);
  fp_mul(Q, U1, PP);
  fp_sub(t, RR, PPP);
  fp_add(X3, Q, Q);
  fp_sub(res.x, t, X3);
  fp_sub(t, Q, res.x);
  fp_mul(T1, Rv, t);
  fp_mul(T2, S1, PPP);
  fp_mul(res.zz, ZZp, PP);
  fp_mul(res.zzz, ZZZp, PPP);
  fp_sub(res.y, T1, T2);

  bool p1_inf = xyzz_is_inf(p1);
  bool p2_inf = xyzz_is_inf(p2);
  bool p_zero = fp_is_zero(Pv);
  bool r_zero = fp_is_zero(Rv);
  if (p_zero && r_zero && !p1_inf && !p2_inf) xyzz_double(res, p1);
  if (p_zero && !r_zero && !p1_inf && !p2_inf) xyzz_set_inf(res);
  if (p2_inf) res = p1;
  if (p1_inf) res = p2;
  o = res;
}

// Signed madd-2008-s (curves/ops.py xyzz_dadd_affine_body): o = p1 +- p2.
template <class F>
MSM_HD void xyzz_dadd_affine(XyzzT<F>& o, const XyzzT<F>& p1, const AffT<F>& p2,
                             bool sub) {
  F y2, P0, R0, Pv, Rv, PP, RR, PPP, Q, X3, t, T1, T2;
  XyzzT<F> res;
  if (sub) {
    fp_neg(y2, p2.y);
  } else {
    y2 = p2.y;
  }
  fp_mul(P0, p2.x, p1.zz);
  fp_mul(R0, y2, p1.zzz);
  fp_sub(Pv, P0, p1.x);
  fp_sub(Rv, R0, p1.y);
  fp_mul(PP, Pv, Pv);
  fp_mul(RR, Rv, Rv);
  fp_mul(PPP, PP, Pv);
  fp_mul(Q, p1.x, PP);
  fp_sub(t, RR, PPP);
  fp_add(X3, Q, Q);
  fp_sub(res.x, t, X3);
  fp_sub(t, Q, res.x);
  fp_mul(T1, Rv, t);
  fp_mul(T2, p1.y, PPP);
  fp_mul(res.zz, p1.zz, PP);
  fp_mul(res.zzz, p1.zzz, PPP);
  fp_sub(res.y, T1, T2);

  bool p1_inf = xyzz_is_inf(p1);
  bool p2_inf = fp_is_zero(p2.x) && fp_is_zero(p2.y);
  bool p_zero = fp_is_zero(Pv);
  bool r_zero = fp_is_zero(Rv);
  if (p_zero && r_zero && !p1_inf && !p2_inf) {
    F U, V, A, M, W, S, MM, T3, T4;
    fp_add(U, y2, y2);
    fp_mul(V, U, U);
    fp_mul(A, p2.x, p2.x);
    fp_mul3(M, A);
    fp_mul(W, U, V);
    fp_mul(S, p2.x, V);
    fp_mul(MM, M, M);
    fp_add(t, S, S);
    fp_sub(res.x, MM, t);
    fp_sub(t, S, res.x);
    fp_mul(T3, M, t);
    fp_mul(T4, W, y2);
    fp_sub(res.y, T3, T4);
    res.zzz = W;
    res.zz = V;
  }
  if (p_zero && !r_zero && !p1_inf && !p2_inf) xyzz_set_inf(res);
  if (p1_inf) xyzz_from_affine(res, p2, sub);
  if (p2_inf) res = p1;
  o = res;
}

// ---- loads and stores --------------------------------------------------------
// Column layout: an Fp batch is [NW, n] words, element i's word k at k*n + i,
// so neighbouring threads read neighbouring words; an Fp2 batch is
// [2, NW, n], component c's word k at (c*NW + k)*n + i. Row layout: element
// e's words are contiguous at e*stride, an Fp2 element c0's words then c1's.

MSM_HD void load_col(Fp& r, const uint32_t* base, int64_t n, int64_t i) {
  MSM_UNROLL
  for (int k = 0; k < NW; ++k) r.w[k] = base[k * n + i];
}

MSM_HD void store_col(uint32_t* base, const Fp& a, int64_t n, int64_t i) {
  MSM_UNROLL
  for (int k = 0; k < NW; ++k) base[k * n + i] = a.w[k];
}

MSM_HD void load_row(Fp& r, const uint32_t* row) {
  MSM_UNROLL
  for (int k = 0; k < NW; ++k) r.w[k] = row[k];
}

MSM_HD void store_row(uint32_t* row, const Fp& a) {
  MSM_UNROLL
  for (int k = 0; k < NW; ++k) row[k] = a.w[k];
}

template <class B>
MSM_HD void load_col(Fp2T<B>& r, const uint32_t* base, int64_t n, int64_t i) {
  load_col(r.c0, base, n, i);
  load_col(r.c1, base + NW * n, n, i);
}

template <class B>
MSM_HD void store_col(uint32_t* base, const Fp2T<B>& a, int64_t n, int64_t i) {
  store_col(base, a.c0, n, i);
  store_col(base + NW * n, a.c1, n, i);
}

template <class B>
MSM_HD void load_row(Fp2T<B>& r, const uint32_t* row) {
  load_row(r.c0, row);
  load_row(r.c1, row + NW);
}

template <class B>
MSM_HD void store_row(uint32_t* row, const Fp2T<B>& a) {
  store_row(row, a.c0);
  store_row(row + NW, a.c1);
}

// The four xyzz coordinates of a column-layout batch (each [Words<F>, n]).
struct XyzzCols {
  const uint32_t *x, *y, *zzz, *zz;
};

struct XyzzColsOut {
  uint32_t *x, *y, *zzz, *zz;
};

template <class F>
MSM_HD void load_xyzz(XyzzT<F>& p, const XyzzCols& c, int64_t n, int64_t i) {
  load_col(p.x, c.x, n, i);
  load_col(p.y, c.y, n, i);
  load_col(p.zzz, c.zzz, n, i);
  load_col(p.zz, c.zz, n, i);
}

template <class F>
MSM_HD void store_xyzz(const XyzzColsOut& c, const XyzzT<F>& p, int64_t n,
                       int64_t i) {
  store_col(c.x, p.x, n, i);
  store_col(c.y, p.y, n, i);
  store_col(c.zzz, p.zzz, n, i);
  store_col(c.zz, p.zz, n, i);
}

// ---- per-element kernel bodies -------------------------------------------------

// K1: out[:, i] = a[:, i] * b[:, i] * 2^(-32N) mod m, batches [N, n]
template <int N>
MSM_HD void mont_mul_elem(const uint32_t* a, const uint32_t* b, uint32_t* out,
                          int64_t n, int64_t i) {
  uint32_t x[N], y[N], r[N];
  MSM_UNROLL
  for (int k = 0; k < N; ++k) {
    x[k] = a[k * n + i];
    y[k] = b[k * n + i];
  }
  mont_mul<N>(r, x, y);
  MSM_UNROLL
  for (int k = 0; k < N; ++k) out[k * n + i] = r[k];
}

// K2, one lane of dadd_affine (its dadd and double kernels add through
// point_ops.cuh's per-field add and doubling).
template <class F>
MSM_HD void dadd_affine_elem(XyzzCols p1, const uint32_t* x2, const uint32_t* y2,
                             const int32_t* sign, XyzzColsOut o, int64_t n,
                             int64_t i) {
  XyzzT<F> a, r;
  AffT<F> b;
  load_xyzz(a, p1, n, i);
  load_col(b.x, x2, n, i);
  load_col(b.y, y2, n, i);
  xyzz_dadd_affine(r, a, b, sign[i] != 0);
  store_xyzz(o, r, n, i);
}

}  // namespace msm
