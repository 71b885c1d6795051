// K2's own field: the coordinate fields of K2's kernels (point_ops.cuh), with
// the Montgomery product written on the H100's carry chains.
//
// FpK2 is Fp under another name, so every formula, load and store of fp.cuh
// takes it as it takes Fp (a derived-to-base binding); only fp_mul has an
// overload of its own, and Fp2K2 = Fp2T<FpK2> runs Karatsuba on it. K3, K4,
// K5 and K9 keep Fp and Fp2, and fp.cuh's portable product with them.
//
// The product (mont_mul_cc) is CIOS as fp.cuh's mont_mul, one word of b a
// step, on a 13-word accumulator t, with the word products split by the
// parity of their index: the products a[j] b of even j lie in distinct word
// pairs (low half at word j, high half at j + 1), so one carry chain of
// mad.lo.cc / madc.hi.cc adds all of them; those of odd j are a second
// chain one word up. Each word product is then two multiply-adds with the
// carry in the flag, where the portable product forms a 64-bit product and
// two 64-bit adds. The reduction m p adds the same two chains. The steps:
//
//   t = a b[0]                       (even: mul.lo / mul.hi; odd: a chain)
//   for each step i (b[i] added first, except at i = 0):
//     t += EVEN(a, b[i]); t[12] += carry    t += ODD(a, b[i]) (at word 1)
//     m = t[0] n0;  t += EVEN(p, m); t[12] += carry;  t += ODD(p, m)
//     t >>= 32                        (t[0] is 0 by the choice of m)
//   r = t - p if t >= p else t        (sub.cc / subc.cc, then a select)
//
// With a, b < p < 2^381 the accumulator stays below 2p + 2^33 p < 2^415
// within a step and below 2p after it (CIOS's bound), so 13 words hold it,
// every partial sum of a step too (the terms are not negative): the odd
// chains end without a carry out, and one conditional subtraction makes the
// result the canonical product, the same words as fp.cuh's mont_mul.
//
// The instructions are PTX inline assembly on the card (__CUDA_ARCH__). On
// the host, Chain emulates each one with its carry bit, so a g++ harness can
// run the same sequence and hold it against mont_mul; the host twin of
// fp_mul(FpK2) is fp.cuh's mont_mul.

#pragma once

#include "fp.cuh"

namespace msm {

struct FpK2 : Fp {};

template <>
struct Words<FpK2> {
  static constexpr int value = NW;
};

using Fp2K2 = Fp2T<FpK2>;

// One carry chain: the flag is the card's CC.CF; on the host, `cf`.
struct Chain {
  uint32_t cf = 0;

  // mad.lo.cc: lo(a b) + c, carry out
  MSM_HD uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
#ifdef __CUDA_ARCH__
    uint32_t d;
    asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;"
                 : "=r"(d)
                 : "r"(a), "r"(b), "r"(c));
    return d;
#else
    uint64_t s = (uint64_t)(uint32_t)(a * b) + c;
    cf = (uint32_t)(s >> 32);
    return (uint32_t)s;
#endif
  }
  // madc.lo.cc: lo(a b) + c + carry, carry out
  MSM_HD uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
#ifdef __CUDA_ARCH__
    uint32_t d;
    asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;"
                 : "=r"(d)
                 : "r"(a), "r"(b), "r"(c));
    return d;
#else
    uint64_t s = (uint64_t)(uint32_t)(a * b) + c + cf;
    cf = (uint32_t)(s >> 32);
    return (uint32_t)s;
#endif
  }
  // madc.hi.cc: hi(a b) + c + carry, carry out
  MSM_HD uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
#ifdef __CUDA_ARCH__
    uint32_t d;
    asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;"
                 : "=r"(d)
                 : "r"(a), "r"(b), "r"(c));
    return d;
#else
    uint64_t s = (((uint64_t)a * b) >> 32) + c + cf;
    cf = (uint32_t)(s >> 32);
    return (uint32_t)s;
#endif
  }
  // madc.hi: hi(a b) + c + carry, the carry out dropped (none can occur)
  MSM_HD uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
#ifdef __CUDA_ARCH__
    uint32_t d;
    asm volatile("madc.hi.u32 %0, %1, %2, %3;"
                 : "=r"(d)
                 : "r"(a), "r"(b), "r"(c));
    return d;
#else
    return (uint32_t)((((uint64_t)a * b) >> 32) + c + cf);
#endif
  }
  // addc: a + b + carry, the carry out dropped (none can occur)
  MSM_HD uint32_t addc(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
    uint32_t d;
    asm volatile("addc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
#else
    return a + b + cf;
#endif
  }
  // sub.cc: a - b, borrow out
  MSM_HD uint32_t sub_cc(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
    uint32_t d;
    asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
#else
    cf = a < b;
    return a - b;
#endif
  }
  // subc.cc: a - (b + borrow), borrow out
  MSM_HD uint32_t subc_cc(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
    uint32_t d;
    asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
#else
    uint64_t bb = (uint64_t)b + cf;
    cf = (uint64_t)a < bb;
    return (uint32_t)(a - bb);
#endif
  }
  // subc: a - (b + borrow)
  MSM_HD uint32_t subc(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
    uint32_t d;
    asm volatile("subc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
#else
    return a - b - cf;
#endif
  }
};

// t[0..N-1] += EVEN(x, y) (the word products x[j] y of even j), the carry
// into t[N].
template <int N>
MSM_HD void add_even(Chain& cc, uint32_t* t, const uint32_t* x, uint32_t y) {
  t[0] = cc.mad_lo_cc(x[0], y, t[0]);
  t[1] = cc.madc_hi_cc(x[0], y, t[1]);
  MSM_UNROLL
  for (int j = 2; j < N; j += 2) {
    t[j] = cc.madc_lo_cc(x[j], y, t[j]);
    t[j + 1] = cc.madc_hi_cc(x[j], y, t[j + 1]);
  }
  t[N] = cc.addc(t[N], 0);
}

// t[1..N] += ODD(x, y) (the word products x[j] y of odd j, one word up).
template <int N>
MSM_HD void add_odd(Chain& cc, uint32_t* t, const uint32_t* x, uint32_t y) {
  t[1] = cc.mad_lo_cc(x[1], y, t[1]);
  t[2] = cc.madc_hi_cc(x[1], y, t[2]);
  MSM_UNROLL
  for (int j = 3; j < N - 1; j += 2) {
    t[j] = cc.madc_lo_cc(x[j], y, t[j]);
    t[j + 1] = cc.madc_hi_cc(x[j], y, t[j + 1]);
  }
  t[N - 1] = cc.madc_lo_cc(x[N - 1], y, t[N - 1]);
  t[N] = cc.madc_hi(x[N - 1], y, t[N]);
}

// t = (t + m p) / 2^32 with m = t[0] n0, t[N] 0 afterwards.
template <int N>
MSM_HD void reduce_step(Chain& cc, uint32_t* t) {
  uint32_t p[N];
  MSM_UNROLL
  for (int j = 0; j < N; ++j) p[j] = Modulus<N>::word(j);
  uint32_t m = t[0] * Modulus<N>::n0;
  add_even<N>(cc, t, p, m);
  add_odd<N>(cc, t, p, m);
  MSM_UNROLL
  for (int j = 0; j < N; ++j) t[j] = t[j + 1];
  t[N] = 0;
}

// The Montgomery product a b 2^(-32N) mod m, canonical, for a, b < m with
// m < 2^(32N) / 4 (the bounds above): fp.cuh's mont_mul on carry chains.
template <int N>
MSM_HD void mont_mul_cc(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  static_assert(N % 2 == 0, "the even/odd split pairs the words");
  Chain cc;
  uint32_t t[N + 1];
  MSM_UNROLL
  for (int j = 0; j < N; j += 2) {  // EVEN(a, b[0]): distinct word pairs
    t[j] = a[j] * b[0];
#ifdef __CUDA_ARCH__
    t[j + 1] = __umulhi(a[j], b[0]);
#else
    t[j + 1] = (uint32_t)(((uint64_t)a[j] * b[0]) >> 32);
#endif
  }
  t[N] = 0;
  add_odd<N>(cc, t, a, b[0]);
  reduce_step<N>(cc, t);
  MSM_UNROLL
  for (int i = 1; i < N; ++i) {
    add_even<N>(cc, t, a, b[i]);
    add_odd<N>(cc, t, a, b[i]);
    reduce_step<N>(cc, t);
  }
  uint32_t d[N];
  d[0] = cc.sub_cc(t[0], Modulus<N>::word(0));
  MSM_UNROLL
  for (int j = 1; j < N; ++j) d[j] = cc.subc_cc(t[j], Modulus<N>::word(j));
  uint32_t borrow = cc.subc(0, 0);  // all ones when t < m
  MSM_UNROLL
  for (int j = 0; j < N; ++j) r[j] = borrow ? t[j] : d[j];
}

MSM_HD void fp_mul(FpK2& r, const FpK2& a, const FpK2& b) {
#ifdef __CUDA_ARCH__
  mont_mul_cc<NW>(r.w, a.w, b.w);
#else
  mont_mul<NW>(r.w, a.w, b.w);
#endif
}

}  // namespace msm
