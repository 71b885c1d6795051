// Native host-side runtime of msm_blst_tpu_torch: scalar recoding + MSM
// parameter-table construction (a copy of the JAX package's
// native/recode.cpp, built by msm_blst_tpu_torch/native.py at first use).
//
// The port's counterpart of the reference's native conversion passes
// (behavioral specs):
//   * q-ary digit split             — auxiliaryfunc.h:83-90
//   * integral MB-radix-q recode    — src/multi_scalar.c:748-775 (carry chain)
//   * BGMW95 q/2 signed recode      — auxiliaryfunc.h:130-145 + the r-a
//                                     group-order fold of main_p1.cpp:311-356
//   * bucket-set construction       — auxiliaryfunc.h:257-288
//   * digit conversion hash table   — main_p1.cpp:139-153
//
// Layouts (match numpy C-order arrays passed from ctypes):
//   scalars: uint32[8][n]  (row-major: limb-major, little-endian limbs)
//   digit outputs: [h][n]
//
// Recoding is embarrassingly parallel over scalars; a std::thread pool
// splits the n axis.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kLimbs = 8;

inline uint32_t limb(const uint32_t* scalars, int64_t n, int i, int64_t j) {
  return scalars[static_cast<int64_t>(i) * n + j];
}

// digit d of scalar j: bits [d*c, (d+1)*c) of the 256-bit little-endian value
inline int64_t qary_digit(const uint32_t* scalars, int64_t n, int64_t j, int c,
                          int d) {
  const int bit = d * c;
  const int w = bit >> 5, off = bit & 31;
  if (w >= kLimbs) return 0;  // windows past bit 256 are zero (c*h > 256)
  uint64_t v = limb(scalars, n, w, j) >> off;
  if (off + c > 32 && w + 1 < kLimbs)
    v |= static_cast<uint64_t>(limb(scalars, n, w + 1, j)) << (32 - off);
  if (off + c > 64 && w + 2 < kLimbs)
    v |= static_cast<uint64_t>(limb(scalars, n, w + 2, j)) << (64 - off);
  return static_cast<int64_t>(v & ((1ull << c) - 1));
}

template <typename F>
void parallel_over(int64_t n, F&& fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int64_t nthreads = hw ? static_cast<int64_t>(hw) : 4;
  if (nthreads > n / 4096) nthreads = n / 4096 ? n / 4096 : 1;
  if (nthreads <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> pool;
  int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int64_t t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk, hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    pool.emplace_back([=, &fn] { fn(lo, hi); });
  }
  for (auto& th : pool) th.join();
}

// omega2(i) + omega3(i) parity (auxiliaryfunc.h:257-288 helper)
inline bool omega23_even(int64_t i) {
  int e = 0;
  while (i % 2 == 0) { ++e; i /= 2; }
  while (i % 3 == 0) { ++e; i /= 3; }
  return (e & 1) == 0;
}

}  // namespace

extern "C" {

// Standard q-ary digits: digits[h][n].
void msm_qary_digits(const uint32_t* scalars, int64_t n, int c, int h,
                     int32_t* digits) {
  parallel_over(n, [&](int64_t lo, int64_t hi) {
    for (int64_t j = lo; j < hi; ++j)
      for (int d = 0; d < h; ++d)
        digits[static_cast<int64_t>(d) * n + j] =
            static_cast<int32_t>(qary_digit(scalars, n, j, c, d));
  });
}

// Integral MB-radix-q conversion with carry. Tables are int32[q+1]
// (m, b, alpha). Outputs b_out/m_out int32[h][n], s_out uint8[h][n].
// Returns 0 on success, -1 if a leading-digit carry escaped (config error).
int msm_ches_recode(const uint32_t* scalars, int64_t n, int c, int h,
                    const int32_t* m_t, const int32_t* b_t, const int32_t* a_t,
                    int32_t* b_out, int32_t* m_out, uint8_t* s_out) {
  int bad = 0;
  parallel_over(n, [&](int64_t lo, int64_t hi) {
    for (int64_t j = lo; j < hi; ++j) {
      int32_t carry = 0;
      for (int d = 0; d < h; ++d) {
        const int64_t dig = qary_digit(scalars, n, j, c, d) + carry;
        const int64_t idx = static_cast<int64_t>(d) * n + j;
        b_out[idx] = b_t[dig];
        m_out[idx] = m_t[dig];
        const int32_t alpha = a_t[dig];
        s_out[idx] = static_cast<uint8_t>(alpha == 1);
        carry = alpha;
      }
      if (carry) bad = 1;  // leading digit carried: parameters invalid
    }
  });
  return bad ? -1 : 0;
}

// BGMW95 signed q/2 recode. If fold != 0, scalars with top-64-bits > 2^62
// are replaced by r - a (r passed as 8 uint32 limbs) and all signs flipped.
// absd int32[h][n], sign uint8[h][n]. Returns 0, or -1 if a leading digit
// exceeded q/2.
int msm_bgmw_recode(const uint32_t* scalars, int64_t n, int c, int h, int fold,
                    const uint32_t* r_limbs, int32_t* absd, uint8_t* sign) {
  const int64_t q = 1ll << c, half = q >> 1;
  int bad = 0;
  parallel_over(n, [&](int64_t lo, int64_t hi) {
    std::vector<int64_t> dig(h);
    uint32_t local[kLimbs];
    for (int64_t j = lo; j < hi; ++j) {
      const uint32_t* src = nullptr;
      bool flipped = false;
      if (fold) {
        const uint64_t top =
            (static_cast<uint64_t>(limb(scalars, n, 7, j)) << 32) |
            limb(scalars, n, 6, j);
        flipped = top > (1ull << 62);
      }
      if (flipped) {
        // local = r - a (scalars are < r, so no final borrow)
        int64_t borrow = 0;
        for (int i = 0; i < kLimbs; ++i) {
          const int64_t d = static_cast<int64_t>(r_limbs[i]) -
                            static_cast<int64_t>(limb(scalars, n, i, j)) -
                            borrow;
          borrow = d < 0;
          local[i] = static_cast<uint32_t>(d & 0xffffffffll);
        }
        src = local;
      }
      int64_t carry = 0;
      for (int d = 0; d < h; ++d) {
        int64_t v = (flipped ? qary_digit(src, 1, 0, c, d)
                             : qary_digit(scalars, n, j, c, d)) +
                    carry;
        carry = 0;
        if (d < h - 1 && v > half) {
          v -= q;
          carry = 1;
        }
        if (d == h - 1 && v > half) bad = 1;
        const int64_t idx = static_cast<int64_t>(d) * n + j;
        const bool neg = (v < 0) != flipped && v != 0;
        absd[idx] = static_cast<int32_t>(v < 0 ? -v : v);
        sign[idx] = static_cast<uint8_t>(v == 0 ? 0 : neg);
      }
    }
  });
  return bad ? -1 : 0;
}

// CHES bucket set (auxiliaryfunc.h:257-288 sieve, order-preserved).
// out must hold q/2 + 2 entries; returns the set size.
int64_t msm_construct_bucket_set(int64_t q, int64_t ah, int32_t* out) {
  const int64_t half = q / 2;
  std::vector<uint8_t> mem(half + 1, 0);
  mem[0] = mem[1] = 1;
  for (int64_t i = 2; i <= half; ++i) mem[i] = omega23_even(i);
  for (int64_t i = q / 4; i < half; ++i)
    if (mem[i] && q - 2 * i <= half && mem[q - 2 * i]) mem[q - 2 * i] = 0;
  for (int64_t i = q / 6; i < q / 4; ++i)
    if (mem[i] && q - 3 * i <= half && mem[q - 3 * i]) mem[q - 3 * i] = 0;
  for (int64_t i = 1; i <= ah + 1 && i <= half; ++i)
    if (omega23_even(i)) mem[i] = 1;
  int64_t k = 0;
  for (int64_t i = 0; i <= half; ++i)
    if (mem[i]) out[k++] = static_cast<int32_t>(i);
  return k;
}

// Digit conversion table (main_p1.cpp:139-153 write order: alpha=1 entries
// first so exact products win). bucket_set of size b_size; m_t/b_t/a_t of
// size q+1. Returns count of uncovered digits (0 = valid).
int64_t msm_digit_conversion_table(int64_t q, const int32_t* bucket_set,
                                   int64_t b_size, int32_t* m_t, int32_t* b_t,
                                   int32_t* a_t) {
  std::vector<uint8_t> written(q + 1, 0);
  std::memset(m_t, 0, sizeof(int32_t) * (q + 1));
  std::memset(b_t, 0, sizeof(int32_t) * (q + 1));
  std::memset(a_t, 0, sizeof(int32_t) * (q + 1));
  for (int alpha = 1; alpha >= 0; --alpha) {
    for (int m = 1; m <= 3; ++m) {
      for (int64_t i = 0; i < b_size; ++i) {
        const int64_t prod = static_cast<int64_t>(m) * bucket_set[i];
        if (prod > q) continue;
        const int64_t idx = alpha ? q - prod : prod;
        m_t[idx] = m;
        b_t[idx] = bucket_set[i];
        a_t[idx] = alpha;
        written[idx] = 1;
      }
    }
  }
  int64_t missing = 0;
  for (int64_t i = 0; i <= q; ++i) missing += !written[i];
  return missing;
}

}  // extern "C"
