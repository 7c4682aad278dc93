// Device arithmetic over one prime field in N 32-bit words, shared by the
// field kernels (field_kernels.cu) and the fused G1 point adds
// (g1_kernels.cu).
//
// Layout at the interface is the JAX package's: a field vector is limb-major
// [L, B] int32 holding 16-bit limbs (L = 16 for Fr, L = 24 for Fq, so
// R = 2^(16 L) = 2^256 or 2^384).  Element j of row i sits at
// ptr[i * row_stride + j * col_stride], so sliced views (a row stride wider
// than B) and broadcast columns (col_stride 0) need no copy.  A thread packs
// pairs of 16-bit limbs into N = L / 2 32-bit words (R is unchanged),
// computes, and unpacks into a dense [L, B] output.
//
// Montgomery multiplication is CIOS with 64-bit products and
// n0 = -p^-1 mod 2^32, then one conditional subtraction: the value before
// that subtraction is (a b + m p) / R with the unique m in [0, R), the same
// as the Pallas kernels' 16-bit REDC, so the two agree bit for bit.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <utility>

namespace swt {

constexpr int kMaxWords = 12;  // Fq: 384 bits

template <int N>
struct Modulus {
  uint32_t p[N];
  uint32_t n0;      // -p^-1 mod 2^32
  uint32_t one[N];  // R mod p (Montgomery one)
};

struct View {
  const int32_t* ptr;
  int64_t row_stride;
  int64_t col_stride;
};

template <int N>
__device__ __forceinline__ void load(uint32_t (&x)[N], const View& v, int64_t j) {
  const int32_t* base = v.ptr + j * v.col_stride;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    uint32_t lo = static_cast<uint32_t>(base[(2 * k) * v.row_stride]) & 0xFFFFu;
    uint32_t hi = static_cast<uint32_t>(base[(2 * k + 1) * v.row_stride]) & 0xFFFFu;
    x[k] = lo | (hi << 16);
  }
}

template <int N>
__device__ __forceinline__ void store(int32_t* out, int64_t B, int64_t j, const uint32_t (&x)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    out[(2 * k) * B + j] = static_cast<int32_t>(x[k] & 0xFFFFu);
    out[(2 * k + 1) * B + j] = static_cast<int32_t>(x[k] >> 16);
  }
}

// r = a * b * R^-1 mod p for a, b < p (CIOS, 32-bit words).  r may alias a
// or b: it is written only after both are read.
template <int N>
__device__ __forceinline__ void mont_mul(uint32_t (&r)[N], const uint32_t (&a)[N],
                                         const uint32_t (&b)[N], const Modulus<N>& M) {
  uint32_t t[N + 2];
#pragma unroll
  for (int k = 0; k < N + 2; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      uint64_t s = static_cast<uint64_t>(a[j]) * b[i] + t[j] + c;
      t[j] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
    uint64_t s = static_cast<uint64_t>(t[N]) + c;
    t[N] = static_cast<uint32_t>(s);
    t[N + 1] = static_cast<uint32_t>(s >> 32);

    uint32_t m = t[0] * M.n0;
    s = static_cast<uint64_t>(m) * M.p[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < N; ++j) {
      s = static_cast<uint64_t>(m) * M.p[j] + t[j] + c;
      t[j - 1] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
    s = static_cast<uint64_t>(t[N]) + c;
    t[N - 1] = static_cast<uint32_t>(s);
    t[N] = t[N + 1] + static_cast<uint32_t>(s >> 32);
  }
  // V = t[N] * 2^(32N) + t[0..N-1] < 2p: subtract p when t[N] is set or
  // the low words are >= p (no borrow).
  uint32_t d[N];
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    uint64_t s = static_cast<uint64_t>(t[k]) - M.p[k] - borrow;
    d[k] = static_cast<uint32_t>(s);
    borrow = static_cast<uint32_t>(s >> 63);
  }
  const bool use_d = (t[N] != 0) || (borrow == 0);
#pragma unroll
  for (int k = 0; k < N; ++k) r[k] = use_d ? d[k] : t[k];
}

// r = (a + b) mod p for a, b < p.  r may alias a or b.
template <int N>
__device__ __forceinline__ void mod_add(uint32_t (&r)[N], const uint32_t (&a)[N],
                                        const uint32_t (&b)[N], const Modulus<N>& M) {
  uint32_t s[N], d[N];
  uint32_t carry = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    uint64_t v = static_cast<uint64_t>(a[k]) + b[k] + carry;
    s[k] = static_cast<uint32_t>(v);
    carry = static_cast<uint32_t>(v >> 32);
  }
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    uint64_t v = static_cast<uint64_t>(s[k]) - M.p[k] - borrow;
    d[k] = static_cast<uint32_t>(v);
    borrow = static_cast<uint32_t>(v >> 63);
  }
  // a + b < 2p: subtract p when the sum carried out or is >= p
  const bool use_d = (carry != 0) || (borrow == 0);
#pragma unroll
  for (int k = 0; k < N; ++k) r[k] = use_d ? d[k] : s[k];
}

// r = (a - b) mod p for a, b < p.  r may alias a or b.
template <int N>
__device__ __forceinline__ void mod_sub(uint32_t (&r)[N], const uint32_t (&a)[N],
                                        const uint32_t (&b)[N], const Modulus<N>& M) {
  uint32_t d[N];
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    uint64_t v = static_cast<uint64_t>(a[k]) - b[k] - borrow;
    d[k] = static_cast<uint32_t>(v);
    borrow = static_cast<uint32_t>(v >> 63);
  }
  if (borrow) {  // a - b wrapped: add p back (mod 2^(32N))
    uint32_t carry = 0;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      uint64_t v = static_cast<uint64_t>(d[k]) + M.p[k] + carry;
      d[k] = static_cast<uint32_t>(v);
      carry = static_cast<uint32_t>(v >> 32);
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k) r[k] = d[k];
}

// ---------------------------------------------------------------------------
// Carry-chain Montgomery arithmetic (inline PTX), for the Fermat pow, the
// NTT and the G1 kernels.
//
// Each 32 x 32 -> 64-bit product is a mad.lo / madc.hi pair whose adds ride
// the carry flag (.cc / madc).  Written into adjacent words, the pair is one
// 64-bit multiply-add with carry in and out, which ptxas issues as a single
// IMAD.WIDE.U32(.X); the same links spread over a single accumulator cost
// an IMAD, an IMAD.HI and two IADD3 a product.  So the accumulators keep
// the products of even and of odd word indices apart (cc::mad_row).
// A chain is a run of asm statements with nothing between them that writes
// the flag (the compiler emits no carry-flag instruction of its own), each
// volatile so the run keeps its order; every chain is written first link,
// unrolled middle, last link, with no condition inside a loop.
//
// Both functions need p < 2^(32N - 2) (Fr: p < 2^253 in 256 bits; Fq:
// q < 2^377 in 384), which keeps every intermediate in N + 1 words, and
// both return the canonical value (< p): the same words as mont_mul for the
// same inputs, whatever the order of the partial sums.

namespace cc {

// d = lo(a b) + c with carry out, and carry in when CI; d = hi(a b) + c
// with carry in, and carry out when CO: the two links of a 64-bit product.
template <bool CI>
__device__ __forceinline__ uint32_t mad_lo(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  if (CI) asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  if (!CI) asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

template <bool CO>
__device__ __forceinline__ uint32_t mad_hi(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  if (CO) asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  if (!CO) asm volatile("madc.hi.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// d = a + b or a - b, with carry (borrow) in when CI and out when CO.
template <bool CI, bool CO>
__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  uint32_t d;
  if (CI && CO) asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  if (CI && !CO) asm volatile("addc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  if (!CI) asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

template <bool CI, bool CO>
__device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b) {
  uint32_t d;
  if (CI && CO) asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  if (CI && !CO) asm volatile("subc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  if (!CI) asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// (lo, hi) = a * b + (lo_in, hi_in) + the carry flag (CI), the carry out of
// hi left in the flag (CO): one 64-bit multiply-add, which ptxas issues as
// one IMAD.WIDE.U32 (.X with a carry in) when the two links are adjacent.
template <bool CI, bool CO>
__device__ __forceinline__ void mad_wide(uint32_t& lo, uint32_t& hi, uint32_t a, uint32_t b,
                                         uint32_t lo_in, uint32_t hi_in) {
  lo = mad_lo<CI>(a, b, lo_in);
  hi = mad_hi<CO>(a, b, hi_in);
}

// The even/odd layout of a CIOS accumulator T < 2^(32(N+1)):
// T = X + 2^32 Y, where X ("even") takes the products a_j b of even j as
// 64-bit pairs at words (j, j+1) and Y ("odd") those of odd j at (j-1, j),
// one word up.  Pairs of one array never overlap, so each array gains a
// whole row in one chain of 64-bit multiply-adds.  Y < 2^(32N) always
// (2^32 Y <= T), so Y's chains never carry out; X's carry out lands in
// Y[N-1] (word N of T).
//
// X += b * v[even], Y += b * v[odd]: Y's chain first, then X's, then X's
// carry into Y[N-1].
template <int N>
__device__ __forceinline__ void mad_row(uint32_t (&X)[N], uint32_t (&Y)[N],
                                        const uint32_t (&v)[N], uint32_t b) {
  static_assert(N >= 4 && N % 2 == 0, "the chains below have a first, a middle and a last link");
  mad_wide<false, true>(Y[0], Y[1], v[1], b, Y[0], Y[1]);
#pragma unroll
  for (int j = 3; j < N - 1; j += 2) mad_wide<true, true>(Y[j - 1], Y[j], v[j], b, Y[j - 1], Y[j]);
  mad_wide<true, false>(Y[N - 2], Y[N - 1], v[N - 1], b, Y[N - 2], Y[N - 1]);
  mad_wide<false, true>(X[0], X[1], v[0], b, X[0], X[1]);
#pragma unroll
  for (int j = 2; j < N; j += 2) mad_wide<true, true>(X[j], X[j + 1], v[j], b, X[j], X[j + 1]);
  Y[N - 1] = add<true, false>(Y[N - 1], 0u);
}

// The same with T shifted down one word first, fused into Y's chain: the
// shifted T has X's role played by Y (word k of it is Y[k], plus X[1] at
// word 0) and Y's by X two words down (X[0] is 0 after its reduction).
// On return the caller swaps the names: Y is the even array, X the odd.
template <int N>
__device__ __forceinline__ void shift_mad_row(uint32_t (&X)[N], uint32_t (&Y)[N],
                                              const uint32_t (&v)[N], uint32_t b) {
  Y[0] = add<false, true>(Y[0], X[1]);  // its carry is word 1: X's first pair
  mad_wide<true, true>(X[0], X[1], v[1], b, X[2], X[3]);
#pragma unroll
  for (int j = 3; j < N - 1; j += 2) mad_wide<true, true>(X[j - 1], X[j], v[j], b, X[j + 1], X[j + 2]);
  mad_wide<true, false>(X[N - 2], X[N - 1], v[N - 1], b, 0u, 0u);
  mad_wide<false, true>(Y[0], Y[1], v[0], b, Y[0], Y[1]);
#pragma unroll
  for (int j = 2; j < N; j += 2) mad_wide<true, true>(Y[j], Y[j + 1], v[j], b, Y[j], Y[j + 1]);
  X[N - 1] = add<true, false>(X[N - 1], 0u);
}

// One reduction row in place: m = X[0] n0, T += m p (X[0] becomes 0).
template <int N>
__device__ __forceinline__ void redc_row(uint32_t (&X)[N], uint32_t (&Y)[N], const Modulus<N>& M) {
  mad_row<N>(X, Y, M.p, X[0] * M.n0);
}

// The shift of shift_mad_row, then a reduction row: m is read from word 0
// of the shifted T, once X[1] is in it.  The caller swaps the names.
template <int N>
__device__ __forceinline__ void shift_redc_row(uint32_t (&X)[N], uint32_t (&Y)[N],
                                               const Modulus<N>& M) {
  Y[0] = add<false, true>(Y[0], X[1]);
  const uint32_t m = Y[0] * M.n0;  // no carry-flag instruction: the carry waits
  mad_wide<true, true>(X[0], X[1], M.p[1], m, X[2], X[3]);
#pragma unroll
  for (int j = 3; j < N - 1; j += 2) mad_wide<true, true>(X[j - 1], X[j], M.p[j], m, X[j + 1], X[j + 2]);
  mad_wide<true, false>(X[N - 2], X[N - 1], M.p[N - 1], m, 0u, 0u);
  mad_wide<false, true>(Y[0], Y[1], M.p[0], m, Y[0], Y[1]);
#pragma unroll
  for (int j = 2; j < N; j += 2) mad_wide<true, true>(Y[j], Y[j + 1], M.p[j], m, Y[j], Y[j + 1]);
  X[N - 1] = add<true, false>(X[N - 1], 0u);
}

// With T = X + 2^32 Y and X[0] = 0, V = T / 2^32 into Y: Y[k] += X[k+1].
template <int N>
__device__ __forceinline__ void shift_merge(uint32_t (&Y)[N], const uint32_t (&X)[N]) {
  Y[0] = add<false, true>(Y[0], X[1]);
#pragma unroll
  for (int k = 1; k < N - 1; ++k) Y[k] = add<true, true>(Y[k], X[k + 1]);
  Y[N - 1] = add<true, false>(Y[N - 1], 0u);
}

// r = V - p if V >= p, else V, for V < 2p < 2^(32N).
template <int N>
__device__ __forceinline__ void reduce_once(uint32_t (&r)[N], const uint32_t (&v)[N],
                                            const Modulus<N>& M) {
  uint32_t d[N];
  d[0] = sub<false, true>(v[0], M.p[0]);
#pragma unroll
  for (int k = 1; k < N; ++k) d[k] = sub<true, true>(v[k], M.p[k]);
  const uint32_t below = sub<true, false>(0u, 0u);  // all ones when V < p
#pragma unroll
  for (int k = 0; k < N; ++k) r[k] = below ? v[k] : d[k];
}

// (w[s], w[s+1]) += a[I] * a[J] for J = J0, J0 + 2, .., J1 (s = I + J): one
// chain of 64-bit multiply-adds, its carry out left in the flag when CO.
template <int N, int I, int J0, int J1, bool CO, int W>
__device__ __forceinline__ void cross_chain(uint32_t (&w)[W], const uint32_t (&a)[N]) {
  if constexpr (J0 == J1) {
    mad_wide<false, CO>(w[I + J0], w[I + J0 + 1], a[I], a[J0], w[I + J0], w[I + J0 + 1]);
  } else {
    mad_wide<false, true>(w[I + J0], w[I + J0 + 1], a[I], a[J0], w[I + J0], w[I + J0 + 1]);
#pragma unroll
    for (int j = J0 + 2; j < J1; j += 2) {
      mad_wide<true, true>(w[I + j], w[I + j + 1], a[I], a[j], w[I + j], w[I + j + 1]);
    }
    mad_wide<true, CO>(w[I + J1], w[I + J1 + 1], a[I], a[J1], w[I + J1], w[I + J1 + 1]);
  }
}

// Row I of the cross products a_I a_J (J > I) at words I + J: the odd words
// into wo, the even ones into we.  The sum of rows 0..I stays below
// 2^(32(N+I+1)), so the chain that ends at J = N - 1 cannot carry out, and
// the one ending at J = N - 2 carries into word I + N, which no earlier
// row reached.
template <int N, int I>
__device__ __forceinline__ void cross_row(uint32_t (&we)[2 * N], uint32_t (&wo)[2 * N],
                                          const uint32_t (&a)[N]) {
  constexpr bool odd_ends_top = (N - 2 - I) % 2 == 0;  // wo's chain reaches J = N - 1
  cross_chain<N, I, I + 1, odd_ends_top ? N - 1 : N - 2, !odd_ends_top>(wo, a);
  if constexpr (!odd_ends_top) wo[I + N] = add<true, false>(wo[I + N], 0u);
  if constexpr (I + 2 < N) {
    cross_chain<N, I, I + 2, odd_ends_top ? N - 2 : N - 1, odd_ends_top>(we, a);
    if constexpr (odd_ends_top) we[I + N] = add<true, false>(we[I + N], 0u);
  }
}

template <int N, int... I>
__device__ __forceinline__ void cross_rows(uint32_t (&we)[2 * N], uint32_t (&wo)[2 * N],
                                           const uint32_t (&a)[N], std::integer_sequence<int, I...>) {
  (cross_row<N, I>(we, wo, a), ...);
}

}  // namespace cc

// r = a * b * R^-1 mod p for a, b < p: CIOS in the even/odd layout (cc::
// mad_row), N^2 64-bit multiply-adds for a b and N^2 for m p.  r may alias
// a or b: it is written only after both are read.
template <int N>
__device__ __forceinline__ void mont_mul_cc(uint32_t (&r)[N], const uint32_t (&a)[N],
                                            const uint32_t (&b)[N], const Modulus<N>& M) {
  uint32_t x[N], y[N];
#pragma unroll
  for (int k = 0; k < N; ++k) x[k] = y[k] = 0;
  cc::mad_row<N>(x, y, a, b[0]);
  cc::redc_row<N>(x, y, M);
#pragma unroll
  for (int i = 1; i < N - 1; i += 2) {
    cc::shift_mad_row<N>(x, y, a, b[i]);  // y even, x odd
    cc::redc_row<N>(y, x, M);
    cc::shift_mad_row<N>(y, x, a, b[i + 1]);  // x even, y odd
    cc::redc_row<N>(x, y, M);
  }
  cc::shift_mad_row<N>(x, y, a, b[N - 1]);
  cc::redc_row<N>(y, x, M);
  cc::shift_merge<N>(x, y);  // V = (a b + m p) / R < 2p
  cc::reduce_once<N>(r, x, M);
}

// r = a^2 * R^-1 mod p for a < p.  The cross products a_i a_j (i < j) once
// each, doubled, plus the diagonal squares: N(N+1)/2 products where the
// multiply takes N^2; then the low half is reduced row by row (the same m
// as CIOS) and the high half added.  r may alias a.
template <int N>
__device__ __forceinline__ void mont_sqr(uint32_t (&r)[N], const uint32_t (&a)[N],
                                         const Modulus<N>& M) {
  uint32_t we[2 * N], wo[2 * N];
#pragma unroll
  for (int k = 0; k < 2 * N; ++k) we[k] = wo[k] = 0;
  cc::cross_rows<N>(we, wo, a, std::make_integer_sequence<int, N - 1>{});
  // we = 2 (we + wo) + the squares (words 0 of wo and 0, 1 of we are 0;
  // the cross sum is below a^2 / 2)
  we[1] = cc::add<false, true>(we[1], wo[1]);
#pragma unroll
  for (int k = 2; k < 2 * N - 1; ++k) we[k] = cc::add<true, true>(we[k], wo[k]);
  we[2 * N - 1] = cc::add<true, false>(we[2 * N - 1], wo[2 * N - 1]);
  we[1] = cc::add<false, true>(we[1], we[1]);
#pragma unroll
  for (int k = 2; k < 2 * N - 1; ++k) we[k] = cc::add<true, true>(we[k], we[k]);
  we[2 * N - 1] = cc::add<true, false>(we[2 * N - 1], we[2 * N - 1]);
  cc::mad_wide<false, true>(we[0], we[1], a[0], a[0], we[0], we[1]);
#pragma unroll
  for (int i = 1; i < N - 1; ++i) {
    cc::mad_wide<true, true>(we[2 * i], we[2 * i + 1], a[i], a[i], we[2 * i], we[2 * i + 1]);
  }
  cc::mad_wide<true, false>(we[2 * N - 2], we[2 * N - 1], a[N - 1], a[N - 1], we[2 * N - 2],
                            we[2 * N - 1]);
  // (w_lo + m p) / R row by row in the even/odd layout, then + w_hi:
  // V = (a^2 + m p) / R < 2p
  uint32_t x[N], y[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    x[k] = we[k];
    y[k] = 0;
  }
  cc::redc_row<N>(x, y, M);
#pragma unroll
  for (int i = 1; i < N - 1; i += 2) {
    cc::shift_redc_row<N>(x, y, M);  // y even, x odd
    cc::shift_redc_row<N>(y, x, M);  // x even, y odd
  }
  cc::shift_redc_row<N>(x, y, M);
  cc::shift_merge<N>(x, y);
  x[0] = cc::add<false, true>(x[0], we[N]);
#pragma unroll
  for (int k = 1; k < N - 1; ++k) x[k] = cc::add<true, true>(x[k], we[N + k]);
  x[N - 1] = cc::add<true, false>(x[N - 1], we[2 * N - 1]);
  cc::reduce_once<N>(r, x, M);
}

template <int N>
__device__ __forceinline__ bool is_zero(const uint32_t (&a)[N]) {
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) acc |= a[k];
  return acc == 0;
}

template <int N>
__device__ __forceinline__ void copy(uint32_t (&r)[N], const uint32_t (&a)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) r[k] = a[k];
}

template <int N>
Modulus<N> make_modulus(const uint32_t* p, uint32_t n0, const uint32_t* one) {
  Modulus<N> M;
  for (int k = 0; k < N; ++k) {
    M.p[k] = p[k];
    M.one[k] = one[k];
  }
  M.n0 = n0;
  return M;
}

inline unsigned grid_for(int64_t B, int threads) {
  return static_cast<unsigned>((B + threads - 1) / threads);
}

}  // namespace swt
