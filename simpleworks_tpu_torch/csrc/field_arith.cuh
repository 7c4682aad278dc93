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
