// Prime-field kernels for BLS12-377 Fr and Fq on Hopper (sm_90a).
//
// Replaces the four Pallas kernels of simpleworks_tpu/ops/mont_mul_pallas.py:
//   swt_mont_mul  <- _mont_mul_kernel (body _mul_body), built by make_mont_mul
//   swt_mod_add   <- _mod_add_kernel, built by make_mod_addsub
//   swt_mod_sub   <- _mod_sub_kernel, built by make_mod_addsub
//   swt_mont_pow  <- _mont_pow_kernel, built by make_mont_pow
//
// Layout at the interface is the JAX package's: a field vector is limb-major
// [L, B] int32 holding 16-bit limbs (L = 16 for Fr, L = 24 for Fq, so
// R = 2^(16 L) = 2^256 or 2^384).  Element j of row i sits at
// ptr[i * row_stride + j * col_stride], so sliced views (a row stride wider
// than B) and broadcast columns (col_stride 0) need no copy.  The output is
// always a dense [L, B] array.
//
// One thread per element.  A thread loads its limb column (neighbouring
// threads read neighbouring lanes of each limb row, so loads coalesce when
// col_stride is 1), packs pairs of 16-bit limbs into N = L / 2 32-bit words
// (R is unchanged), computes, and unpacks.  Montgomery multiplication is CIOS
// with 64-bit products and n0 = -p^-1 mod 2^32, then one conditional
// subtraction: the value before that subtraction is (a b + m p) / R with the
// unique m in [0, R), the same as the Pallas kernel's 16-bit REDC, so the
// two agree bit for bit.  The ragged edge is masked; there is no tile padding.
//
// What bounds them on the card: mont_mul over a wide batch is bound by
// integer multiply-add throughput (2 N^2 64-bit products per multiply: 128
// for Fr, 288 for Fq); mod_add and mod_sub do O(N) work per 8 L bytes moved
// and are bound by memory bandwidth.  mont_pow runs where the batch is
// narrow (the root of a batch inversion: a few thousand lanes), so it is
// bound by the latency of its chain of dependent multiplies (754 for
// e = q - 2); one-warp blocks spread it over as many SMs as it has warps.
// The design keeps every intermediate in registers (no shared
// memory), which is what the Pallas kernel's VMEM residency bought on the
// TPU.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Small blocks spread a narrow batch over many SMs: the batch inversion's
// Fermat root runs on a few thousand lanes, which 256-thread blocks would
// put on a handful of the card's 132 SMs, bound by their multiply rate.
constexpr int kThreads = 64;
constexpr int kPowThreads = 32;
constexpr int kMaxWords = 12;  // Fq: 384 bits

template <int N>
struct Modulus {
  uint32_t p[N];
  uint32_t n0;  // -p^-1 mod 2^32
  uint32_t one[N];  // R mod p (Montgomery one)
};

template <int N>
struct Exponent {
  uint32_t w[kMaxWords];  // little-endian 32-bit words
  int n_bits;             // bit length; bits are walked MSB first
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

// r = a * b * R^-1 mod p for a, b < p (CIOS, 32-bit words).
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

template <int N>
__global__ void mont_mul_kernel(View a, View b, int32_t* out, int64_t B, Modulus<N> M) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= B) return;
  uint32_t x[N], y[N], r[N];
  load<N>(x, a, j);
  load<N>(y, b, j);
  mont_mul<N>(r, x, y, M);
  store<N>(out, B, j, r);
}

template <int N>
__global__ void mod_add_kernel(View a, View b, int32_t* out, int64_t B, Modulus<N> M) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= B) return;
  uint32_t x[N], y[N], s[N], d[N];
  load<N>(x, a, j);
  load<N>(y, b, j);
  uint32_t carry = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    uint64_t v = static_cast<uint64_t>(x[k]) + y[k] + carry;
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
  for (int k = 0; k < N; ++k) s[k] = use_d ? d[k] : s[k];
  store<N>(out, B, j, s);
}

template <int N>
__global__ void mod_sub_kernel(View a, View b, int32_t* out, int64_t B, Modulus<N> M) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= B) return;
  uint32_t x[N], y[N], d[N];
  load<N>(x, a, j);
  load<N>(y, b, j);
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    uint64_t v = static_cast<uint64_t>(x[k]) - y[k] - borrow;
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
  store<N>(out, B, j, d);
}

// x^e for a fixed e, MSB-first square-and-multiply (0 maps to 0).  Every
// thread walks the same bits, so the branch never diverges within a warp.
template <int N>
__global__ void mont_pow_kernel(View a, int32_t* out, int64_t B, Modulus<N> M, Exponent<N> E) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= B) return;
  uint32_t x[N], acc[N], tmp[N];
  load<N>(x, a, j);
#pragma unroll
  for (int k = 0; k < N; ++k) acc[k] = M.one[k];
  for (int i = E.n_bits - 1; i >= 0; --i) {
    mont_mul<N>(tmp, acc, acc, M);
    if ((E.w[i >> 5] >> (i & 31)) & 1u) {
      mont_mul<N>(acc, tmp, x, M);
    } else {
#pragma unroll
      for (int k = 0; k < N; ++k) acc[k] = tmp[k];
    }
  }
  store<N>(out, B, j, acc);
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

enum class Op { kMul, kAdd, kSub };

template <int N>
void launch_binary(Op op, View a, View b, int32_t* out, int64_t B, const Modulus<N>& M,
                   cudaStream_t stream) {
  const unsigned grid = grid_for(B, kThreads);
  switch (op) {
    case Op::kMul:
      mont_mul_kernel<N><<<grid, kThreads, 0, stream>>>(a, b, out, B, M);
      break;
    case Op::kAdd:
      mod_add_kernel<N><<<grid, kThreads, 0, stream>>>(a, b, out, B, M);
      break;
    case Op::kSub:
      mod_sub_kernel<N><<<grid, kThreads, 0, stream>>>(a, b, out, B, M);
      break;
  }
}

int binary(Op op, int n_words, const int32_t* a, int64_t a_rs, int64_t a_cs, const int32_t* b,
           int64_t b_rs, int64_t b_cs, int32_t* out, int64_t B, const uint32_t* p, uint32_t n0,
           const uint32_t* one, void* stream) {
  if (B <= 0) return 0;
  const View va{a, a_rs, a_cs};
  const View vb{b, b_rs, b_cs};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_words == 8) {
    launch_binary<8>(op, va, vb, out, B, make_modulus<8>(p, n0, one), s);
  } else if (n_words == 12) {
    launch_binary<12>(op, va, vb, out, B, make_modulus<12>(p, n0, one), s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry point launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch (0 on success).

int swt_mont_mul(int n_words, const int32_t* a, int64_t a_rs, int64_t a_cs, const int32_t* b,
                 int64_t b_rs, int64_t b_cs, int32_t* out, int64_t B, const uint32_t* p,
                 uint32_t n0, const uint32_t* one, void* stream) {
  return binary(Op::kMul, n_words, a, a_rs, a_cs, b, b_rs, b_cs, out, B, p, n0, one, stream);
}

int swt_mod_add(int n_words, const int32_t* a, int64_t a_rs, int64_t a_cs, const int32_t* b,
                int64_t b_rs, int64_t b_cs, int32_t* out, int64_t B, const uint32_t* p,
                uint32_t n0, const uint32_t* one, void* stream) {
  return binary(Op::kAdd, n_words, a, a_rs, a_cs, b, b_rs, b_cs, out, B, p, n0, one, stream);
}

int swt_mod_sub(int n_words, const int32_t* a, int64_t a_rs, int64_t a_cs, const int32_t* b,
                int64_t b_rs, int64_t b_cs, int32_t* out, int64_t B, const uint32_t* p,
                uint32_t n0, const uint32_t* one, void* stream) {
  return binary(Op::kSub, n_words, a, a_rs, a_cs, b, b_rs, b_cs, out, B, p, n0, one, stream);
}

// `e_words`: the exponent as `n_e_words` little-endian 32-bit words (at most
// 12), `n_bits` its bit length.
int swt_mont_pow(int n_words, const int32_t* a, int64_t a_rs, int64_t a_cs, int32_t* out,
                 int64_t B, const uint32_t* p, uint32_t n0, const uint32_t* one,
                 const uint32_t* e_words, int n_e_words, int n_bits, void* stream) {
  if (B <= 0) return 0;
  if (n_e_words > kMaxWords || n_bits > 32 * n_e_words || n_bits < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const View va{a, a_rs, a_cs};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_for(B, kPowThreads);
  if (n_words == 8) {
    Exponent<8> E{};
    for (int k = 0; k < n_e_words; ++k) E.w[k] = e_words[k];
    E.n_bits = n_bits;
    mont_pow_kernel<8><<<grid, kPowThreads, 0, s>>>(va, out, B, make_modulus<8>(p, n0, one), E);
  } else if (n_words == 12) {
    Exponent<12> E{};
    for (int k = 0; k < n_e_words; ++k) E.w[k] = e_words[k];
    E.n_bits = n_bits;
    mont_pow_kernel<12><<<grid, kPowThreads, 0, s>>>(va, out, B, make_modulus<12>(p, n0, one), E);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
