// Prime-field kernels for BLS12-377 Fr and Fq on Hopper (sm_90a).
//
// Replaces the four Pallas kernels of simpleworks_tpu/ops/mont_mul_pallas.py:
//   swt_mont_mul  <- _mont_mul_kernel (body _mul_body), built by make_mont_mul
//   swt_mod_add   <- _mod_add_kernel, built by make_mod_addsub
//   swt_mod_sub   <- _mod_sub_kernel, built by make_mod_addsub
//   swt_mont_pow  <- _mont_pow_kernel, built by make_mont_pow
//
// The layout, the limb packing and the arithmetic are in field_arith.cuh,
// which the fused G1 point adds (g1_kernels.cu) share.  One thread per
// element; neighbouring threads read neighbouring lanes of each limb row, so
// loads coalesce when col_stride is 1.  The ragged edge is masked; there is
// no tile padding.
//
// What bounds them on the card: mont_mul over a wide batch is bound by
// integer multiply-add throughput (2 N^2 64-bit products per multiply: 128
// for Fr, 288 for Fq); mod_add and mod_sub do O(N) work per 8 L bytes moved
// and are bound by memory bandwidth.  mont_pow is the Fermat inverse of
// dvec.inv (Fr, elementwise) and of the batch inversion's root in
// g1_limb.normalize_affine (Fq, at most a few thousand lanes); each lane is
// a chain of dependent multiplies (754 for e = q - 2), so a narrow batch is
// bound by that chain's latency; one-warp blocks spread it over as many SMs
// as it has warps.
// The design keeps every intermediate in registers (no shared
// memory), which is what the Pallas kernel's VMEM residency bought on the
// TPU.

#include <cstdint>
#include <cuda_runtime.h>

#include "field_arith.cuh"

namespace {

using swt::grid_for;
using swt::kMaxWords;
using swt::load;
using swt::make_modulus;
using swt::Modulus;
using swt::store;
using swt::View;

// Small blocks spread a narrow batch over many SMs: the batch inversion's
// Fermat root runs on a few thousand lanes, which 256-thread blocks would
// put on a handful of the card's 132 SMs, bound by their multiply rate.
constexpr int kThreads = 64;
constexpr int kPowThreads = 32;

template <int N>
struct Exponent {
  uint32_t w[kMaxWords];  // little-endian 32-bit words
  int n_bits;             // bit length; bits are walked MSB first
};

template <int N>
__global__ void mont_mul_kernel(View a, View b, int32_t* out, int64_t B, Modulus<N> M) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= B) return;
  uint32_t x[N], y[N], r[N];
  load<N>(x, a, j);
  load<N>(y, b, j);
  swt::mont_mul<N>(r, x, y, M);
  store<N>(out, B, j, r);
}

template <int N>
__global__ void mod_add_kernel(View a, View b, int32_t* out, int64_t B, Modulus<N> M) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= B) return;
  uint32_t x[N], y[N], s[N];
  load<N>(x, a, j);
  load<N>(y, b, j);
  swt::mod_add<N>(s, x, y, M);
  store<N>(out, B, j, s);
}

template <int N>
__global__ void mod_sub_kernel(View a, View b, int32_t* out, int64_t B, Modulus<N> M) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= B) return;
  uint32_t x[N], y[N], d[N];
  load<N>(x, a, j);
  load<N>(y, b, j);
  swt::mod_sub<N>(d, x, y, M);
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
    swt::mont_mul<N>(tmp, acc, acc, M);
    if ((E.w[i >> 5] >> (i & 31)) & 1u) {
      swt::mont_mul<N>(acc, tmp, x, M);
    } else {
#pragma unroll
      for (int k = 0; k < N; ++k) acc[k] = tmp[k];
    }
  }
  store<N>(out, B, j, acc);
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
