// Prime-field kernels for BLS12-377 Fr and Fq on Hopper (sm_90a).
//
// Replaces the four Pallas kernels of simpleworks_tpu/ops/mont_mul_pallas.py:
//   swt_mont_mul  <- _mont_mul_kernel (body _mul_body), built by make_mont_mul
//   swt_mod_add   <- _mod_add_kernel, built by make_mod_addsub
//   swt_mod_sub   <- _mod_sub_kernel, built by make_mod_addsub
//   swt_mont_pow  <- _mont_pow_kernel (:111), built by make_mont_pow
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
// and are bound by memory bandwidth.
//
// mont_pow is the Fermat inverse of dvec.inv (Fr, elementwise, 655,360 and
// 786,432 lanes in a prove) and of the batch inversion's root in
// g1_limb.normalize_affine (Fq, at most a few thousand lanes).  Each lane is
// a chain of a few hundred dependent Montgomery products on 32 (Fr) or 48
// (Fq) bytes of input, so at the prove's widths the pow is bound by the
// SMs' integer multiply-add rate, and on a narrow batch by the latency of
// that chain (a few warps on a few SMs).  The TPU kernel walked the
// exponent's bits from the Montgomery one, a squaring a bit and a general
// multiply a set bit (253 + 133 products for p - 2, 377 + 179 for q - 2).
// Here:
//   * the wrapper (ops/mont_mul.py, pow_schedule) cuts e into a sliding
//     window of odd digits d < 2^w, passed in the kernel's parameters as
//     steps (squarings, digit) that every lane walks alike; a lane builds
//     its odd powers x, x^3, .., x^(2k-1) once in shared memory, laid out
//     [power][word][thread] so that a warp's reads hit 32 distinct banks,
//     and starts from the top digit's power, not from one (at w = 4, p - 2
//     takes 7 table and 48 window multiplies instead of 133);
//   * a squaring is mont_sqr: each cross product once, doubled, plus the
//     diagonal, N(N+1)/2 products where a * a takes N^2;
//   * the squaring and the multiply (mont_mul_cc) are CIOS on PTX carry
//     chains with the products of even and of odd word indices in two
//     accumulators, so that each product is one 64-bit multiply-add with
//     carry in and out (IMAD.WIDE.U32.X); written over one accumulator the
//     same chains took an IMAD, an IMAD.HI and two IADD3 a product (about
//     5 SASS instructions, issue-bound), as swt::mont_mul's 64-bit CIOS does;
//   * blocks are one warp on a batch narrower than a wave of 128-thread
//     blocks over the card's SMs (the latency-bound chains spread over as
//     many SMs as there are warps), and 128 threads from there up.
// Every intermediate stays in registers or in the block's shared table,
// which is what the Pallas kernel's VMEM residency bought on the TPU.

#include <cstdint>
#include <cuda_runtime.h>

#include "field_arith.cuh"

namespace {

using swt::grid_for;
using swt::load;
using swt::make_modulus;
using swt::Modulus;
using swt::store;
using swt::View;

// Small blocks spread a narrow batch over many SMs: the batch inversion's
// Fermat root runs on a few thousand lanes, which 256-thread blocks would
// put on a handful of the card's 132 SMs, bound by their multiply rate.
constexpr int kThreads = 64;
// The pow's blocks: one warp below a wave of wide blocks, else kPowWide.
constexpr int kPowNarrow = 32;
constexpr int kPowWide = 128;
// The pow's schedule: at most one step a set bit of a 384-bit exponent.
constexpr int kMaxPowSteps = 384;
// The pow's table: the odd powers x .. x^15 (digits of a 4-bit window), at
// most 48 KB a wide block (Fq), the shared memory a launch gets unasked.
constexpr int kMaxPowTable = 8;
static_assert(sizeof(uint32_t) * 12 * kMaxPowTable * kPowWide <= 48 * 1024,
              "the widest table needs no opt-in to more shared memory");

// Step s > 0: square (step >> 16) times, then multiply by x^(step & 0xFFFF)
// unless that digit is 0; step 0 holds the top digit alone, the lane's
// start.  No steps: e = 0, every lane the Montgomery one.
struct PowSchedule {
  uint32_t step[kMaxPowSteps];
  int n_steps;
  int n_table;  // odd powers in the table: the largest digit is 2 n_table - 1
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

// x^e for a fixed e along the schedule S (0 maps to 0 when e > 0).  Every
// lane walks the same steps, so no branch diverges within a warp.
template <int N>
__global__ void mont_pow_kernel(View a, int32_t* out, int64_t B, Modulus<N> M, PowSchedule S) {
  extern __shared__ uint32_t table[];  // [n_table][N][blockDim.x]
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= B) return;
  const int T = blockDim.x;
  uint32_t* mine = table + threadIdx.x;
  uint32_t acc[N], y[N];
  if (S.n_steps == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) acc[k] = M.one[k];
    store<N>(out, B, j, acc);
    return;
  }
  load<N>(acc, a, j);
#pragma unroll
  for (int k = 0; k < N; ++k) mine[k * T] = acc[k];
  if (S.n_table > 1) {
    swt::mont_sqr<N>(y, acc, M);  // x^2
    for (int e = 1; e < S.n_table; ++e) {
      swt::mont_mul_cc<N>(acc, acc, y, M);  // x^(2e+1)
#pragma unroll
      for (int k = 0; k < N; ++k) mine[(e * N + k) * T] = acc[k];
    }
  }
  int e = (S.step[0] & 0xFFFFu) >> 1;
#pragma unroll
  for (int k = 0; k < N; ++k) acc[k] = mine[(e * N + k) * T];
  for (int s = 1; s < S.n_steps; ++s) {
    const uint32_t step = S.step[s];
    for (int q = step >> 16; q > 0; --q) swt::mont_sqr<N>(acc, acc, M);
    const uint32_t digit = step & 0xFFFFu;
    if (digit != 0) {
      e = digit >> 1;
#pragma unroll
      for (int k = 0; k < N; ++k) y[k] = mine[(e * N + k) * T];
      swt::mont_mul_cc<N>(acc, acc, y, M);
    }
  }
  store<N>(out, B, j, acc);
}

template <int N>
int launch_pow(View a, int32_t* out, int64_t B, const Modulus<N>& M, const PowSchedule& S,
               cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = B >= static_cast<int64_t>(kPowWide) * sms ? kPowWide : kPowNarrow;
  const size_t shared = sizeof(uint32_t) * N * S.n_table * threads;
  mont_pow_kernel<N><<<grid_for(B, threads), threads, shared, stream>>>(a, out, B, M, S);
  return static_cast<int>(cudaGetLastError());
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

// `steps`: the `n_steps` steps of PowSchedule (at most 384); `n_table`: the
// odd powers they read (1 to 8).  Step 0 holds an odd digit and no
// squarings, every later digit is 0 or odd, and no digit exceeds
// 2 n_table - 1; anything else returns cudaErrorInvalidValue.
int swt_mont_pow(int n_words, const int32_t* a, int64_t a_rs, int64_t a_cs, int32_t* out,
                 int64_t B, const uint32_t* p, uint32_t n0, const uint32_t* one,
                 const uint32_t* steps, int n_steps, int n_table, void* stream) {
  if (n_steps < 0 || n_steps > kMaxPowSteps || n_table < 1 || n_table > kMaxPowTable) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PowSchedule S{};
  for (int s = 0; s < n_steps; ++s) {
    const uint32_t digit = steps[s] & 0xFFFFu;
    const bool ok = s == 0 ? (steps[s] >> 16) == 0 && (digit & 1u) : digit == 0 || (digit & 1u);
    if (!ok || digit > static_cast<uint32_t>(2 * n_table - 1)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    S.step[s] = steps[s];
  }
  S.n_steps = n_steps;
  S.n_table = n_table;
  if (B <= 0) return 0;
  const View va{a, a_rs, a_cs};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_words == 8) return launch_pow<8>(va, out, B, make_modulus<8>(p, n0, one), S, s);
  if (n_words == 12) return launch_pow<12>(va, out, B, make_modulus<12>(p, n0, one), S, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Registers and local (spill) bytes a thread of mont_pow_kernel<8> and
// mont_pow_kernel<12>, into out[0..3].
int swt_field_kernel_resources(int* out) {
  const void* kernels[] = {reinterpret_cast<const void*>(mont_pow_kernel<8>),
                           reinterpret_cast<const void*>(mont_pow_kernel<12>)};
  for (int k = 0; k < 2; ++k) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, kernels[k]);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[2 * k] = attr.numRegs;
    out[2 * k + 1] = static_cast<int>(attr.localSizeBytes);
  }
  return 0;
}

}  // extern "C"
