// The NTT's kernels for BLS12-377 Fr on Hopper (sm_90a): the reduce kernel
// of the limb-matmul NTT, and the two kernels of the radix-2 butterfly NTT.
//
// ntt_reduce_kernel replaces the Pallas kernel simpleworks_tpu/ops/ntt_mxu.py
// _reduce_kernel (built by _make_reduce, pallas_call at ntt_mxu.py:171).
// That NTT is a 4-step DFT-as-matmul over 8-bit limbs: a limb-plane matrix
// product (torch.matmul in fp32, exact) leaves 63 int32 partial-limb planes,
// plane l holding the sum of the byte products at bit offset 8 l, each
// < 2^29.  This kernel recombines them into 34 carry-normalised 16-bit limbs
// (a value below p 2^272), Montgomery-reduces by 2^272 (17 rounds of 16-bit
// REDC with n0 = -p^-1 mod 2^16, as the Pallas kernel does), subtracts p
// once if needed, and writes the 16 Montgomery limbs of the result.
//
// Layout: c is [63, B] int32 with row stride c_rs (element l of lane j at
// c[l * c_rs + j]); out is a dense [16, B] int32 array of 16-bit limbs.
//
// What bounds it on the card: bytes.  A lane reads 63 * 4 B and writes
// 16 * 4 B (316 B); at B = 2^20 that is 331 MB, about 99 us at 3.35 TB/s,
// against ~300 32-bit multiply-adds a lane (~20 us at 132 SMs x 64 a clock).
// Design: one thread per lane with the whole carry chain in registers;
// neighbouring threads read neighbouring lanes of each plane, so every load
// and store coalesces.  The ragged edge is masked, so there is no tiling.
//
// The butterfly NTT (ops/ntt_butterfly.py, poly/ntt_device.py) replaces no
// Pallas kernel: it ports the XLA transform of simpleworks_tpu/poly/
// ntt_device.py, which the JAX package runs on every backend that is not a
// TPU (the MXU DFT-as-matmul above runs only on a TPU).  A transform of
// n = 2^log_n points over a batch of B contiguous transforms ([16, B, n]
// int32 Montgomery limbs) is
//   * ntt_bitrev_kernel: out[., b, j] = x[., b, rev(j)], out of place (the
//     reference's gather by _bit_reverse_indices, ntt_device.py:81), one
//     thread an output limb, one limb row after another: the writes
//     coalesce, the reads gather within a row that L2 holds;
//   * ntt_butterfly_kernel, once a stage s = 0 .. log_n - 1, in place: one
//     thread a butterfly i of B n / 2; with h = 2^s it lies in block i / h
//     at offset k = i % h, lo = its block's k-th element and hi = lo + h;
//     t = hi w^k (w = omega^(n / 2h), read as entry k n / 2h of one table of
//     the n/2 Montgomery powers of omega), lo <- lo + t, hi <- lo - t (the
//     reference's stage at ntt_device.py:82-88).  The inverse's 1/n
//     (ntt_device.py:89-90) rides on the last stage's launch: both outputs
//     are multiplied by n^-1 there.
// What bounds it: a stage reads and writes 128 B a butterfly and runs one
// Montgomery product (two on the inverse's last stage), 128 64-bit
// multiply-adds: about 1 multiply-add a byte, so the stages are bound by
// bytes (~40 us a stage at 2^20, 20 stages a transform).  The product is
// mont_mul_cc (field_arith.cuh), the carry-chain CIOS the pow proved.  A
// simple design: one launch a stage, no shared-memory stage blocks.

#include <cstdint>
#include <cuda_runtime.h>

#include "field_arith.cuh"

namespace {

constexpr int kPlanes = 63;     // 2 * 32 - 1 partial-limb planes
constexpr int kAccLimbs = 34;   // 16-bit limbs of the recombined sum
constexpr int kRedc = 17;       // REDC rounds: 2^(16 * 17) = 2^272
constexpr int kLimbs = 16;      // 16-bit limbs of an Fr element
constexpr int kThreads = 128;

struct FrConsts {
  uint32_t p[kLimbs];  // 16-bit limbs of p
  uint32_t n0;         // -p^-1 mod 2^16
};

__global__ void ntt_reduce_kernel(const int32_t* __restrict__ c, int64_t c_rs,
                                  int32_t* __restrict__ out, int64_t B, FrConsts K) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= B) return;

  // recombine: limb k (bits 16k..16k+16) gets C_{2k}, the low byte of
  // C_{2k+1} shifted up by 8, and C_{2k-1} >> 8; then carry-normalise
  uint32_t t[kAccLimbs + 1];
  uint32_t carry = 0;
  uint32_t prev_odd = 0;  // C_{2k-1}
#pragma unroll
  for (int k = 0; k < kAccLimbs; ++k) {
    uint32_t v = carry + (prev_odd >> 8);
    if (2 * k < kPlanes) v += static_cast<uint32_t>(c[(2 * k) * c_rs + j]);
    uint32_t odd = 0;
    if (2 * k + 1 < kPlanes) odd = static_cast<uint32_t>(c[(2 * k + 1) * c_rs + j]);
    v += (odd << 8) & 0xFFFFu;
    prev_odd = odd;
    t[k] = v & 0xFFFFu;
    carry = v >> 16;
  }
  t[kAccLimbs] = 0;  // headroom limb; the carry out is 0 for inputs in bound

  // REDC by 2^272: each round clears limb i (t[i] + m p_0 = 0 mod 2^16)
  // and moves its carry up; limbs stay far below 2^32 (34 additions of
  // < 2^16 at most)
#pragma unroll
  for (int i = 0; i < kRedc; ++i) {
    const uint32_t m = ((t[i] & 0xFFFFu) * K.n0) & 0xFFFFu;
#pragma unroll
    for (int k = 0; k < kLimbs; ++k) {
      const uint32_t prod = m * K.p[k];
      t[i + k] += prod & 0xFFFFu;
      t[i + k + 1] += prod >> 16;
    }
    t[i + 1] += t[i] >> 16;
  }

  // result limbs 17..32 carry-normalised; V = extra * 2^256 + res < 2p
  uint32_t res[kLimbs];
  carry = 0;
#pragma unroll
  for (int k = 0; k < kLimbs; ++k) {
    const uint32_t v = t[kRedc + k] + carry;
    res[k] = v & 0xFFFFu;
    carry = v >> 16;
  }
  const uint32_t extra = t[kRedc + kLimbs] + carry;
  uint32_t diff[kLimbs];
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < kLimbs; ++k) {
    const uint32_t d = res[k] - K.p[k] - borrow;
    diff[k] = d & 0xFFFFu;
    borrow = (d >> 31) & 1u;
  }
  const bool use_diff = (extra != 0) || (borrow == 0);
#pragma unroll
  for (int k = 0; k < kLimbs; ++k) {
    out[k * B + j] = static_cast<int32_t>(use_diff ? diff[k] : res[k]);
  }
}

// ------------------------------------------------------------ butterfly --

constexpr int kWords = 8;  // 32-bit words of an Fr element
constexpr int kMaxLog = 30;

// The inverse's last stage multiplies both outputs by n^-1 (Montgomery
// words) when `on`.
struct Scale {
  uint32_t w[kWords];
  int on;
};

__device__ __forceinline__ uint32_t bit_reverse(uint32_t j, int log_n) {
  return log_n == 0 ? 0u : __brev(j) >> (32 - log_n);
}

// x, out: [16, B, n] dense; thread t = b n + j of grid row k writes
// out[k, b, j].  One limb row a grid row: the blocks of a row run before
// the next row's, so the row's scattered reads (4 MB at n = 2^20) are served
// from L2, each 32-byte sector fetched from device memory once; a thread
// gathering all 16 rows at once spans the whole 64 MB, more than L2 holds.
__global__ void ntt_bitrev_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                                  int64_t B, int log_n) {
  const int64_t total = B << log_n;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int64_t n_mask = (static_cast<int64_t>(1) << log_n) - 1;
  const int64_t src = (t & ~n_mask) | bit_reverse(static_cast<uint32_t>(t & n_mask), log_n);
  const int64_t row = static_cast<int64_t>(blockIdx.y) * total;
  out[row + t] = x[row + src];
}

// One radix-2 stage, in place over x [16, B, n]; tw is the [16, n/2] table
// of omega^k (or omega^-k), read at stride n / 2h.
__global__ void ntt_butterfly_kernel(int32_t* __restrict__ x, int64_t B, int log_n, int log_h,
                                     const int32_t* __restrict__ tw, swt::Modulus<kWords> M,
                                     Scale S) {
  const int64_t total = B << log_n;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total / 2) return;
  const int64_t half_n = static_cast<int64_t>(1) << (log_n - 1);
  const int64_t b = i >> (log_n - 1);
  const int64_t r = i & (half_n - 1);  // butterfly within its transform
  const int64_t k = r & ((static_cast<int64_t>(1) << log_h) - 1);
  const int64_t lo = (b << log_n) + ((r >> log_h) << (log_h + 1)) + k;
  const int64_t hi = lo + (static_cast<int64_t>(1) << log_h);

  const swt::View data{x, total, 1};
  const swt::View table{tw, half_n, static_cast<int64_t>(1) << (log_n - 1 - log_h)};
  uint32_t a[kWords], c[kWords], w[kWords];
  swt::load<kWords>(a, data, lo);
  swt::load<kWords>(c, data, hi);
  swt::load<kWords>(w, table, k);
  swt::mont_mul_cc<kWords>(w, c, w, M);  // t = hi w^k
  swt::mod_add<kWords>(c, a, w, M);      // lo + t
  swt::mod_sub<kWords>(a, a, w, M);      // lo - t
  if (S.on) {
    swt::mont_mul_cc<kWords>(c, c, S.w, M);
    swt::mont_mul_cc<kWords>(a, a, S.w, M);
  }
  swt::store<kWords>(x, total, lo, c);
  swt::store<kWords>(x, total, hi, a);
}

}  // namespace

extern "C" {

// Launches on `stream`, does not synchronise, and returns cudaGetLastError()
// after the launch (0 on success).  `p16`: the 16 16-bit limbs of p.
int swt_ntt_reduce(const int32_t* c, int64_t c_rs, int32_t* out, int64_t B,
                   const uint32_t* p16, uint32_t n0, void* stream) {
  if (B <= 0) return 0;
  FrConsts K;
  for (int k = 0; k < kLimbs; ++k) K.p[k] = p16[k];
  K.n0 = n0;
  const unsigned grid = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  ntt_reduce_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(c, c_rs, out, B, K);
  return static_cast<int>(cudaGetLastError());
}

// x, out: dense [16, B, 2^log_n] int32, 0 <= log_n <= 30, out not aliasing x.
int swt_ntt_bitrev(const int32_t* x, int32_t* out, int64_t B, int log_n, void* stream) {
  if (log_n < 0 || log_n > kMaxLog || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const int64_t total = B << log_n;
  const dim3 grid(swt::grid_for(total, kThreads), kLimbs);
  ntt_bitrev_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, out, B, log_n);
  return static_cast<int>(cudaGetLastError());
}

// Stage log_h (0 <= log_h < log_n <= 30) in place over the dense
// [16, B, 2^log_n] x, with the dense [16, 2^(log_n - 1)] twiddle table tw.
// `p`, `one`: the 8 32-bit words of p and of R mod p; `scale`: NULL, or the
// 8 Montgomery words both outputs are multiplied by.
int swt_ntt_butterfly(int32_t* x, int64_t B, int log_n, int log_h, const int32_t* tw,
                      const uint32_t* p, uint32_t n0, const uint32_t* one, const uint32_t* scale,
                      void* stream) {
  if (log_n < 1 || log_n > kMaxLog || log_h < 0 || log_h >= log_n || B < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  Scale S{};
  S.on = scale != nullptr;
  for (int k = 0; k < kWords; ++k) S.w[k] = scale ? scale[k] : 0u;
  const int64_t butterflies = (B << log_n) / 2;
  ntt_butterfly_kernel<<<swt::grid_for(butterflies, kThreads), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      x, B, log_n, log_h, tw, swt::make_modulus<kWords>(p, n0, one), S);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
