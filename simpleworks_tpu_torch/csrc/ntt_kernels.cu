// The NTT's reduce kernel for BLS12-377 Fr on Hopper (sm_90a).
//
// Replaces the Pallas kernel simpleworks_tpu/ops/ntt_mxu.py _reduce_kernel
// (built by _make_reduce, pallas_call at ntt_mxu.py:171).  The NTT is a
// 4-step DFT-as-matmul over 8-bit limbs: a limb-plane matrix product
// (torch.matmul in fp32, exact) leaves 63 int32 partial-limb planes, plane l
// holding the sum of the byte products at bit offset 8 l, each < 2^29.  This
// kernel recombines them into 34 carry-normalised 16-bit limbs (a value
// below p 2^272), Montgomery-reduces by 2^272 (17 rounds of 16-bit REDC with
// n0 = -p^-1 mod 2^16, as the Pallas kernel does), subtracts p once if
// needed, and writes the 16 Montgomery limbs of the result.
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

#include <cstdint>
#include <cuda_runtime.h>

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

}  // extern "C"
