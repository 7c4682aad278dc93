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
// int32 Montgomery limbs) computes what the reference's bit reversal and
// log_n radix-2 stages compute (ntt_device.py:81-90), canonical values, so
// the result equals the reference's bit for bit.
//
// ntt_pass_kernel, the route of every transform: a four-step (Bailey) split
// of n into passes of tiles of T = 2^log_t <= 2^11 points (one pass for
// n <= 2^11, two up to 2^22).  Pass p, with D = 2^(points of the earlier
// passes) and S = n / T, reads column lo (0 <= lo < S) of its input as the
// T points t S + lo, runs a size-T DFT on it in shared memory, and writes
// output k of it to q T D + k D + r (lo = q D + r), times omega^(D q k) when
// a later pass follows (the four-step's twiddle) and times the inverse's
// 1/n on the last pass.  A block takes C = 2^log_c neighbouring columns, so
// a warp's loads and stores cover runs of C consecutive words of a limb row
// (whole rows on the first pass's stores); the tile is loaded once, runs all
// its log_t stages between block barriers, and is stored once, so a
// transform of two passes reads and writes the data twice, where the stage
// route read and wrote it log_n + 1 times.
//   * Between passes the data is packed, 8 words an element in one 32-byte
//     row ([B n, 8]): half the bytes of the [16, B, n] limb planes, and a
//     column run of C elements is C whole sectors.  The first pass reads the
//     limb planes, the last writes them.
//   * The tile sits in shared memory as 8 packed 32-bit words an element,
//     word-plane-major (a warp's lanes read one word each of neighbouring
//     elements), columns padded by 32 / C words and positions XOR-swizzled
//     so that the loads, the stages and the bit-reversed reads of the store
//     fall in distinct banks.
//   * In-tile stages run decimation in frequency (Gentleman-Sande): natural
//     order in, bit-reversed order out, lo <- lo + hi, hi <- (lo - hi) w^k;
//     the store reads the tile in bit-reversed order, so the bit reversal
//     costs no pass of its own.  Blocks of 2^10 points or more run the
//     stages in pairs (a thread takes four points through stages h and h/2
//     between two barriers: half the barriers and tile traffic, 124
//     registers); smaller blocks one stage a barrier (82 registers), which
//     ran faster there (the plan is the host's, ops/ntt_butterfly.py).  The
//     stage twiddles w^k = omega_2h^k of all stages sit in one table of
//     T - 1 entries (stage h from entry h - 1), loaded into shared memory
//     once a block: a warp reads consecutive entries.  The first stage's
//     (h = 1) twiddle is 1 and is not applied.
//   * The four-step twiddle omega^E, E = D q k < n, costs two packed table
//     reads and one product an element: hi[E >> log_lo] lo[E & (2^log_lo -
//     1)] (tables of n / 2^log_lo and 2^log_lo entries, L2-resident).
//   * Products are mont_mul_cc (field_arith.cuh), adds and subtracts mod_add
//     and mod_sub: every value stays canonical.
// What bounds it: a 2^20 transform in two passes moves 192 MB (0.057 ms at
// 3.35 TB/s) and runs (n/2) log2 n products plus two an element for the
// twiddle (~0.09 ms at 64 multiply-adds a clock an SM): operations.  What
// holds it back (PERF.md): a block's loads, stages and stores run one
// after another, and at 2^11-point tiles one block fills an SM's shared
// memory, so an SM's memory traffic and its products do not overlap.

// The stage route, kept as the baseline the pass kernel is checked and timed
// against (chip_smoke.py check_ntt; no path runs it):
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
//     (ntt_device.py:89-90) rides on the last stage's launch.  Each stage
//     reads and writes the whole array: bytes-bound, ~75 us a stage at 2^20.

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

// ----------------------------------------------------------- pass kernel --

constexpr int kMaxTileLog = 11;     // 2^11 points a column
constexpr int kMaxColumnsLog = 5;   // 32 columns a block
constexpr int kMaxPassThreads = 512;

struct PassArgs {
  int log_n;    // points a transform
  int log_t;    // points a column (the tile)
  int log_c;    // columns a block
  int log_d;    // points the earlier passes transformed: D = 2^log_d
  int log_lo;   // entries of the low four-step table: 2^log_lo
  int twiddle;  // multiply output k of column lo by omega^(D q k) (all passes but the last)
  int scale;    // multiply every output by Scale::w (the inverse's last pass)
  int in_packed;   // the input is packed (8 words an element, 32 B), not [16, B, n] limbs
  int out_packed;  // the output likewise (every pass but the last)
};

// Word offset of tile position pos in a column: the low 5 bits XOR the top
// 5 (bits 5..9 for tiles below 2^10), a bijection that sends a warp's
// bit-reversed reads and its natural-order accesses to distinct banks.
__device__ __forceinline__ int swizzle(int pos, int log_t) {
  return pos ^ ((pos >> max(5, log_t - 5)) & 31);
}

__device__ __forceinline__ int column_stride(int log_t, int log_c) {
  const int T = 1 << log_t;
  return T + (T >= 32 ? (32 >> log_c) : 0);
}

__device__ __forceinline__ void load_entry(uint32_t (&w)[kWords], const uint4* __restrict__ tab,
                                           int64_t i) {
  const uint4 a = tab[2 * i], b = tab[2 * i + 1];
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

// One pass over x into out (not aliasing), each [16, B, n] limbs or, where
// A.in_packed / A.out_packed, [B n, 8] packed words (element-major, the
// passes' intermediate: half the bytes, an element one 32-byte sector).
// stage_tw: [2^kMaxTileLog - 1 or fewer, 8] packed entries, stage h's from entry h - 1;
// hi, lo: [n / 2^log_lo, 8] and [2^log_lo, 8] packed powers of omega (read
// only when A.twiddle).  Block g0 / C takes columns g0 .. g0 + C - 1 of the
// B S columns (column g: transform g / S, lo = g % S).
template <bool kQuad>
__global__ void __launch_bounds__(kMaxPassThreads)
ntt_pass_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out, int64_t B, PassArgs A,
                const uint4* __restrict__ stage_tw, const uint4* __restrict__ hi,
                const uint4* __restrict__ lo_tab, swt::Modulus<kWords> M, Scale S) {
  extern __shared__ uint32_t smem[];
  const int T = 1 << A.log_t, C = 1 << A.log_c;
  const int cs = column_stride(A.log_t, A.log_c);
  const int ps = C * cs;                    // words of one word plane of the tile
  uint32_t* tw = smem;                      // [8][T]: the stage twiddles
  uint32_t* tile = smem + kWords * T;       // [8][C * cs]
  const int log_s = A.log_n - A.log_t;
  const int64_t s_mask = (static_cast<int64_t>(1) << log_s) - 1;
  const int64_t plane = B << A.log_n;
  const int64_t cols = B << log_s;
  const int64_t g0 = static_cast<int64_t>(blockIdx.x) << A.log_c;

  for (int i = threadIdx.x; i < T - 1; i += blockDim.x) {
    uint32_t w[kWords];
    load_entry(w, stage_tw, i);
#pragma unroll
    for (int k = 0; k < kWords; ++k) tw[k * T + i] = w[k];
  }
  // load, natural order: lane (t, c) reads point t of column c.  Columns
  // lie side by side when S > 1, so a warp's lanes of one t read C
  // consecutive words of each limb row; a one-pass transform's column is a
  // whole transform, so its lanes walk t
#pragma unroll 4
  for (int idx = threadIdx.x; idx < C * T; idx += blockDim.x) {
    const int c = log_s ? idx & (C - 1) : idx >> A.log_t;
    const int t = log_s ? idx >> A.log_c : idx & (T - 1);
    const int64_t g = g0 + c;
    uint32_t w[kWords];
    if (g < cols) {
      const int64_t src =
          ((g >> log_s) << A.log_n) + (static_cast<int64_t>(t) << log_s) + (g & s_mask);
      if (A.in_packed) {
        load_entry(w, reinterpret_cast<const uint4*>(x), src);
      } else {
#pragma unroll
        for (int k = 0; k < kWords; ++k) {
          const uint32_t l0 = static_cast<uint32_t>(x[(2 * k) * plane + src]) & 0xFFFFu;
          const uint32_t l1 = static_cast<uint32_t>(x[(2 * k + 1) * plane + src]) & 0xFFFFu;
          w[k] = l0 | (l1 << 16);
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < kWords; ++k) w[k] = 0;
    }
    const int at = c * cs + swizzle(t, A.log_t);
#pragma unroll
    for (int k = 0; k < kWords; ++k) tile[k * ps + at] = w[k];
  }
  __syncthreads();

  // the size-T DFT of every column, decimation in frequency: h = T/2 .. 1,
  // two stages (h, h/2) a barrier on the four points p, p + h/2, p + h,
  // p + 3h/2 where kQuad, the last odd stage alone
  int s = A.log_t - 1;
  while (s >= 0) {
    const int h = 1 << s;
    if (kQuad && s >= 1) {
      const int hh = h >> 1;
      for (int i = threadIdx.x; i < (C * T) >> 2; i += blockDim.x) {
        const int c = i >> (A.log_t - 2), j = i & ((T >> 2) - 1);
        const int k = j & (hh - 1);
        const int p = ((j >> (s - 1)) << (s + 1)) | k;
        const int at[4] = {c * cs + swizzle(p, A.log_t), c * cs + swizzle(p + hh, A.log_t),
                           c * cs + swizzle(p + h, A.log_t), c * cs + swizzle(p + h + hh, A.log_t)};
        uint32_t v[4][kWords], d[kWords], f[kWords];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int w = 0; w < kWords; ++w) v[q][w] = tile[w * ps + at[q]];
        }
        // stage h: (p, p + h) by omega_2h^k, (p + h/2, p + 3h/2) by omega_2h^(k + h/2)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          swt::mod_sub<kWords>(d, v[q], v[q + 2], M);
          swt::mod_add<kWords>(v[q], v[q], v[q + 2], M);
#pragma unroll
          for (int w = 0; w < kWords; ++w) f[w] = tw[w * T + h - 1 + k + q * hh];
          swt::mont_mul_cc<kWords>(v[q + 2], d, f, M);
        }
        // stage h/2: (p, p + h/2) and (p + h, p + 3h/2) by omega_h^k
        if (hh > 1) {
#pragma unroll
          for (int w = 0; w < kWords; ++w) f[w] = tw[w * T + hh - 1 + k];
        }
#pragma unroll
        for (int q = 0; q < 4; q += 2) {
          swt::mod_sub<kWords>(d, v[q], v[q + 1], M);
          swt::mod_add<kWords>(v[q], v[q], v[q + 1], M);
          if (hh > 1) {
            swt::mont_mul_cc<kWords>(v[q + 1], d, f, M);
          } else {
#pragma unroll
            for (int w = 0; w < kWords; ++w) v[q + 1][w] = d[w];
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int w = 0; w < kWords; ++w) tile[w * ps + at[q]] = v[q][w];
        }
      }
      s -= 2;
    } else {
      for (int i = threadIdx.x; i < (C * T) >> 1; i += blockDim.x) {
        const int c = i >> (A.log_t - 1), j = i & ((T >> 1) - 1);
        const int k = j & (h - 1);
        const int p_lo = ((j >> s) << (s + 1)) | k;
        const int a_at = c * cs + swizzle(p_lo, A.log_t);
        const int b_at = c * cs + swizzle(p_lo + h, A.log_t);
        uint32_t a[kWords], b[kWords], d[kWords];
#pragma unroll
        for (int w = 0; w < kWords; ++w) {
          a[w] = tile[w * ps + a_at];
          b[w] = tile[w * ps + b_at];
        }
        swt::mod_sub<kWords>(d, a, b, M);
        swt::mod_add<kWords>(a, a, b, M);
        if (s > 0) {
          uint32_t f[kWords];
#pragma unroll
          for (int w = 0; w < kWords; ++w) f[w] = tw[w * T + h - 1 + k];
          swt::mont_mul_cc<kWords>(d, d, f, M);
        }
#pragma unroll
        for (int w = 0; w < kWords; ++w) {
          tile[w * ps + a_at] = a[w];
          tile[w * ps + b_at] = d[w];
        }
      }
      s -= 1;
    }
    __syncthreads();
  }

  // store: tile position pos holds output k = rev(pos).  The first pass
  // (D = 1) writes a column's T outputs contiguously, so its lanes walk k;
  // a later pass writes runs of C columns a row, so its lanes walk (pos, c)
  uint32_t scale_w[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) scale_w[w] = S.w[w];
  const int64_t d_mask = (static_cast<int64_t>(1) << A.log_d) - 1;
  const int64_t lo_mask = (static_cast<int64_t>(1) << A.log_lo) - 1;
  for (int idx = threadIdx.x; idx < C * T; idx += blockDim.x) {
    int c, k, pos;
    if (A.log_d == 0) {
      c = idx >> A.log_t;
      k = idx & (T - 1);
      pos = static_cast<int>(bit_reverse(static_cast<uint32_t>(k), A.log_t));
    } else {
      c = idx & (C - 1);
      pos = idx >> A.log_c;
      k = static_cast<int>(bit_reverse(static_cast<uint32_t>(pos), A.log_t));
    }
    const int64_t g = g0 + c;
    if (g >= cols) continue;
    const int at = c * cs + swizzle(pos, A.log_t);
    uint32_t v[kWords];
#pragma unroll
    for (int w = 0; w < kWords; ++w) v[w] = tile[w * ps + at];
    const int64_t lo = g & s_mask;
    if (A.twiddle) {
      const int64_t e = (lo & ~d_mask) * k;  // D q k < n
      uint32_t f[kWords], f_lo[kWords];
      load_entry(f, hi, e >> A.log_lo);
      load_entry(f_lo, lo_tab, e & lo_mask);
      swt::mont_mul_cc<kWords>(f, f, f_lo, M);
      swt::mont_mul_cc<kWords>(v, v, f, M);
    }
    if (A.scale) swt::mont_mul_cc<kWords>(v, v, scale_w, M);
    const int64_t dst = ((g >> log_s) << A.log_n) + (((lo & ~d_mask) << A.log_t) |
                                                     (static_cast<int64_t>(k) << A.log_d) |
                                                     (lo & d_mask));
    if (A.out_packed) {
      uint4* to = reinterpret_cast<uint4*>(out) + 2 * dst;
      to[0] = make_uint4(v[0], v[1], v[2], v[3]);
      to[1] = make_uint4(v[4], v[5], v[6], v[7]);
    } else {
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        out[(2 * w) * plane + dst] = static_cast<int32_t>(v[w] & 0xFFFFu);
        out[(2 * w + 1) * plane + dst] = static_cast<int32_t>(v[w] >> 16);
      }
    }
  }
}

// Bytes of shared memory a block of ntt_pass_kernel takes: the stage
// twiddles (T words a plane) and the tile (C column strides a plane).
int64_t pass_smem_bytes(int log_t, int log_c) {
  const int64_t T = static_cast<int64_t>(1) << log_t;
  const int64_t cs = T + (T >= 32 ? (32 >> log_c) : 0);
  return static_cast<int64_t>(sizeof(uint32_t)) * kWords *
         (T + (static_cast<int64_t>(1) << log_c) * cs);
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

// The whole transform of the dense [16, B, 2^log_n] x into out (not aliasing
// x): n_passes launches of ntt_pass_kernel, pass p with plan[4p .. 4p + 3] =
// (log_t, log_c, threads, quad: stages in pairs), the log_t summing to
// log_n.  The passes before the last write packed words: into scratch
// (B 2^log_n 8 words; unused and may be NULL for one pass), and from three
// passes on, alternately, into out's storage, so that the last pass reads
// scratch and writes out.  stage_tw: packed [2^stage_log - 1, 8] stage
// twiddles (stage_log >= every log_t); hi, lo: packed [2^(log_n - log_lo),
// 8] and [2^log_lo, 8] powers of omega (omega^(i 2^log_lo) and omega^i);
// `p`, `one`: the 8 32-bit words of p and of R mod p; `scale`: NULL, or
// the 8 Montgomery words the last pass multiplies every output by.
int swt_ntt_transform(const int32_t* x, int32_t* out, int32_t* scratch, int64_t B, int log_n,
                      const int* plan, int n_passes, const uint32_t* stage_tw, int stage_log,
                      const uint32_t* hi, const uint32_t* lo, int log_lo, const uint32_t* p,
                      uint32_t n0, const uint32_t* one, const uint32_t* scale, void* stream) {
  if (log_n < 0 || log_n > kMaxLog || B < 0 || n_passes < 1 || n_passes > kMaxLog + 1 ||
      stage_log < 0 || stage_log > kMaxTileLog || log_lo < 0 || log_lo > log_n ||
      x == nullptr || out == nullptr || stage_tw == nullptr || hi == nullptr || lo == nullptr ||
      (n_passes > 1 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  int total = 0;
  int64_t smem_need = 0;
  for (int q = 0; q < n_passes; ++q) {
    const int log_t = plan[4 * q], log_c = plan[4 * q + 1], threads = plan[4 * q + 2];
    if (log_t < 0 || log_t > stage_log || log_c < 0 || log_c > kMaxColumnsLog || threads < 32 ||
        threads > kMaxPassThreads || threads % 32 != 0 ||
        pass_smem_bytes(log_t, log_c) > smem_max ||
        (plan[4 * q + 3] != 0 && plan[4 * q + 3] != 1) ||
        ((B << (log_n - log_t)) >> log_c) >= 0x7FFFFFFF) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    total += log_t;
    if (pass_smem_bytes(log_t, log_c) > smem_need) smem_need = pass_smem_bytes(log_t, log_c);
  }
  if (total != log_n) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  if (smem_need > 48 * 1024) {
    err = cudaFuncSetAttribute(ntt_pass_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_need));
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(ntt_pass_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem_need));
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const swt::Modulus<kWords> M = swt::make_modulus<kWords>(p, n0, one);
  Scale S{};
  for (int k = 0; k < kWords; ++k) S.w[k] = scale ? scale[k] : 0u;
  const int32_t* src = x;
  int done = 0;
  for (int q = 0; q < n_passes; ++q) {
    const int log_t = plan[4 * q], log_c = plan[4 * q + 1], threads = plan[4 * q + 2];
    const bool last = q == n_passes - 1;
    int32_t* dst = last ? out : (n_passes - 2 - q) % 2 == 0 ? scratch : out;
    PassArgs A{log_n, log_t, log_c, done, log_lo, last ? 0 : 1, last && scale != nullptr,
               q > 0, !last};
    const int64_t columns = B << (log_n - log_t);
    const int64_t blocks = (columns + (static_cast<int64_t>(1) << log_c) - 1) >> log_c;
    auto kernel = plan[4 * q + 3] ? ntt_pass_kernel<true> : ntt_pass_kernel<false>;
    kernel<<<static_cast<unsigned>(blocks), threads,
             static_cast<size_t>(pass_smem_bytes(log_t, log_c)),
             static_cast<cudaStream_t>(stream)>>>(
        src, dst, B, A, reinterpret_cast<const uint4*>(stage_tw),
        reinterpret_cast<const uint4*>(hi), reinterpret_cast<const uint4*>(lo), M, S);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
    done += log_t;
  }
  return 0;
}

// Registers, local (spill) bytes and the thread limit of ntt_pass_kernel as
// the card's compiler built it, and the shared memory a block may opt in to
// on the current device: out[0..3] for the build that runs one stage a
// barrier, out[4..5] the registers and local bytes of the one that runs
// stages in pairs.
int swt_ntt_kernel_resources(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, ntt_pass_kernel<true>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[4] = attr.numRegs;
  out[5] = static_cast<int>(attr.localSizeBytes);
  err = cudaFuncGetAttributes(&attr, ntt_pass_kernel<false>);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, smem_max = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = attr.maxThreadsPerBlock;
  out[3] = smem_max;
  return 0;
}

}  // extern "C"
