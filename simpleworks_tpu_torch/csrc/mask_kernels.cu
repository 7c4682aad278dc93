// The Marlin prover's zero-knowledge mask, drawn on Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package draws the outer-sumcheck mask on
// the host (simpleworks_tpu/marlin/ahp.py:289, Fr.rand_vec).  Drawn there,
// it took ~1.5 s of a ~3 s prove at n = 2^17 on an H100 machine's host: a
// Python big-int step for each of ~674k eight-word attempts, then each of
// the 3n = 393,216 values turned back into Montgomery limbs and copied up.
//
// What it computes (ops/mask_draw.py holds the plain version): arkworks'
// Fp256::rand draws 8 keystream words an attempt, clears the top
// repr_shave_bits of the last, and keeps the attempt if it is below p; the
// kept 256-bit value is the element's Montgomery representation (R = 2^256).
// So the accepted attempts' words, split into 16-bit halves, are the
// [16, 3n] int32 Montgomery columns of the port's layout as they stand: no
// product is needed.  The mask's coefficients are the first 3n accepted
// attempts from keystream word `start` on, in stream order, and then
// coeffs[0] = -(coeffs[n] + coeffs[2n]) mod p (linear, so it holds in
// Montgomery form; 0 stays 0).  `start` is any word offset, so an attempt
// may straddle two ChaCha blocks.
//
// Two launches an entry call, each a thread a ChaCha block:
//   mask_count_kernel  makes the keystream, counts each block's accepted
//                      attempts; the last block to finish (a ticket taken
//                      after a fence) scans the counts into each block's
//                      first output index, and stores the total;
//   mask_write_kernel  makes the same keystream again, ranks the accepted
//                      attempts inside the block (a block scan), and writes
//                      the limbs at the block's first index plus the rank;
//                      the thread that writes the last coefficient stores
//                      the words consumed; the last block to finish applies
//                      the fix-up.
// Recomputing the keystream costs less than keeping it: the words come to
// 21.5 MB at n = 2^17, written once and read once, against ~600 integer
// operations a 64-byte block.  Two passes over one scan of ~1,500 counts
// were chosen over one pass with a decoupled look-back: no block waits on
// another, and the order of the output is fixed by the scan, whatever order
// the blocks run in.  A block of kThreads threads makes kThreads ChaCha
// blocks into shared memory and tests the 2 (kThreads - 1) attempts whose
// words lie inside them (the last ChaCha block is the next block's first,
// made twice: 1/256 more work), two a thread.
//
// What bounds it: the draw needs ~337k ChaCha12 blocks at n = 2^17 (3n
// accepted at p / 2^253 = 0.584), each 12 rounds x 4 quarter rounds x 12
// 32-bit adds, xors and rotates plus 16 adds: 2.0e8 integer operations,
// 12 us at 132 SMs x 64 a clock x 1.98 GHz, against 25.2 MB of limbs out at
// 3.35 TB/s, 7.5 us.  So the keystream's operations bound it; the two
// passes, the 1.9x over-draw (whose blocks past the 3n-th attempt the write
// pass skips) and the halo cost about four times that: 0.049 ms on an H100
// (SXM, 700 W), both passes and the scratch fill.

#include <cstdint>
#include <cuda_runtime.h>

#include "field_arith.cuh"

namespace {

using swt::make_modulus;
using swt::Modulus;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Attempts a block tests: two a thread, the last thread's ChaCha block only
// the halo of the one before it.
constexpr int kAttemptsPerBlock = 2 * (kThreads - 1);
// The keystream of a block in shared memory, a pad word every 32 so that a
// warp's threads, 16 words apart, store to distinct banks.
constexpr int kStreamWords = 16 * kThreads;
constexpr int kSharedWords = kStreamWords + kStreamWords / 32;
// The scratch's slots after the per-block counts.
constexpr int kCountTicket = 0;
constexpr int kWriteTicket = 1;
constexpr int kTotal = 2;
constexpr int kConsumed = 3;
constexpr int kScratchExtra = 4;

struct Key {
  uint32_t w[8];
};

__device__ __forceinline__ int padded(int w) { return w + (w >> 5); }

__device__ __forceinline__ uint32_t rotl(uint32_t x, int n) { return __funnelshift_l(x, x, n); }

__device__ __forceinline__ void quarter(uint32_t& a, uint32_t& b, uint32_t& c, uint32_t& d) {
  a += b; d ^= a; d = rotl(d, 16);
  c += d; b ^= c; b = rotl(b, 12);
  a += b; d ^= a; d = rotl(d, 8);
  c += d; b ^= c; b = rotl(b, 7);
}

// ChaCha block `counter` (64-bit counter in words 12-13, zero nonce), as
// utils/rng.py _chacha_block makes it, into this thread's 16 shared words.
__device__ void make_block(uint32_t* stream, const Key& key, int rounds, uint64_t counter) {
  const uint32_t init[16] = {0x61707865u, 0x3320646Eu, 0x79622D32u, 0x6B206574u,
                             key.w[0], key.w[1], key.w[2], key.w[3],
                             key.w[4], key.w[5], key.w[6], key.w[7],
                             static_cast<uint32_t>(counter), static_cast<uint32_t>(counter >> 32),
                             0u, 0u};
  uint32_t x[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = init[i];
  for (int r = 0; r < rounds; r += 2) {
    quarter(x[0], x[4], x[8], x[12]);
    quarter(x[1], x[5], x[9], x[13]);
    quarter(x[2], x[6], x[10], x[14]);
    quarter(x[3], x[7], x[11], x[15]);
    quarter(x[0], x[5], x[10], x[15]);
    quarter(x[1], x[6], x[11], x[12]);
    quarter(x[2], x[7], x[8], x[13]);
    quarter(x[3], x[4], x[9], x[14]);
  }
  const int base = 16 * threadIdx.x;
#pragma unroll
  for (int i = 0; i < 16; ++i) stream[padded(base + i)] = x[i] + init[i];
}

// Attempt e of the block (its words at shared offset `offset` + 8 e), its
// top word masked: below p?
__device__ __forceinline__ bool accepted(uint32_t (&w)[8], const uint32_t* stream, int offset,
                                         int e, uint32_t top_mask, const Modulus<8>& M) {
#pragma unroll
  for (int k = 0; k < 8; ++k) w[k] = stream[padded(offset + 8 * e + k)];
  w[7] &= top_mask;
  bool below = false, decided = false;
#pragma unroll
  for (int k = 7; k >= 0; --k) {
    if (!decided && w[k] != M.p[k]) {
      below = w[k] < M.p[k];
      decided = true;
    }
  }
  return below;
}

// The block's exclusive prefix sum of v, and its total into *total.
__device__ long long block_exclusive_scan(long long v, long long* total) {
  __shared__ long long warp_sums[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(0xFFFFFFFFu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    long long s = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const long long y = __shfl_up_sync(0xFFFFFFFFu, s, d);
      if (lane >= d) s += y;
    }
    if (lane < kWarps) warp_sums[lane] = s;
  }
  __syncthreads();
  const long long before = warp ? warp_sums[warp - 1] : 0;
  *total = warp_sums[kWarps - 1];
  __syncthreads();  // warp_sums is free for the next call
  return before + inc - v;
}

// Whether this block is the last of the grid to reach here: each block's
// stores are fenced before its ticket, so the last block sees them all.
__device__ bool last_to_finish(unsigned long long* ticket) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1ull) == gridDim.x - 1;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

struct Draw {
  Key key;
  int rounds;
  uint64_t first_block;  // the ChaCha block that holds word `start`
  int offset;            // start % 16
  long long attempts;    // 8-word attempts this call tests
  uint32_t top_mask;     // the last word's bits below repr_shave_bits
};

__global__ void __launch_bounds__(kThreads)
mask_count_kernel(Draw D, Modulus<8> M, long long* scratch) {
  __shared__ uint32_t stream[kSharedWords];
  const long long grid = gridDim.x;
  make_block(stream, D.key, D.rounds,
             D.first_block + static_cast<uint64_t>(blockIdx.x) * (kThreads - 1) + threadIdx.x);
  __syncthreads();
  long long kept = 0;
  if (threadIdx.x < kThreads - 1) {
    uint32_t w[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = 2 * threadIdx.x + h;
      const long long a = static_cast<long long>(blockIdx.x) * kAttemptsPerBlock + e;
      kept += a < D.attempts && accepted(w, stream, D.offset, e, D.top_mask, M);
    }
  }
  long long total;
  block_exclusive_scan(kept, &total);
  if (threadIdx.x == 0) scratch[blockIdx.x] = total;
  if (!last_to_finish(reinterpret_cast<unsigned long long*>(scratch + grid + kCountTicket))) return;
  // every block's count -> its first output index
  long long carry = 0;
  for (long long base = 0; base < grid; base += kThreads) {
    const long long i = base + threadIdx.x;
    const long long v = i < grid ? __ldcg(scratch + i) : 0;
    long long sum;
    const long long before = block_exclusive_scan(v, &sum);
    if (i < grid) scratch[i] = carry + before;
    carry += sum;
  }
  if (threadIdx.x == 0) scratch[grid + kTotal] = carry;
}

__device__ __forceinline__ void load_cg(uint32_t (&x)[8], const int32_t* out, int64_t row_stride,
                                        int64_t j) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t lo = static_cast<uint32_t>(__ldcg(out + (2 * k) * row_stride + j)) & 0xFFFFu;
    const uint32_t hi = static_cast<uint32_t>(__ldcg(out + (2 * k + 1) * row_stride + j)) & 0xFFFFu;
    x[k] = lo | (hi << 16);
  }
}

// Writes accepted attempts [0, remaining) of this call to columns filled ..
// of `out` ([16, row_stride]); the call that completes the mask applies the
// fix-up over stride n (none for n = 0).
__global__ void __launch_bounds__(kThreads)
mask_write_kernel(Draw D, Modulus<8> M, int32_t* out, int64_t row_stride, int64_t filled,
                  long long remaining, int64_t n, long long* scratch) {
  __shared__ uint32_t stream[kSharedWords];
  const long long grid = gridDim.x;
  const long long first = scratch[blockIdx.x];  // the block's first output index
  if (first < remaining) {  // the same for every thread of the block
    make_block(stream, D.key, D.rounds,
               D.first_block + static_cast<uint64_t>(blockIdx.x) * (kThreads - 1) + threadIdx.x);
    __syncthreads();
    uint32_t w[2][8];
    bool keep[2] = {false, false};
    if (threadIdx.x < kThreads - 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = 2 * threadIdx.x + h;
        const long long a = static_cast<long long>(blockIdx.x) * kAttemptsPerBlock + e;
        keep[h] = a < D.attempts && accepted(w[h], stream, D.offset, e, D.top_mask, M);
      }
    }
    long long total;
    long long index = first + block_exclusive_scan(keep[0] + keep[1], &total);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!keep[h]) continue;
      if (index < remaining) {
        swt::store<8>(out, row_stride, filled + index, w[h]);
        if (index == remaining - 1) {
          const long long a = static_cast<long long>(blockIdx.x) * kAttemptsPerBlock +
                              2 * threadIdx.x + h;
          scratch[grid + kConsumed] = 8 * (a + 1);
        }
      }
      ++index;
    }
  }
  if (!last_to_finish(reinterpret_cast<unsigned long long*>(scratch + grid + kWriteTicket))) return;
  if (threadIdx.x != 0) return;
  if (scratch[grid + kTotal] < remaining) {  // short: the next call goes on from here
    scratch[grid + kConsumed] = 8 * D.attempts;
    return;
  }
  if (n <= 0) return;
  uint32_t sum[8] = {0, 0, 0, 0, 0, 0, 0, 0}, x[8];
  for (int64_t j = n; j < row_stride; j += n) {
    load_cg(x, out, row_stride, j);
    swt::mod_add<8>(sum, sum, x, M);
  }
  const uint32_t zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  uint32_t neg[8];
  swt::mod_sub<8>(neg, zero, sum, M);
  swt::store<8>(out, row_stride, 0, neg);
}

}  // namespace

extern "C" {

// Draws `remaining` accepted attempts of Fr's UniformRand from keystream
// word `start` on (`key`: the ChaCha key's 8 words; `rounds`: 12 or 20),
// testing at most `attempts` attempts, into columns filled .. filled +
// remaining of the [16, row_stride] int32 `out`.  `scratch`: scratch_len =
// ceil(attempts / (2 * 255)) + 4 int64, zeroed; on return (once the stream
// is synchronised) scratch[scratch_len - 2] holds the attempts accepted and
// scratch[scratch_len - 1] the keystream words consumed: 8 x (the index of
// the remaining-th accepted attempt + 1), or 8 x attempts if fewer were
// accepted.  The call that fills the last column sets out[:, 0] to
// -(sum of out[:, j n], j >= 1) mod p (n = 0: no fix-up).  Launches two
// kernels on `stream`, does not synchronise, and returns cudaGetLastError()
// (0 on success; cudaErrorInvalidValue for bad sizes).
int swt_mask_draw(const uint32_t* key, int rounds, int64_t start, int64_t attempts, int32_t* out,
                  int64_t row_stride, int64_t filled, int64_t remaining, int64_t n,
                  const uint32_t* p, uint32_t n0, const uint32_t* one, uint32_t top_mask,
                  int64_t* scratch, int64_t scratch_len, void* stream) {
  const int64_t grid = (attempts + kAttemptsPerBlock - 1) / kAttemptsPerBlock;
  if (rounds <= 0 || rounds % 2 || start < 0 || attempts <= 0 || remaining <= 0 ||
      filled < 0 || filled + remaining > row_stride || n < 0 || n >= row_stride ||
      grid > 0x7FFFFFFF || scratch_len != grid + kScratchExtra) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Draw D;
  for (int k = 0; k < 8; ++k) D.key.w[k] = key[k];
  D.rounds = rounds;
  D.first_block = static_cast<uint64_t>(start / 16);
  D.offset = static_cast<int>(start % 16);
  D.attempts = attempts;
  D.top_mask = top_mask;
  const Modulus<8> M = make_modulus<8>(p, n0, one);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long* counts = reinterpret_cast<long long*>(scratch);
  mask_count_kernel<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(D, M, counts);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mask_write_kernel<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
      D, M, out, row_stride, filled, remaining, n, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
