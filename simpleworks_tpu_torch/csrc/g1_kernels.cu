// Complete BLS12-377 G1 point adds on Hopper (sm_90a).
//
// Replaces the two Pallas kernels of simpleworks_tpu/ops/g1_fused_pallas.py:
//   swt_g1_fused_add        <- _fused_add_kernel, built by make_fused_add
//   swt_g1_madd_accumulate  <- _fused_madd_kernel (math in _madd_math), built
//                              by make_fused_madd, together with the scan
//                              that runs it once a row: the bucket
//                              accumulate of simpleworks_tpu/ops/
//                              msm_pippenger.py (lax.scan over gather, madd
//                              and select)
//
// A point is three (Jacobian X, Y, Z) or two (affine x, y) coordinate planes,
// each a limb-major [24, B] int32 Fq vector of 16-bit Montgomery limbs with
// its own row and column stride (field_arith.cuh).  Z = 0 encodes the
// Jacobian identity, x = y = 0 the affine one.  The result is written to one
// dense [3, 24, B] array: X, then Y, then Z.
//
// The field arithmetic is that of the field kernels (CIOS Montgomery
// multiply, modular add and subtract), so every intermediate equals the
// composed path's, and the selection order is the reference kernels'
// exactly: the outputs are Jacobian coordinates, and an equivalent but
// different (X, Y, Z) would be wrong.
//
//   add  (add-2007-bl, 16 multiplies):  double if H = 0 and r = 0; the
//        identity if H = 0, r != 0 and neither input is the identity; then
//        q = identity -> p; then p = identity -> q (the last wins).
//   madd (madd-2007-bl, Z2 = 1, 11 multiplies):  double only if also
//        neither input is the identity; the identity likewise; then
//        p = identity -> (x2, y2, 1); then q = identity -> p (the last wins).
//
// The doubling (dbl-2009-l, a = 0, 7 multiplies) runs only on the lanes
// that select it, which the branchless reference computes everywhere and
// discards: the selected values are the same.
//
// The add: one thread a lane loads its lane of the six input planes, runs
// the formula in registers and stores; the ragged edge is masked.
//
// The accumulate: lane j of a bucket group starts from the identity (or a
// given accumulator) and, for d = 0 .. depth - 1, adds table row idx[d, j]
// where valid[d, j] holds, which is select_point(valid, madd(acc, q), acc).
// On the TPU the scan's rows are a sequential loop around one kernel launch
// a row, with the accumulator in device memory between rows; here a loop
// inside the thread takes the place of the scan: one launch a group, the
// accumulator in registers from the first row to the last, stored once.
// A lane whose cell is invalid skips the row's load and arithmetic.  A
// single mixed add (fused_madd) is the depth-1 case.
//
// What bounds it on the card: a valid cell does 11 multiplies of 288 32-bit
// multiply-adds and reads a 192-byte row, so the integer multiply rate
// bounds it (3.8 ms for the ~20 M valid cells of a 2^20-point c = 13
// group), three times the bytes' 1.2 ms.  Reaching that rate takes enough
// warps to hide the latency of the dependent carry chains and of the
// gathers.  Occupancy: one lane holds the accumulator, the added point and
// ~8 temporaries of 12 words, and each of an SM's four schedulers holds the
// registers of its own warps, so an SM runs 8 warps at up to 255 registers
// a thread, 12 at 168 and 16 at 128.  __launch_bounds__(128, 3) asks for
// 12, which costs a few spilled words.  Each thread loads its own row with
// twelve 16-byte loads when it needs it.  On the H100, 12 warps ran the
// 2^20 group faster than 8 or 16, and a cp.async prefetch of row d + 1
// into shared memory while row d computes bought nothing at either
// occupancy: the chains' latency, not the gathers', is what the warps hide
// (PERF.md, row 6).

#include <cstdint>
#include <cuda_runtime.h>

#include "field_arith.cuh"

namespace {

constexpr int N = 12;  // 32-bit words of an Fq element
constexpr int kLimbs = 2 * N;
constexpr int kThreads = 64;

using Fe = uint32_t[N];
using Mod = swt::Modulus<N>;

template <int K>
struct Views {
  swt::View v[K];
};

__device__ __forceinline__ void mul(Fe& r, const Fe& a, const Fe& b, const Mod& M) {
  swt::mont_mul<N>(r, a, b, M);
}
__device__ __forceinline__ void add(Fe& r, const Fe& a, const Fe& b, const Mod& M) {
  swt::mod_add<N>(r, a, b, M);
}
__device__ __forceinline__ void sub(Fe& r, const Fe& a, const Fe& b, const Mod& M) {
  swt::mod_sub<N>(r, a, b, M);
}

// (X3, Y3, Z3) = 2 (X1, Y1, Z1), dbl-2009-l with a = 0, in the operation
// order of g1_limb.double.
__device__ __forceinline__ void dbl(Fe& X3, Fe& Y3, Fe& Z3, const Fe& X1, const Fe& Y1,
                                    const Fe& Z1, const Mod& M) {
  Fe A, Bs, C, D, E, t;
  mul(A, X1, X1, M);
  mul(Bs, Y1, Y1, M);
  mul(C, Bs, Bs, M);
  add(t, X1, Bs, M);
  mul(D, t, t, M);
  sub(D, D, A, M);
  sub(D, D, C, M);
  add(D, D, D, M);
  add(E, A, A, M);
  add(E, E, A, M);
  mul(X3, E, E, M);  // F
  add(t, D, D, M);
  sub(X3, X3, t, M);
  add(C, C, C, M);  // 8C
  add(C, C, C, M);
  add(C, C, C, M);
  sub(t, D, X3, M);
  mul(Y3, E, t, M);
  sub(Y3, Y3, C, M);
  add(t, Y1, Y1, M);
  mul(Z3, t, Z1, M);
}

__device__ __forceinline__ void store_point(int32_t* out, int64_t B, int64_t j, const Fe& X,
                                            const Fe& Y, const Fe& Z) {
  swt::store<N>(out, B, j, X);
  swt::store<N>(out + kLimbs * B, B, j, Y);
  swt::store<N>(out + 2 * kLimbs * B, B, j, Z);
}

__global__ void g1_fused_add_kernel(Views<6> in, int32_t* out, int64_t B, Mod M) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= B) return;
  Fe X1, Y1, Z1, X2, Y2, Z2;
  swt::load<N>(X1, in.v[0], j);
  swt::load<N>(Y1, in.v[1], j);
  swt::load<N>(Z1, in.v[2], j);
  swt::load<N>(X2, in.v[3], j);
  swt::load<N>(Y2, in.v[4], j);
  swt::load<N>(Z2, in.v[5], j);

  // general addition (add-2007-bl), in the operation order of g1_limb.add
  Fe Z1Z1, Z2Z2, U1, S1, H, rr, I, J, t, X3, Y3, Z3;
  mul(Z1Z1, Z1, Z1, M);
  mul(Z2Z2, Z2, Z2, M);
  mul(U1, X1, Z2Z2, M);
  mul(H, X2, Z1Z1, M);  // U2
  mul(S1, Y1, Z2, M);
  mul(S1, S1, Z2Z2, M);
  mul(rr, Y2, Z1, M);   // S2
  mul(rr, rr, Z1Z1, M);
  sub(H, H, U1, M);     // H = U2 - U1
  sub(rr, rr, S1, M);   // r = S2 - S1
  const bool h_zero = swt::is_zero<N>(H);
  const bool r_zero = swt::is_zero<N>(rr);
  add(rr, rr, rr, M);   // r2 = 2 r
  add(t, H, H, M);
  mul(I, t, t, M);
  mul(J, H, I, M);
  mul(U1, U1, I, M);    // V = U1 I
  mul(X3, rr, rr, M);
  sub(X3, X3, J, M);
  add(t, U1, U1, M);
  sub(X3, X3, t, M);
  mul(J, S1, J, M);     // S1 J
  add(J, J, J, M);
  sub(t, U1, X3, M);
  mul(Y3, rr, t, M);
  sub(Y3, Y3, J, M);
  add(t, Z1, Z2, M);
  mul(t, t, t, M);
  sub(t, t, Z1Z1, M);
  sub(t, t, Z2Z2, M);
  mul(Z3, t, H, M);

  const bool p_ident = swt::is_zero<N>(Z1);
  const bool q_ident = swt::is_zero<N>(Z2);
  if (h_zero && r_zero) dbl(X3, Y3, Z3, X1, Y1, Z1, M);
  if (h_zero && !r_zero && !p_ident && !q_ident) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      X3[k] = M.one[k];
      Y3[k] = M.one[k];
      Z3[k] = 0;
    }
  }
  if (q_ident) {
    swt::copy<N>(X3, X1);
    swt::copy<N>(Y3, Y1);
    swt::copy<N>(Z3, Z1);
  }
  if (p_ident) {
    swt::copy<N>(X3, X2);
    swt::copy<N>(Y3, Y2);
    swt::copy<N>(Z3, Z2);
  }
  store_point(out, B, j, X3, Y3, Z3);
}

// (X3, Y3, Z3) = (X1, Y1, Z1) + (X2, Y2), the complete mixed addition
// (madd-2007-bl, Z2 = 1) in the operation order of g1_limb.madd, with the
// reference kernel's case order: double only if H = 0, r = 0 and neither
// input is the identity; the identity likewise when r != 0; then
// p = identity -> (x2, y2, 1); then q = identity -> p (the last wins).
__device__ __forceinline__ void madd_complete(Fe& X3, Fe& Y3, Fe& Z3, const Fe& X1, const Fe& Y1,
                                              const Fe& Z1, const Fe& X2, const Fe& Y2,
                                              const Mod& M) {
  Fe Z1Z1, H, rr, HH, I, J, t;
  mul(Z1Z1, Z1, Z1, M);
  mul(H, X2, Z1Z1, M);  // U2
  mul(rr, Y2, Z1, M);
  mul(rr, rr, Z1Z1, M); // S2
  sub(H, H, X1, M);     // H = U2 - X1
  sub(rr, rr, Y1, M);   // r = S2 - Y1
  const bool h_zero = swt::is_zero<N>(H);
  const bool r_zero = swt::is_zero<N>(rr);
  mul(HH, H, H, M);
  add(t, HH, HH, M);
  add(I, t, t, M);
  mul(J, H, I, M);
  add(rr, rr, rr, M);   // r2 = 2 r
  mul(I, X1, I, M);     // V = X1 I
  mul(X3, rr, rr, M);
  sub(X3, X3, J, M);
  add(t, I, I, M);
  sub(X3, X3, t, M);
  mul(J, Y1, J, M);     // Y1 J
  add(J, J, J, M);
  sub(t, I, X3, M);
  mul(Y3, rr, t, M);
  sub(Y3, Y3, J, M);
  add(t, Z1, H, M);
  mul(t, t, t, M);
  sub(t, t, Z1Z1, M);
  sub(Z3, t, HH, M);

  const bool p_ident = swt::is_zero<N>(Z1);
  const bool q_ident = swt::is_zero<N>(X2) && swt::is_zero<N>(Y2);
  if (h_zero && r_zero && !p_ident && !q_ident) dbl(X3, Y3, Z3, X1, Y1, Z1, M);
  if (h_zero && !r_zero && !p_ident && !q_ident) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      X3[k] = M.one[k];
      Y3[k] = M.one[k];
      Z3[k] = 0;
    }
  }
  if (p_ident) {
    swt::copy<N>(X3, X2);
    swt::copy<N>(Y3, Y2);
#pragma unroll
    for (int k = 0; k < N; ++k) Z3[k] = M.one[k];
  }
  if (q_ident) {
    swt::copy<N>(X3, X1);
    swt::copy<N>(Y3, Y1);
    swt::copy<N>(Z3, Z1);
  }
}

// ---------------------------------------------------------- the accumulate --

constexpr int kPointVecs = 2 * kLimbs / 4;  // a table row: 48 int32 limbs, 12 16-byte vectors
constexpr int kAccumulateThreads = 128;
constexpr int kAccumulateBlocksPerSm = 3;

struct AccumulateArgs {
  swt::View acc[3];  // the starting accumulator, if has_acc
  int has_acc;
  const int4* rows;     // [n, 48] int32: x limbs, then y limbs
  const int64_t* idx;   // [depth, lanes]
  const bool* valid;    // [depth, lanes]
  int64_t depth;
  int64_t lanes;
  int32_t* out;  // [3, 24, lanes]
};

__device__ __forceinline__ void pack_pair(uint32_t& lo, uint32_t& hi, const int4 a) {
  lo = (static_cast<uint32_t>(a.x) & 0xFFFFu) | ((static_cast<uint32_t>(a.y) & 0xFFFFu) << 16);
  hi = (static_cast<uint32_t>(a.z) & 0xFFFFu) | ((static_cast<uint32_t>(a.w) & 0xFFFFu) << 16);
}

// x, y of one table row (12 vectors of four 16-bit limbs) packed into words.
__device__ __forceinline__ void unpack_point(Fe& X, Fe& Y, const int4* v) {
#pragma unroll
  for (int c = 0; c < kPointVecs / 2; ++c) {
    pack_pair(X[2 * c], X[2 * c + 1], v[c]);
    pack_pair(Y[2 * c], Y[2 * c + 1], v[kPointVecs / 2 + c]);
  }
}

// One thread a lane: the lane's accumulator stays in registers over all
// depth rows and is stored once; a row whose cell is invalid is skipped.
__global__ void __launch_bounds__(kAccumulateThreads, kAccumulateBlocksPerSm)
    g1_madd_accumulate_kernel(AccumulateArgs a, Mod M) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kAccumulateThreads + threadIdx.x;
  if (j >= a.lanes) return;
  Fe X, Y, Z;
  if (a.has_acc) {
    swt::load<N>(X, a.acc[0], j);
    swt::load<N>(Y, a.acc[1], j);
    swt::load<N>(Z, a.acc[2], j);
  } else {  // the identity (one, one, 0)
#pragma unroll
    for (int k = 0; k < N; ++k) {
      X[k] = M.one[k];
      Y[k] = M.one[k];
      Z[k] = 0;
    }
  }
  for (int64_t d = 0; d < a.depth; ++d) {
    const int64_t at = d * a.lanes + j;
    if (!a.valid[at]) continue;
    int4 v[kPointVecs];
    const int4* src = a.rows + a.idx[at] * kPointVecs;
#pragma unroll
    for (int c = 0; c < kPointVecs; ++c) v[c] = __ldg(src + c);
    Fe X2, Y2, X3, Y3, Z3;
    unpack_point(X2, Y2, v);
    madd_complete(X3, Y3, Z3, X, Y, Z, X2, Y2, M);
    swt::copy<N>(X, X3);
    swt::copy<N>(Y, Y3);
    swt::copy<N>(Z, Z3);
  }
  store_point(a.out, a.lanes, j, X, Y, Z);
}

template <int K>
Views<K> unpack_views(const int64_t* views) {
  Views<K> v;
  for (int i = 0; i < K; ++i) {
    v.v[i].ptr = reinterpret_cast<const int32_t*>(static_cast<uintptr_t>(views[3 * i]));
    v.v[i].row_stride = views[3 * i + 1];
    v.v[i].col_stride = views[3 * i + 2];
  }
  return v;
}

}  // namespace

extern "C" {

// `views`: (data pointer, row stride, column stride) of each input plane, in
// the order X1, Y1, Z1, X2, Y2, Z2; `out`: a dense [3, 24, B] int32 array;
// `p`, `one`: 12 little-endian words of q and of R mod q; `n0`: -q^-1 mod
// 2^32.  Each launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch (0 on success).

int swt_g1_fused_add(const int64_t* views, int32_t* out, int64_t B, const uint32_t* p,
                     uint32_t n0, const uint32_t* one, void* stream) {
  if (B <= 0) return 0;
  const unsigned grid = swt::grid_for(B, kThreads);
  g1_fused_add_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      unpack_views<6>(views), out, B, swt::make_modulus<N>(p, n0, one));
  return static_cast<int>(cudaGetLastError());
}

// `acc_views`: (data pointer, row stride, column stride) of the starting
// X, Y, Z planes, or null for the identity; `rows`: [n, 48] int32, 16-byte
// aligned; `idx`: [depth, lanes] int64 rows of `rows`; `valid`: [depth,
// lanes] bool; `out`: a dense [3, 24, lanes] int32 array.  Launches on
// `stream` like the add above.
int swt_g1_madd_accumulate(const int64_t* acc_views, const int32_t* rows, const int64_t* idx,
                           const bool* valid, int64_t depth, int64_t lanes, int32_t* out,
                           const uint32_t* p, uint32_t n0, const uint32_t* one, void* stream) {
  if (lanes <= 0) return 0;
  AccumulateArgs a;
  a.has_acc = acc_views != nullptr;
  if (a.has_acc) {
    const Views<3> v = unpack_views<3>(acc_views);
    for (int i = 0; i < 3; ++i) a.acc[i] = v.v[i];
  }
  a.rows = reinterpret_cast<const int4*>(rows);
  a.idx = idx;
  a.valid = valid;
  a.depth = depth;
  a.lanes = lanes;
  a.out = out;
  g1_madd_accumulate_kernel<<<swt::grid_for(lanes, kAccumulateThreads), kAccumulateThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      a, swt::make_modulus<N>(p, n0, one));
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread and local memory a thread (spills) of each kernel as
// compiled: out[0..1] for the add, out[2..3] for the accumulate.
int swt_g1_kernel_resources(int* out) {
  const void* kernels[] = {reinterpret_cast<const void*>(g1_fused_add_kernel),
                           reinterpret_cast<const void*>(g1_madd_accumulate_kernel)};
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
