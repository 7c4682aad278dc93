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
//   swt_g1_bucket_combine   <- _fused_add_kernel again, together with the
//                              loops that run it in that file's
//                              accumulate_windows: the segment fold and the
//                              two suffix passes (lax.fori_loop over
//                              g1_limb.add of a dynamic-slice shift)
//   swt_g1_fixed_base       <- _fused_add_kernel once more, together with the
//                              scan that runs it once a window in
//                              simpleworks_tpu/ops/srs_device.py: the SRS's
//                              fixed-base powers (lax.scan of 32 gathers and
//                              adds over the lanes)
//
// A point is three (Jacobian X, Y, Z) or two (affine x, y) coordinate planes,
// each a limb-major [24, B] int32 Fq vector of 16-bit Montgomery limbs with
// its own row and column stride (field_arith.cuh).  Z = 0 encodes the
// Jacobian identity, x = y = 0 the affine one.  The result is written to one
// dense [3, 24, B] array: X, then Y, then Z.
//
// The field arithmetic is that of field_arith.cuh: the carry-chain
// Montgomery multiply and squaring (mont_mul_cc, mont_sqr), which give the
// words of the field kernels' multiply, and the modular add and subtract,
// so every intermediate equals the composed path's; and the selection order
// is the reference kernels' exactly: the outputs are Jacobian coordinates,
// and an equivalent but different (X, Y, Z) would be wrong.  On the H100
// the carry chains ran the add 2.9x, the accumulate 2.2x and the combine
// 2.7x faster than the 64-bit CIOS of swt::mont_mul (PERF.md, rows 6-7).
//
//   add  (add-2007-bl, 11 multiplies, 5 squarings):  double if H = 0 and
//        r = 0; the identity if H = 0, r != 0 and neither input is the
//        identity; then q = identity -> p; then p = identity -> q (the last
//        wins).
//   madd (madd-2007-bl, Z2 = 1, 7 multiplies, 4 squarings):  double only
//        if also neither input is the identity; the identity likewise; then
//        p = identity -> (x2, y2, 1); then q = identity -> p (the last wins).
//
// The doubling (dbl-2009-l, a = 0, 2 multiplies, 5 squarings) runs only on
// the lanes that select it, which the branchless reference computes
// everywhere and discards: the selected values are the same.
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
// What bounds it on the card: a valid cell does 7 multiplies of 288 32-bit
// multiply-adds and 4 squarings of 222 and reads a 192-byte row, so the
// integer multiply rate bounds it (3.5 ms for the ~20 M valid cells of a
// 2^20-point c = 13 group), three times the bytes' 1.2 ms.  Reaching that
// rate takes enough warps to hide the latency of the dependent carry chains
// and of the gathers.  Occupancy: one lane holds the accumulator, the added
// point and ~8 temporaries of 12 words, and each of an SM's four schedulers
// holds the registers of its own warps, so an SM runs 8 warps at up to 255
// registers a thread, 12 at 168 and 16 at 128.  __launch_bounds__(128, 3)
// asks for 12, which costs a few spilled words (184 bytes).  Each thread
// loads its own row with twelve 16-byte loads when it needs it.  On the H100,
// 12 warps ran the 2^20 group faster than 8 or 16, and a cp.async prefetch of
// row d + 1 into shared memory while row d computes bought nothing at either
// occupancy: the chains' latency, not the gathers', is what the warps hide
// (PERF.md, row 6).
//
// The combine: a group's bucket sums S_{w,s,d} (the accumulate's output,
// lane w S b + s b + d) become its window sums sum_d d S_{w,d} in
// log2 S + 2 log2 b steps, each adding to every lane of its width the lane
// a shift away (the step loop of g1_bucket_combine_kernel says which).  On
// the TPU the steps are one compiled graph; launched one add at a time they
// cost ~40 launches a group from the host, with a copy or a concatenation
// before each.  What bounds it: the adds' products, 4,278 multiply-adds a
// lane that runs the formula, ~3.7 M such lanes (0.9 ms) at the
// 2^20 c = 13 group against 45 MB read once, and in the 2^17 groups' narrow
// steps (32 to 7,936 lanes) the latency of one add's dependent multiplies,
// since most SMs then have no lane to run.  The design: every step in one
// cooperative launch, a grid-stride loop a step and a grid-wide barrier
// between steps (the grid is what the SMs hold at once, so all blocks are
// resident); the lanes of a step live in two ping-pong buffers of packed
// 32-bit words, half the bytes of the 16-bit limb planes; a lane whose
// operand lies past its window skips the arithmetic.  Occupancy:
// __launch_bounds__(64, 4), 8 warps an SM at up to 255 registers, holds the
// formula in 255 with 88 bytes of spills.  It was chosen on the CIOS product,
// which it held in 254 without spills, when (128, 3), 12 warps at 168
// registers with 336 bytes of spills, ran 3-16 % slower at the three MSM
// groups of the path on the H100 (PERF.md, row 7).
//
// The fixed base: lane j of the setup's powers is s_j G for a standard-form
// scalar s_j < 2^256, cut into 32 digits of 8 bits, digit w selecting row
// 256 w + d of a window table of d 2^(8w) G (row 256 w the identity).  On the
// TPU a scan of 32 steps gathers each lane's row and adds it to the
// accumulator, the accumulator in device memory between steps; launched one
// add at a time that is 32 launches a 2^19-lane chunk, each writing a
// gathered copy of the rows.  What bounds it on the card: 31 adds of 4,278
// 32-bit multiply-adds a lane (window 0 adds to the identity), against 64
// bytes of scalar in and 288 out, so the integer multiply rate.  The design:
// one launch for all lanes, one thread a lane, the accumulator in registers
// over all 32 windows and stored once; the table packed as 8192 rows of 36
// 32-bit words (1.2 MB, which stays in L2), a lane loading its own 144-byte
// row as nine 16-byte vectors.  The complete add's selects become branches
// taken before the arithmetic: an identity accumulator takes the row (the
// last select, p = identity -> q: all of window 0), an identity row leaves
// the accumulator (q = identity -> p: digit 0), and the equal-x cases double
// or cancel; the general formula computes Z3 right after H so that Z1 and Z2
// die early. Every value is a canonical residue, so the words are the plain
// version's. Occupancy: __launch_bounds__(128, 2), 8 warps an SM, holds a
// lane in its registers without spills, as (64, 4) and (256, 1) do; (128, 3)
// and (64, 5), 12 and 10 warps at 168 registers, spill and ran slower on the
// H100, and (128, 2) ran fastest at the setup's 1,572,862 lanes, its
// squarings faster on mont_sqr than on mont_mul_cc (PERF.md, row 7).

#include <algorithm>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "field_arith.cuh"

namespace cg = cooperative_groups;

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

// The Montgomery product and square on the carry chains of field_arith.cuh
// (mont_mul_cc, mont_sqr): the words of swt::mont_mul.
__device__ __forceinline__ void mul(Fe& r, const Fe& a, const Fe& b, const Mod& M) {
  swt::mont_mul_cc<N>(r, a, b, M);
}
__device__ __forceinline__ void sqr(Fe& r, const Fe& a, const Mod& M) {
  swt::mont_sqr<N>(r, a, M);
}
__device__ __forceinline__ void add(Fe& r, const Fe& a, const Fe& b, const Mod& M) {
  swt::mod_add<N>(r, a, b, M);
}
__device__ __forceinline__ void sub(Fe& r, const Fe& a, const Fe& b, const Mod& M) {
  swt::mod_sub<N>(r, a, b, M);
}

// (X3, Y3, Z3) = 2 (X1, Y1, Z1), dbl-2009-l with a = 0, in the operation
// order of g1_limb.double.  The outputs must not alias the inputs.
__device__ __forceinline__ void dbl(Fe& X3, Fe& Y3, Fe& Z3, const Fe& X1, const Fe& Y1,
                                    const Fe& Z1, const Mod& M) {
  Fe A, Bs, C, D, E, t;
  sqr(A, X1, M);
  sqr(Bs, Y1, M);
  sqr(C, Bs, M);
  add(t, X1, Bs, M);
  sqr(D, t, M);
  sub(D, D, A, M);
  sub(D, D, C, M);
  add(D, D, D, M);
  add(E, A, A, M);
  add(E, E, A, M);
  sqr(X3, E, M);  // F
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

// (X, Y, Z) = (one, one, 0), the Jacobian identity of g1_limb.identity.
__device__ __forceinline__ void set_identity(Fe& X, Fe& Y, Fe& Z, const Mod& M) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    X[k] = M.one[k];
    Y[k] = M.one[k];
    Z[k] = 0;
  }
}

__device__ __forceinline__ void store_point(int32_t* out, int64_t B, int64_t j, const Fe& X,
                                            const Fe& Y, const Fe& Z) {
  swt::store<N>(out, B, j, X);
  swt::store<N>(out + kLimbs * B, B, j, Y);
  swt::store<N>(out + 2 * kLimbs * B, B, j, Z);
}

// (X3, Y3, Z3) = (X1, Y1, Z1) + (X2, Y2, Z2), the complete Jacobian addition
// (add-2007-bl) in the operation order of g1_limb.add, with the reference
// kernel's case order: double if H = 0 and r = 0; the identity if H = 0,
// r != 0 and neither input is the identity; then q = identity -> p; then
// p = identity -> q (the last wins).
__device__ __forceinline__ void add_complete(Fe& X3, Fe& Y3, Fe& Z3, const Fe& X1, const Fe& Y1,
                                             const Fe& Z1, const Fe& X2, const Fe& Y2,
                                             const Fe& Z2, const Mod& M) {
  Fe Z1Z1, Z2Z2, U1, S1, H, rr, I, J, t;
  sqr(Z1Z1, Z1, M);
  sqr(Z2Z2, Z2, M);
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
  sqr(I, t, M);
  mul(J, H, I, M);
  mul(U1, U1, I, M);    // V = U1 I
  sqr(X3, rr, M);
  sub(X3, X3, J, M);
  add(t, U1, U1, M);
  sub(X3, X3, t, M);
  mul(J, S1, J, M);     // S1 J
  add(J, J, J, M);
  sub(t, U1, X3, M);
  mul(Y3, rr, t, M);
  sub(Y3, Y3, J, M);
  add(t, Z1, Z2, M);
  sqr(t, t, M);
  sub(t, t, Z1Z1, M);
  sub(t, t, Z2Z2, M);
  mul(Z3, t, H, M);

  const bool p_ident = swt::is_zero<N>(Z1);
  const bool q_ident = swt::is_zero<N>(Z2);
  if (h_zero && r_zero) dbl(X3, Y3, Z3, X1, Y1, Z1, M);
  if (h_zero && !r_zero && !p_ident && !q_ident) set_identity(X3, Y3, Z3, M);
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
}

__global__ void g1_fused_add_kernel(Views<6> in, int32_t* out, int64_t B, Mod M) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= B) return;
  Fe X1, Y1, Z1, X2, Y2, Z2, X3, Y3, Z3;
  swt::load<N>(X1, in.v[0], j);
  swt::load<N>(Y1, in.v[1], j);
  swt::load<N>(Z1, in.v[2], j);
  swt::load<N>(X2, in.v[3], j);
  swt::load<N>(Y2, in.v[4], j);
  swt::load<N>(Z2, in.v[5], j);
  add_complete(X3, Y3, Z3, X1, Y1, Z1, X2, Y2, Z2, M);
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
  sqr(Z1Z1, Z1, M);
  mul(H, X2, Z1Z1, M);  // U2
  mul(rr, Y2, Z1, M);
  mul(rr, rr, Z1Z1, M); // S2
  sub(H, H, X1, M);     // H = U2 - X1
  sub(rr, rr, Y1, M);   // r = S2 - Y1
  const bool h_zero = swt::is_zero<N>(H);
  const bool r_zero = swt::is_zero<N>(rr);
  sqr(HH, H, M);
  add(t, HH, HH, M);
  add(I, t, t, M);
  mul(J, H, I, M);
  add(rr, rr, rr, M);   // r2 = 2 r
  mul(I, X1, I, M);     // V = X1 I
  sqr(X3, rr, M);
  sub(X3, X3, J, M);
  add(t, I, I, M);
  sub(X3, X3, t, M);
  mul(J, Y1, J, M);     // Y1 J
  add(J, J, J, M);
  sub(t, I, X3, M);
  mul(Y3, rr, t, M);
  sub(Y3, Y3, J, M);
  add(t, Z1, H, M);
  sqr(t, t, M);
  sub(t, t, Z1Z1, M);
  sub(Z3, t, HH, M);

  const bool p_ident = swt::is_zero<N>(Z1);
  const bool q_ident = swt::is_zero<N>(X2) && swt::is_zero<N>(Y2);
  if (h_zero && r_zero && !p_ident && !q_ident) dbl(X3, Y3, Z3, X1, Y1, Z1, M);
  if (h_zero && !r_zero && !p_ident && !q_ident) set_identity(X3, Y3, Z3, M);
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
  } else {
    set_identity(X, Y, Z, M);
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

// ------------------------------------------------------------ the combine --

constexpr int kCombineThreads = 64;
constexpr int kCombineBlocksPerSm = 4;

struct CombineArgs {
  swt::View in[3];  // the accumulate's X, Y, Z planes: [24, W S b], lane w S b + s b + d
  uint32_t* buf[2];  // ping-pong steps: [3, 12, cap] 32-bit words each
  int64_t cap;  // lanes of the widest step
  int64_t windows, segs, buckets;
  int fold_steps, log_b;  // log2 S, log2 b
  int32_t* out;  // [3, 24, W]: the window sums
};

// A lane of a ping-pong buffer: X, Y, Z, each 12 packed words, word k of
// coordinate c at buf[(c N + k) cap + j].  The buffers are written and read
// inside one launch, so they are read with plain loads (never __ldg): after
// grid.sync() every block sees what the others stored.
__device__ __forceinline__ void load_words(Fe& X, Fe& Y, Fe& Z, const uint32_t* buf,
                                           int64_t cap, int64_t j) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    X[k] = buf[k * cap + j];
    Y[k] = buf[(N + k) * cap + j];
    Z[k] = buf[(2 * N + k) * cap + j];
  }
}

__device__ __forceinline__ void store_words(uint32_t* buf, int64_t cap, int64_t j, const Fe& X,
                                            const Fe& Y, const Fe& Z) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    buf[k * cap + j] = X[k];
    buf[(N + k) * cap + j] = Y[k];
    buf[(2 * N + k) * cap + j] = Z[k];
  }
}

// Lane j of the step's source: the input planes (src < 0) or buffer src.
__device__ __forceinline__ void load_lane(Fe& X, Fe& Y, Fe& Z, const CombineArgs& a, int src,
                                          int64_t j) {
  if (src < 0) {
    swt::load<N>(X, a.in[0], j);
    swt::load<N>(Y, a.in[1], j);
    swt::load<N>(Z, a.in[2], j);
  } else {
    load_words(X, Y, Z, a.buf[src], a.cap, j);
  }
}

// The whole bucket combine of one group in log2 S + 2 log2 b steps, each a
// grid-stride loop over its lanes from one ping-pong buffer into the other,
// with a grid-wide barrier between steps (a cooperative launch, every block
// resident).  Lane i of a step adds the lanes jp and jp + k of its source:
//   fold, s = S, S/2, .., 2:  lane (w, s' < s/2, d) <- (w, s', d) +
//       (w, s' + s/2, d), so jp = w s b + s' b + d and k = (s/2) b;
//   suffix passes, k = 1, 2, .., b/2, twice:  lane (w, d) <- (w, d) +
//       (w, d + k), the identity past the window; before the second pass
//       T_0 is the identity, and lane (w, 0) of its last step, the window
//       sum, is the only lane written out.
__global__ void __launch_bounds__(kCombineThreads, kCombineBlocksPerSm)
    g1_bucket_combine_kernel(CombineArgs a, Mod M) {
  cg::grid_group grid = cg::this_grid();
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kCombineThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kCombineThreads;
  const int64_t b = a.buckets;
  int src = -1, dst = 0;
  for (int t = 0; t < a.fold_steps + 2 * a.log_b; ++t) {
    const bool fold = t < a.fold_steps;
    const int u = t - a.fold_steps;  // the suffix step
    const int64_t half_lanes = (a.segs >> (t + 1)) * b;  // of one window, in a fold step
    const int64_t k = fold ? half_lanes : int64_t{1} << (u % a.log_b);
    const bool reset = u == a.log_b;
    const bool last = u == 2 * a.log_b - 1;
    const int64_t lanes = a.windows * (fold ? half_lanes : b);
    for (int64_t i = first; i < lanes; i += stride) {
      const int64_t jp = fold ? i + (i / half_lanes) * half_lanes : i;
      const int64_t d = i & (b - 1);
      Fe X1, Y1, Z1, X3, Y3, Z3;
      if (reset && d == 0) {
        set_identity(X1, Y1, Z1, M);
      } else {
        load_lane(X1, Y1, Z1, a, src, jp);
      }
      if (fold || d + k < b) {
        Fe X2, Y2, Z2;
        load_lane(X2, Y2, Z2, a, src, jp + k);
        add_complete(X3, Y3, Z3, X1, Y1, Z1, X2, Y2, Z2, M);
      } else if (swt::is_zero<N>(Z1)) {
        // past the window the operand is the identity q = (one, one, 0):
        // the full formula's q_ident case gives p, then its p_ident case
        // (the last wins) gives q, so an identity p becomes (one, one, 0)
        set_identity(X3, Y3, Z3, M);
      } else {  // ... and any other p stays p
        swt::copy<N>(X3, X1);
        swt::copy<N>(Y3, Y1);
        swt::copy<N>(Z3, Z1);
      }
      if (!last) {
        store_words(a.buf[dst], a.cap, i, X3, Y3, Z3);
      } else if (d == 0) {
        store_point(a.out, a.windows, i / b, X3, Y3, Z3);
      }
    }
    if (last) return;
    grid.sync();
    src = dst;
    dst ^= 1;
  }
}

// One cooperative launch of the combine: the grid is the blocks an SM can
// hold at once times the SMs, so every block is resident for the grid-wide
// barriers, or fewer where the widest step has fewer lanes than that.
cudaError_t launch_combine(const CombineArgs& a, const Mod& M, cudaStream_t stream) {
  const void* kernel = reinterpret_cast<const void*>(g1_bucket_combine_kernel);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kCombineThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int64_t blocks = std::min<int64_t>(static_cast<int64_t>(per_sm) * sms,
                                           (a.cap + kCombineThreads - 1) / kCombineThreads);
  CombineArgs args = a;
  Mod mod = M;
  void* params[] = {&args, &mod};
  return cudaLaunchCooperativeKernel(kernel, dim3(static_cast<unsigned>(blocks)),
                                     dim3(kCombineThreads), params, 0, stream);
}

// ---------------------------------------------------------- the fixed base --

constexpr int kWindows = 32;         // 8-bit digits of a 256-bit scalar
constexpr int kWindowRows = 256;     // rows a window: d 2^(8w) G, d = 0 .. 255
constexpr int kRowVecs = 3 * N / 4;  // a packed row, X, Y, Z words: nine 16-byte vectors
constexpr int kFixedBaseThreads = 128;
constexpr int kFixedBaseBlocksPerSm = 2;

struct FixedBaseArgs {
  swt::View scalars;  // [16, lanes] 16-bit limbs of the standard-form scalars
  const int4* table;  // [kWindows * kWindowRows, 36] words: X, Y, Z of row 256 w + d
  int64_t lanes;
  int32_t* out;  // [3, 24, lanes]
};

// Words 4c .. 4c + 3 of x from one 16-byte vector.
__device__ __forceinline__ void put_vec(Fe& x, int c, const int4 v) {
  x[4 * c] = static_cast<uint32_t>(v.x);
  x[4 * c + 1] = static_cast<uint32_t>(v.y);
  x[4 * c + 2] = static_cast<uint32_t>(v.z);
  x[4 * c + 3] = static_cast<uint32_t>(v.w);
}

__device__ __forceinline__ void load_row(Fe& X, Fe& Y, Fe& Z, const int4* row) {
#pragma unroll
  for (int c = 0; c < N / 4; ++c) {
    put_vec(X, c, __ldg(row + c));
    put_vec(Y, c, __ldg(row + N / 4 + c));
    put_vec(Z, c, __ldg(row + N / 2 + c));
  }
}

// Row 256 w + d of lane j's window w: d is byte w & 1 of limb row w >> 1.
__device__ __forceinline__ const int4* window_row(const FixedBaseArgs& a, int64_t j, int w) {
  const uint32_t limb = static_cast<uint32_t>(
      a.scalars.ptr[(w >> 1) * a.scalars.row_stride + j * a.scalars.col_stride]);
  const uint32_t d = (limb >> (8 * (w & 1))) & 0xFFu;
  return a.table + (static_cast<int64_t>(w) * kWindowRows + d) * kRowVecs;
}

// (X, Y, Z) += (X2, Y2, Z2) for two points neither of which is the
// identity: add_complete's values.  The equal-x cases double (H = 0, r = 0)
// or cancel (H = 0, r != 0); the general formula computes
// Z3 = ((Z1 + Z2)^2 - Z1Z1 - Z2Z2) H first, after which neither Z1 nor Z2
// is read, and writes X3 and Y3 over X1 and Y1, which only U1 and S1 read.
__device__ __forceinline__ void add_points(Fe& X, Fe& Y, Fe& Z, const Fe& X2, const Fe& Y2,
                                           const Fe& Z2, const Mod& M) {
  Fe Z1Z1, Z2Z2, U1, S1, H, rr, t;
  sqr(Z1Z1, Z, M);
  sqr(Z2Z2, Z2, M);
  mul(U1, X, Z2Z2, M);
  mul(H, X2, Z1Z1, M);  // U2
  mul(S1, Y, Z2, M);
  mul(S1, S1, Z2Z2, M);
  mul(rr, Y2, Z, M);
  mul(rr, rr, Z1Z1, M);  // S2
  sub(H, H, U1, M);      // H = U2 - U1
  sub(rr, rr, S1, M);    // r = S2 - S1
  if (swt::is_zero<N>(H)) {
    Fe X3, Y3, Z3;
    if (swt::is_zero<N>(rr)) {
      dbl(X3, Y3, Z3, X, Y, Z, M);
    } else {
      set_identity(X3, Y3, Z3, M);
    }
    swt::copy<N>(X, X3);
    swt::copy<N>(Y, Y3);
    swt::copy<N>(Z, Z3);
    return;
  }
  add(t, Z, Z2, M);
  sqr(t, t, M);
  sub(t, t, Z1Z1, M);
  sub(t, t, Z2Z2, M);
  mul(Z, t, H, M);  // Z3
  add(rr, rr, rr, M);  // r2 = 2 r
  add(t, H, H, M);
  sqr(Z1Z1, t, M);        // I = (2 H)^2
  mul(Z2Z2, H, Z1Z1, M);  // J = H I
  mul(U1, U1, Z1Z1, M);   // V = U1 I
  sqr(X, rr, M);
  sub(X, X, Z2Z2, M);
  add(t, U1, U1, M);
  sub(X, X, t, M);         // X3 = r2^2 - J - 2 V
  mul(Z2Z2, S1, Z2Z2, M);  // S1 J
  add(Z2Z2, Z2Z2, Z2Z2, M);
  sub(t, U1, X, M);
  mul(Y, rr, t, M);
  sub(Y, Y, Z2Z2, M);  // Y3 = r2 (V - X3) - 2 S1 J
}

// One thread a lane walks all 32 windows with its accumulator in
// registers: the identity plus window 0's row is that row; then each
// window's row is loaded and added, the complete add's selects taken as
// branches in its order (p = identity -> q wins over q = identity -> p).
__global__ void __launch_bounds__(kFixedBaseThreads, kFixedBaseBlocksPerSm)
    g1_fixed_base_kernel(FixedBaseArgs a, Mod M) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kFixedBaseThreads + threadIdx.x;
  if (j >= a.lanes) return;
  Fe X, Y, Z;
  load_row(X, Y, Z, window_row(a, j, 0));
#pragma unroll 1
  for (int w = 1; w < kWindows; ++w) {
    Fe X2, Y2, Z2;
    load_row(X2, Y2, Z2, window_row(a, j, w));
    if (swt::is_zero<N>(Z)) {
      swt::copy<N>(X, X2);
      swt::copy<N>(Y, Y2);
      swt::copy<N>(Z, Z2);
    } else if (!swt::is_zero<N>(Z2)) {
      add_points(X, Y, Z, X2, Y2, Z2, M);
    }
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

// `in_views`: (data pointer, row stride, column stride) of the X, Y, Z
// planes of the accumulate's [24, W S b] output, lane w S b + s b + d;
// `bufs`: two int32 scratch arrays of 36 cap words each, cap = W b
// max(S / 2, 1); `out`: a dense [3, 24, W] int32 array.  S and b are powers
// of two, b >= 2.  One cooperative launch on `stream` like the adds above.
int swt_g1_bucket_combine(const int64_t* in_views, int32_t* buf0, int32_t* buf1, int64_t windows,
                          int64_t segs, int64_t buckets, int32_t* out, const uint32_t* p,
                          uint32_t n0, const uint32_t* one, void* stream) {
  if (windows <= 0) return 0;
  CombineArgs a;
  const Views<3> v = unpack_views<3>(in_views);
  for (int i = 0; i < 3; ++i) a.in[i] = v.v[i];
  a.buf[0] = reinterpret_cast<uint32_t*>(buf0);
  a.buf[1] = reinterpret_cast<uint32_t*>(buf1);
  a.cap = windows * buckets * (segs > 1 ? segs / 2 : 1);
  a.windows = windows;
  a.segs = segs;
  a.buckets = buckets;
  a.fold_steps = 0;
  while ((int64_t{1} << a.fold_steps) < segs) ++a.fold_steps;
  a.log_b = 0;
  while ((int64_t{1} << a.log_b) < buckets) ++a.log_b;
  a.out = out;
  const cudaError_t err = launch_combine(a, swt::make_modulus<N>(p, n0, one),
                                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// `scalars`: [16, lanes] int32 16-bit limbs of standard-form scalars, limb
// row i of lane j at scalars[i * row_stride + j * col_stride]; `table`:
// [8192, 36] int32, 16-byte aligned, row 256 w + d the words of X, Y and Z
// of d 2^(8w) G; `out`: a dense [3, 24, lanes] int32 array.  Launches on
// `stream` like the adds above.
int swt_g1_fixed_base(const int32_t* scalars, int64_t row_stride, int64_t col_stride,
                      const int32_t* table, int64_t lanes, int32_t* out, const uint32_t* p,
                      uint32_t n0, const uint32_t* one, void* stream) {
  if (lanes <= 0) return 0;
  FixedBaseArgs a;
  a.scalars.ptr = scalars;
  a.scalars.row_stride = row_stride;
  a.scalars.col_stride = col_stride;
  a.table = reinterpret_cast<const int4*>(table);
  a.lanes = lanes;
  a.out = out;
  g1_fixed_base_kernel<<<swt::grid_for(lanes, kFixedBaseThreads), kFixedBaseThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a, swt::make_modulus<N>(p, n0, one));
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread and local memory a thread (spills) of each kernel as
// compiled: out[0..1] for the add, out[2..3] for the accumulate, out[4..5]
// for the combine, out[6..7] for the fixed base.
int swt_g1_kernel_resources(int* out) {
  const void* kernels[] = {reinterpret_cast<const void*>(g1_fused_add_kernel),
                           reinterpret_cast<const void*>(g1_madd_accumulate_kernel),
                           reinterpret_cast<const void*>(g1_bucket_combine_kernel),
                           reinterpret_cast<const void*>(g1_fixed_base_kernel)};
  for (int k = 0; k < 4; ++k) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, kernels[k]);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[2 * k] = attr.numRegs;
    out[2 * k + 1] = static_cast<int>(attr.localSizeBytes);
  }
  return 0;
}

}  // extern "C"
