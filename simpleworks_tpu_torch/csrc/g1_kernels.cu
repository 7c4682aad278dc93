// Fused complete BLS12-377 G1 point adds on Hopper (sm_90a).
//
// Replaces the two Pallas kernels of simpleworks_tpu/ops/g1_fused_pallas.py:
//   swt_g1_fused_add   <- _fused_add_kernel, built by make_fused_add
//   swt_g1_fused_madd  <- _fused_madd_kernel (math in _madd_math), built by
//                         make_fused_madd
//
// A point is three (Jacobian X, Y, Z) or two (affine x, y) coordinate planes,
// each a limb-major [24, B] int32 Fq vector of 16-bit Montgomery limbs with
// its own row and column stride (field_arith.cuh).  Z = 0 encodes the
// Jacobian identity, x = y = 0 the affine one.  The result is written to one
// dense [3, 24, B] array: X, then Y, then Z.
//
// One thread per lane.  A thread loads its lane of every input plane, packs
// the limbs into 12 32-bit words, runs the whole complete formula in
// registers (the general add, the doubling where the lane needs it, and the
// identity cascade) and stores its three output coordinates; the ragged edge
// is masked, so there is no tile padding.  The field arithmetic is that of
// the field kernels (CIOS Montgomery multiply, modular add and subtract), so
// every intermediate equals the composed path's, and the selection order is
// the reference kernels' exactly: the outputs are Jacobian coordinates, and
// an equivalent but different (X, Y, Z) would be wrong.
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
// What bounds them on the card: a lane moves 9 (add) or 8 (madd) planes of
// 96 B and does 16 or 11 multiplies of 288 32-bit multiply-adds, so by count
// both sit near the balance of the H100's memory and integer rates.  As
// built they run about ten times above that bound (PERF.md): ~10 live Fq
// values of 12 words take over 200 registers a thread, which leaves a few
// warps an SM to hide the latency of the dependent carry chains.  Spreading
// a lane over several threads is later work.

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

__global__ void g1_fused_madd_kernel(Views<5> in, int32_t* out, int64_t B, Mod M) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= B) return;
  Fe X1, Y1, Z1, X2, Y2;
  swt::load<N>(X1, in.v[0], j);
  swt::load<N>(Y1, in.v[1], j);
  swt::load<N>(Z1, in.v[2], j);
  swt::load<N>(X2, in.v[3], j);
  swt::load<N>(Y2, in.v[4], j);

  // general mixed addition (madd-2007-bl), in the operation order of
  // g1_limb.madd
  Fe Z1Z1, H, rr, HH, I, J, t, X3, Y3, Z3;
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
  store_point(out, B, j, X3, Y3, Z3);
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
// the order X1, Y1, Z1, X2, Y2[, Z2]; `out`: a dense [3, 24, B] int32 array;
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

int swt_g1_fused_madd(const int64_t* views, int32_t* out, int64_t B, const uint32_t* p,
                      uint32_t n0, const uint32_t* one, void* stream) {
  if (B <= 0) return 0;
  const unsigned grid = swt::grid_for(B, kThreads);
  g1_fused_madd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      unpack_views<5>(views), out, B, swt::make_modulus<N>(p, n0, one));
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread and local memory a thread (spills) of each kernel as
// compiled: out[0..1] for the add, out[2..3] for the mixed add.
int swt_g1_kernel_resources(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, g1_fused_add_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  err = cudaFuncGetAttributes(&attr, g1_fused_madd_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

}  // extern "C"
