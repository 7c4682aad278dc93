// swtpu_native: host-side native kernels for simpleworks_tpu.
//
// The framework's compute path on TPU is JAX/XLA (see simpleworks_tpu/fields/
// device.py, poly/ntt_device.py); this library is the *host runtime*: fast
// Montgomery arithmetic, NTTs, and G1 MSMs for circuit synthesis, SRS
// generation and proof orchestration — the role arkworks' Rust core plays for
// the reference (SURVEY.md §2.3).  Exposed as a C ABI consumed via ctypes
// (simpleworks_tpu/native/__init__.py).
//
// Representation: little-endian u64 limbs; field elements in Montgomery form
// (R = 2^(64·n)); generic over limb count n ≤ 6 (Fr: 4, Fq: 6).

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <thread>
#include <vector>

// Simple fork-join over [0, n): deterministic partitioning, no pool state.
// Thread count from SWTPU_THREADS (default: hardware concurrency, max 8).
static int worker_count() {
    static int n = [] {
        if (const char* env = std::getenv("SWTPU_THREADS")) {
            int v = std::atoi(env);
            if (v >= 1) return v;
        }
        unsigned hc = std::thread::hardware_concurrency();
        return (int)(hc == 0 ? 1 : (hc > 8 ? 8 : hc));
    }();
    return n;
}

template <typename F>
static void parallel_for(size_t n, size_t grain, F&& body) {
    int workers = worker_count();
    if (workers <= 1 || n < 2 * grain) {
        body((size_t)0, n);
        return;
    }
    size_t chunks = (n + grain - 1) / grain;
    if ((size_t)workers > chunks) workers = (int)chunks;
    std::vector<std::thread> ts;
    size_t per = n / workers, extra = n % workers, lo = 0;
    for (int w = 0; w < workers; ++w) {
        size_t hi = lo + per + (w < (int)extra ? 1 : 0);
        ts.emplace_back([&body, lo, hi] { body(lo, hi); });
        lo = hi;
    }
    for (auto& t : ts) t.join();
}

typedef unsigned __int128 u128;

struct FpCtx {
    int n;               // limb count
    uint64_t p[6];       // modulus
    uint64_t r2[6];      // R^2 mod p
    uint64_t inv;        // -p^{-1} mod 2^64
    uint64_t one[6];     // R mod p (1 in Montgomery form)
};

extern "C" {

// ---------------------------------------------------------------- field ----

static inline int fp_cmp(const FpCtx* c, const uint64_t* a, const uint64_t* b) {
    for (int i = c->n - 1; i >= 0; --i) {
        if (a[i] < b[i]) return -1;
        if (a[i] > b[i]) return 1;
    }
    return 0;
}

static inline void fp_sub_p(const FpCtx* c, uint64_t* a) {
    // a -= p (caller guarantees a >= p)
    unsigned char borrow = 0;
    for (int i = 0; i < c->n; ++i) {
        u128 d = (u128)a[i] - c->p[i] - borrow;
        a[i] = (uint64_t)d;
        borrow = (d >> 64) ? 1 : 0;
    }
}

static inline void fp_add(const FpCtx* c, const uint64_t* a, const uint64_t* b, uint64_t* out) {
    unsigned char carry = 0;
    for (int i = 0; i < c->n; ++i) {
        u128 s = (u128)a[i] + b[i] + carry;
        out[i] = (uint64_t)s;
        carry = (uint64_t)(s >> 64);
    }
    if (carry || fp_cmp(c, out, c->p) >= 0) fp_sub_p(c, out);
}

static inline void fp_sub(const FpCtx* c, const uint64_t* a, const uint64_t* b, uint64_t* out) {
    unsigned char borrow = 0;
    for (int i = 0; i < c->n; ++i) {
        u128 d = (u128)a[i] - b[i] - borrow;
        out[i] = (uint64_t)d;
        borrow = (d >> 64) ? 1 : 0;
    }
    if (borrow) {
        unsigned char carry = 0;
        for (int i = 0; i < c->n; ++i) {
            u128 s = (u128)out[i] + c->p[i] + carry;
            out[i] = (uint64_t)s;
            carry = (uint64_t)(s >> 64);
        }
    }
}

// CIOS Montgomery multiplication.
static inline void fp_mul(const FpCtx* c, const uint64_t* a, const uint64_t* b, uint64_t* out) {
    const int n = c->n;
    uint64_t t[8] = {0};  // n + 2 columns
    for (int i = 0; i < n; ++i) {
        // t += a[i] * b
        uint64_t carry = 0;
        for (int j = 0; j < n; ++j) {
            u128 s = (u128)a[i] * b[j] + t[j] + carry;
            t[j] = (uint64_t)s;
            carry = (uint64_t)(s >> 64);
        }
        u128 s = (u128)t[n] + carry;
        t[n] = (uint64_t)s;
        t[n + 1] = (uint64_t)(s >> 64);
        // m = t[0] * inv mod 2^64;  t += m * p;  t >>= 64
        uint64_t m = t[0] * c->inv;
        u128 acc = (u128)m * c->p[0] + t[0];
        carry = (uint64_t)(acc >> 64);
        for (int j = 1; j < n; ++j) {
            acc = (u128)m * c->p[j] + t[j] + carry;
            t[j - 1] = (uint64_t)acc;
            carry = (uint64_t)(acc >> 64);
        }
        acc = (u128)t[n] + carry;
        t[n - 1] = (uint64_t)acc;
        t[n] = t[n + 1] + (uint64_t)(acc >> 64);
        t[n + 1] = 0;
    }
    if (t[n] || fp_cmp(c, t, c->p) >= 0) fp_sub_p(c, t);
    std::memcpy(out, t, n * 8);
}

static inline void fp_copy(const FpCtx* c, const uint64_t* a, uint64_t* out) {
    std::memcpy(out, a, c->n * 8);
}

static inline void fp_set_zero(const FpCtx* c, uint64_t* out) {
    std::memset(out, 0, c->n * 8);
}

static inline bool fp_is_zero(const FpCtx* c, const uint64_t* a) {
    for (int i = 0; i < c->n; ++i) if (a[i]) return false;
    return true;
}

void swtpu_fp_mul_batch(const FpCtx* c, const uint64_t* a, const uint64_t* b,
                        uint64_t* out, size_t count) {
    parallel_for(count, 4096, [&](size_t lo, size_t hi) {
        for (size_t i = lo; i < hi; ++i)
            fp_mul(c, a + i * c->n, b + i * c->n, out + i * c->n);
    });
}

void swtpu_fp_add_batch(const FpCtx* c, const uint64_t* a, const uint64_t* b,
                        uint64_t* out, size_t count) {
    parallel_for(count, 16384, [&](size_t lo, size_t hi) {
        for (size_t i = lo; i < hi; ++i)
            fp_add(c, a + i * c->n, b + i * c->n, out + i * c->n);
    });
}

void swtpu_fp_sub_batch(const FpCtx* c, const uint64_t* a, const uint64_t* b,
                        uint64_t* out, size_t count) {
    parallel_for(count, 16384, [&](size_t lo, size_t hi) {
        for (size_t i = lo; i < hi; ++i)
            fp_sub(c, a + i * c->n, b + i * c->n, out + i * c->n);
    });
}

void swtpu_fp_to_mont(const FpCtx* c, const uint64_t* a, uint64_t* out, size_t count) {
    parallel_for(count, 4096, [&](size_t lo, size_t hi) {
        for (size_t i = lo; i < hi; ++i)
            fp_mul(c, a + i * c->n, c->r2, out + i * c->n);
    });
}

void swtpu_fp_from_mont(const FpCtx* c, const uint64_t* a, uint64_t* out, size_t count) {
    uint64_t one[6] = {1, 0, 0, 0, 0, 0};
    parallel_for(count, 4096, [&](size_t lo, size_t hi) {
        for (size_t i = lo; i < hi; ++i)
            fp_mul(c, a + i * c->n, one, out + i * c->n);
    });
}

static void fp_pow(const FpCtx* c, const uint64_t* base, const uint64_t* e, int e_limbs,
                   uint64_t* out) {
    uint64_t acc[6], b[6];
    fp_copy(c, c->one, acc);
    fp_copy(c, base, b);
    for (int limb = 0; limb < e_limbs; ++limb) {
        uint64_t bits = e[limb];
        for (int i = 0; i < 64; ++i) {
            if (bits & 1) fp_mul(c, acc, b, acc);
            fp_mul(c, b, b, b);
            bits >>= 1;
        }
    }
    fp_copy(c, acc, out);
}

// cumulative powers: out[i] = base^i (Montgomery), i in [0, count)
void swtpu_fp_powers(const FpCtx* c, const uint64_t* base_mont, uint64_t* out, size_t count) {
    if (!count) return;
    fp_copy(c, c->one, out);
    for (size_t i = 1; i < count; ++i)
        fp_mul(c, out + (i - 1) * c->n, base_mont, out + i * c->n);
}

// ------------------------------------------------------------------ NTT ----

// In-place iterative radix-2 NTT over Montgomery-form data (natural order
// in/out; bit-reversal inside). stage_twiddles: concatenated per-stage tables
// (sizes 1, 2, 4, ..., n/2), Montgomery form.
void swtpu_ntt(const FpCtx* c, uint64_t* data, size_t n, const uint64_t* stage_twiddles) {
    const int L = c->n;
    // bit reverse permutation
    size_t bits = 0;
    while (((size_t)1 << bits) < n) ++bits;
    for (size_t i = 0; i < n; ++i) {
        size_t j = 0;
        for (size_t b = 0; b < bits; ++b) j |= ((i >> b) & 1) << (bits - 1 - b);
        if (j > i) {
            for (int k = 0; k < L; ++k) {
                uint64_t tmp = data[i * L + k];
                data[i * L + k] = data[j * L + k];
                data[j * L + k] = tmp;
            }
        }
    }
    const uint64_t* tw = stage_twiddles;
    for (size_t len = 2; len <= n; len <<= 1) {
        size_t half = len >> 1;
        size_t blocks = n / len;
        // flatten (block, j) into one index space so both the many-small-
        // blocks stages and the few-large-blocks stages parallelize
        parallel_for(blocks * half, 8192, [&](size_t wlo, size_t whi) {
            for (size_t w = wlo; w < whi; ++w) {
                size_t start = (w / half) * len;
                size_t j = w % half;
                uint64_t* lo = data + (start + j) * L;
                uint64_t* hi = data + (start + j + half) * L;
                uint64_t t[6], u[6];
                fp_mul(c, hi, tw + j * L, t);
                fp_copy(c, lo, u);
                fp_add(c, u, t, lo);
                fp_sub(c, u, t, hi);
            }
        });
        tw += half * L;
    }
}

void swtpu_scale(const FpCtx* c, uint64_t* data, size_t n, const uint64_t* factor_mont) {
    for (size_t i = 0; i < n; ++i)
        fp_mul(c, data + i * c->n, factor_mont, data + i * c->n);
}

// ------------------------------------------------------------------- G1 ----

// Jacobian point over Fq (6 limbs per coordinate, Montgomery form).
struct G1 {
    uint64_t x[6], y[6], z[6];
};

static inline bool g1_is_identity(const FpCtx* c, const G1* p) {
    return fp_is_zero(c, p->z);
}

static void g1_set_identity(const FpCtx* c, G1* p) {
    fp_copy(c, c->one, p->x);
    fp_copy(c, c->one, p->y);
    fp_set_zero(c, p->z);
}

static void g1_double(const FpCtx* c, const G1* p, G1* out) {
    if (g1_is_identity(c, p) || fp_is_zero(c, p->y)) { g1_set_identity(c, out); return; }
    uint64_t A[6], B[6], C[6], D[6], E[6], F[6], t[6];
    fp_mul(c, p->x, p->x, A);
    fp_mul(c, p->y, p->y, B);
    fp_mul(c, B, B, C);
    fp_add(c, p->x, B, t);
    fp_mul(c, t, t, t);
    fp_sub(c, t, A, t);
    fp_sub(c, t, C, t);
    fp_add(c, t, t, D);            // D = 2((X+B)^2 - A - C)
    fp_add(c, A, A, E);
    fp_add(c, E, A, E);            // E = 3A
    fp_mul(c, E, E, F);
    G1 r;
    fp_sub(c, F, D, r.x);
    fp_sub(c, r.x, D, r.x);        // X3 = F - 2D
    uint64_t c8[6];
    fp_add(c, C, C, c8);
    fp_add(c, c8, c8, c8);
    fp_add(c, c8, c8, c8);         // 8C
    fp_sub(c, D, r.x, t);
    fp_mul(c, E, t, r.y);
    fp_sub(c, r.y, c8, r.y);
    fp_mul(c, p->y, p->z, t);
    fp_add(c, t, t, r.z);
    *out = r;
}

static void g1_add(const FpCtx* c, const G1* p, const G1* q, G1* out) {
    if (g1_is_identity(c, p)) { *out = *q; return; }
    if (g1_is_identity(c, q)) { *out = *p; return; }
    uint64_t z1z1[6], z2z2[6], u1[6], u2[6], s1[6], s2[6], h[6], rr[6], i[6], j[6], v[6], t[6];
    fp_mul(c, p->z, p->z, z1z1);
    fp_mul(c, q->z, q->z, z2z2);
    fp_mul(c, p->x, z2z2, u1);
    fp_mul(c, q->x, z1z1, u2);
    fp_mul(c, p->y, q->z, s1); fp_mul(c, s1, z2z2, s1);
    fp_mul(c, q->y, p->z, s2); fp_mul(c, s2, z1z1, s2);
    fp_sub(c, u2, u1, h);
    fp_sub(c, s2, s1, rr);
    if (fp_is_zero(c, h)) {
        if (fp_is_zero(c, rr)) { g1_double(c, p, out); return; }
        g1_set_identity(c, out);
        return;
    }
    fp_add(c, rr, rr, rr);                 // r = 2(S2 - S1)
    fp_add(c, h, h, t);
    fp_mul(c, t, t, i);                    // I = (2H)^2
    fp_mul(c, h, i, j);
    fp_mul(c, u1, i, v);
    G1 r;
    fp_mul(c, rr, rr, r.x);
    fp_sub(c, r.x, j, r.x);
    fp_sub(c, r.x, v, r.x);
    fp_sub(c, r.x, v, r.x);                // X3 = r^2 - J - 2V
    fp_sub(c, v, r.x, t);
    fp_mul(c, rr, t, r.y);
    uint64_t sj[6];
    fp_mul(c, s1, j, sj);
    fp_add(c, sj, sj, sj);
    fp_sub(c, r.y, sj, r.y);               // Y3 = r(V - X3) - 2 S1 J
    fp_add(c, p->z, q->z, t);
    fp_mul(c, t, t, t);
    fp_sub(c, t, z1z1, t);
    fp_sub(c, t, z2z2, t);
    fp_mul(c, t, h, r.z);                  // Z3 = ((Z1+Z2)^2 - Z1Z1 - Z2Z2) H
    *out = r;
}

void swtpu_g1_add_batch(const FpCtx* c, const G1* a, const G1* b, G1* out, size_t count) {
    for (size_t i = 0; i < count; ++i) g1_add(c, a + i, b + i, out + i);
}

// Pippenger MSM: points (Jacobian mont), scalars as 4x u64 (standard form).
void swtpu_g1_msm(const FpCtx* c, const G1* points, const uint64_t* scalars,
                  size_t count, int window_bits, G1* out) {
    const int scalar_bits = 256;
    const int num_windows = (scalar_bits + window_bits - 1) / window_bits;
    const size_t num_buckets = ((size_t)1 << window_bits) - 1;
    // windows are independent: accumulate them in parallel, then fold
    std::vector<G1> window_sums(num_windows);
    parallel_for((size_t)num_windows, 1, [&](size_t wlo, size_t whi) {
        std::vector<G1> buckets(num_buckets);
        std::vector<char> used(num_buckets);
        for (size_t w = wlo; w < whi; ++w) {
            std::fill(used.begin(), used.end(), 0);
            int bit_off = (int)w * window_bits;
            for (size_t i = 0; i < count; ++i) {
                // extract window digit from 4x64-bit scalar
                uint64_t digit = 0;
                for (int b = 0; b < window_bits; ++b) {
                    int bit = bit_off + b;
                    if (bit >= 256) break;
                    uint64_t v = (scalars[i * 4 + bit / 64] >> (bit % 64)) & 1;
                    digit |= v << b;
                }
                if (!digit) continue;
                size_t idx = digit - 1;
                if (!used[idx]) { buckets[idx] = points[i]; used[idx] = 1; }
                else g1_add(c, &buckets[idx], &points[i], &buckets[idx]);
            }
            G1 running, acc;
            g1_set_identity(c, &running);
            g1_set_identity(c, &acc);
            for (size_t b = num_buckets; b-- > 0;) {
                if (used[b]) g1_add(c, &running, &buckets[b], &running);
                g1_add(c, &acc, &running, &acc);
            }
            window_sums[w] = acc;
        }
    });
    G1 total;
    g1_set_identity(c, &total);
    for (int w = num_windows - 1; w >= 0; --w) {
        for (int d = 0; d < window_bits; ++d) g1_double(c, &total, &total);
        g1_add(c, &total, &window_sums[w], &total);
    }
    *out = total;
}

// Jacobian + affine mixed addition (madd-2007-bl; Z2 = 1).  The affine
// operand must not be the identity (callers check).
static void g1_madd(const FpCtx* c, const G1* p, const uint64_t* x2,
                    const uint64_t* y2, G1* out) {
    if (g1_is_identity(c, p)) {
        fp_copy(c, x2, out->x);
        fp_copy(c, y2, out->y);
        fp_copy(c, c->one, out->z);
        return;
    }
    uint64_t z1z1[6], u2[6], s2[6], h[6], hh[6], i[6], j[6], rr[6], v[6], t[6];
    fp_mul(c, p->z, p->z, z1z1);
    fp_mul(c, x2, z1z1, u2);
    fp_mul(c, y2, p->z, s2);
    fp_mul(c, s2, z1z1, s2);
    fp_sub(c, u2, p->x, h);
    fp_sub(c, s2, p->y, rr);               // S2 - Y1
    if (fp_is_zero(c, h)) {
        if (fp_is_zero(c, rr)) { g1_double(c, p, out); return; }
        g1_set_identity(c, out);
        return;
    }
    fp_mul(c, h, h, hh);
    fp_add(c, hh, hh, i);
    fp_add(c, i, i, i);                    // I = 4 HH
    fp_mul(c, h, i, j);
    fp_add(c, rr, rr, rr);                 // r = 2 (S2 - Y1)
    fp_mul(c, p->x, i, v);
    G1 r;
    fp_mul(c, rr, rr, r.x);
    fp_sub(c, r.x, j, r.x);
    fp_sub(c, r.x, v, r.x);
    fp_sub(c, r.x, v, r.x);                // X3 = r^2 - J - 2V
    fp_sub(c, v, r.x, t);
    fp_mul(c, rr, t, r.y);
    uint64_t yj[6];
    fp_mul(c, p->y, j, yj);
    fp_add(c, yj, yj, yj);
    fp_sub(c, r.y, yj, r.y);               // Y3 = r (V - X3) - 2 Y1 J
    fp_add(c, p->z, h, t);
    fp_mul(c, t, t, t);
    fp_sub(c, t, z1z1, t);
    fp_sub(c, t, hh, r.z);                 // Z3 = (Z1 + H)^2 - Z1Z1 - HH
    *out = r;
}

static void fq_minus_2(const FpCtx* c, uint64_t* out) {
    unsigned char borrow = 0;
    uint64_t two[6] = {2, 0, 0, 0, 0, 0};
    for (int i = 0; i < c->n; ++i) {
        u128 d = (u128)c->p[i] - two[i] - borrow;
        out[i] = (uint64_t)d;
        borrow = (d >> 64) ? 1 : 0;
    }
}

// Batch-normalize Jacobian points [N, 18] to affine in place: Z becomes 1
// (Montgomery one); the identity maps to x = y = 0, z = 0.  One Montgomery
// batched inversion per chunk.
void swtpu_g1_normalize(const FpCtx* c, uint64_t* jac, size_t count) {
    const int n = c->n;
    uint64_t pm2[6];
    fq_minus_2(c, pm2);
    parallel_for(count, 8192, [&](size_t lo, size_t hi) {
        size_t m = hi - lo;
        std::vector<uint64_t> pref((m + 1) * n);
        std::vector<uint32_t> live;
        live.reserve(m);
        fp_copy(c, c->one, pref.data());
        for (size_t i = lo; i < hi; ++i) {
            uint64_t* z = jac + i * 18 + 12;
            if (fp_is_zero(c, z)) continue;
            fp_mul(c, pref.data() + live.size() * n, z,
                   pref.data() + (live.size() + 1) * n);
            live.push_back((uint32_t)i);
        }
        uint64_t inv_all[6], zinv[6], zi2[6], zi3[6];
        fp_pow(c, pref.data() + live.size() * n, pm2, n, inv_all);
        for (size_t k = live.size(); k-- > 0;) {
            size_t i = live[k];
            uint64_t* pt = jac + i * 18;
            fp_mul(c, pref.data() + k * n, inv_all, zinv);
            fp_mul(c, inv_all, pt + 12, inv_all);
            fp_mul(c, zinv, zinv, zi2);
            fp_mul(c, zi2, zinv, zi3);
            fp_mul(c, pt, zi2, pt);
            fp_mul(c, pt + 6, zi3, pt + 6);
            fp_copy(c, c->one, pt + 12);
        }
        for (size_t i = lo; i < hi; ++i) {
            uint64_t* pt = jac + i * 18;
            if (fp_is_zero(c, pt + 12)) {
                fp_set_zero(c, pt);
                fp_set_zero(c, pt + 6);
            }
        }
    });
}

// Batch-affine Pippenger MSM over normalized points (Jacobian layout
// [N, 18] with Z == 1; identity rows have x = y = 0 and are skipped).
// Bucket accumulation runs entirely in affine coordinates: points are
// counting-sorted by window digit, then added bucket-wise in rounds — each
// round performs one independent affine addition per active bucket with a
// single Montgomery batched inversion across all of them (~6 field muls
// per point add vs ~16 for the Jacobian-add accumulator in swtpu_g1_msm).
// Bucket combine uses mixed adds.  Identical group output to swtpu_g1_msm.
void swtpu_g1_msm_affine(const FpCtx* c, const uint64_t* pts /*[N,18], Z==1*/,
                         const uint64_t* scalars /*[N,4] standard form*/,
                         size_t count, int window_bits, G1* out) {
    const int n = c->n;
    const int scalar_bits = 256;
    const int num_windows = (scalar_bits + window_bits - 1) / window_bits;
    const size_t nb = ((size_t)1 << window_bits) - 1;  // digit d -> bucket d-1
    uint64_t pm2[6];
    fq_minus_2(c, pm2);
    std::vector<G1> window_sums(num_windows);
    parallel_for((size_t)num_windows, 1, [&](size_t wlo, size_t whi) {
        std::vector<uint16_t> dig(count);
        std::vector<uint32_t> cnt(nb), off(nb), cursor(nb), order(count);
        std::vector<uint64_t> bx(nb * n), by(nb * n);
        std::vector<uint8_t> has(nb);
        std::vector<uint32_t> active, pend_b, pend_i;
        std::vector<uint64_t> den(nb * n), pref((nb + 1) * n), inv(nb * n);
        active.reserve(nb);
        pend_b.reserve(nb);
        pend_i.reserve(nb);
        for (size_t w = wlo; w < whi; ++w) {
            int bit_off = (int)w * window_bits;
            std::fill(cnt.begin(), cnt.end(), 0);
            for (size_t i = 0; i < count; ++i) {
                uint64_t digit = 0;
                for (int b = 0; b < window_bits; ++b) {
                    int bit = bit_off + b;
                    if (bit >= scalar_bits) break;
                    digit |= ((scalars[i * 4 + bit / 64] >> (bit % 64)) & 1) << b;
                }
                // identity inputs contribute nothing — drop them here
                if (digit && (!fp_is_zero(c, pts + i * 18) ||
                              !fp_is_zero(c, pts + i * 18 + 6)))
                    dig[i] = (uint16_t)digit;
                else
                    dig[i] = 0;
                if (dig[i]) cnt[dig[i] - 1]++;
            }
            uint32_t acc32 = 0;
            for (size_t b = 0; b < nb; ++b) { off[b] = acc32; acc32 += cnt[b]; }
            std::memcpy(cursor.data(), off.data(), nb * 4);
            for (size_t i = 0; i < count; ++i)
                if (dig[i]) order[cursor[dig[i] - 1]++] = (uint32_t)i;
            std::fill(has.begin(), has.end(), 0);
            active.clear();
            for (size_t b = 0; b < nb; ++b)
                if (cnt[b]) active.push_back((uint32_t)b);
            for (uint32_t r = 0; !active.empty(); ++r) {
                pend_b.clear();
                pend_i.clear();
                size_t keep = 0;
                for (size_t a = 0; a < active.size(); ++a) {
                    uint32_t b = active[a];
                    uint32_t i = order[off[b] + r];
                    const uint64_t* px = pts + (size_t)i * 18;
                    const uint64_t* py = px + 6;
                    if (!has[b]) {
                        fp_copy(c, px, bx.data() + (size_t)b * n);
                        fp_copy(c, py, by.data() + (size_t)b * n);
                        has[b] = 1;
                    } else {
                        uint64_t* x1 = bx.data() + (size_t)b * n;
                        uint64_t* y1 = by.data() + (size_t)b * n;
                        uint64_t d[6];
                        fp_sub(c, px, x1, d);
                        if (fp_is_zero(c, d)) {
                            fp_sub(c, py, y1, d);
                            if (fp_is_zero(c, d)) {
                                // doubling: den = 2 y1 (y1 != 0 off the
                                // 2-torsion, which the subgroup excludes)
                                size_t k = pend_b.size();
                                fp_add(c, y1, y1, den.data() + k * n);
                                pend_b.push_back(b);
                                pend_i.push_back(i);
                            } else {
                                has[b] = 0;  // P + (-P): bucket to identity
                            }
                        } else {
                            size_t k = pend_b.size();
                            fp_copy(c, d, den.data() + k * n);
                            pend_b.push_back(b);
                            pend_i.push_back(i);
                        }
                    }
                    if (cnt[b] > r + 1) active[keep++] = b;
                }
                active.resize(keep);
                size_t np = pend_b.size();
                if (!np) continue;
                // Montgomery batched inversion of all denominators
                fp_copy(c, c->one, pref.data());
                for (size_t k = 0; k < np; ++k)
                    fp_mul(c, pref.data() + k * n, den.data() + k * n,
                           pref.data() + (k + 1) * n);
                uint64_t inv_all[6];
                fp_pow(c, pref.data() + np * n, pm2, n, inv_all);
                for (size_t k = np; k-- > 0;) {
                    fp_mul(c, pref.data() + k * n, inv_all, inv.data() + k * n);
                    fp_mul(c, inv_all, den.data() + k * n, inv_all);
                }
                // apply: λ = num·den⁻¹; x3 = λ² − x1 − x2; y3 = λ(x1−x3) − y1
                for (size_t k = 0; k < np; ++k) {
                    uint32_t b = pend_b[k];
                    const uint64_t* px = pts + (size_t)pend_i[k] * 18;
                    const uint64_t* py = px + 6;
                    uint64_t* x1 = bx.data() + (size_t)b * n;
                    uint64_t* y1 = by.data() + (size_t)b * n;
                    uint64_t num[6], lam[6], x3[6], t[6];
                    uint64_t d0[6];
                    fp_sub(c, px, x1, d0);
                    if (fp_is_zero(c, d0)) {
                        // doubling: num = 3 x1²
                        fp_mul(c, x1, x1, num);
                        fp_add(c, num, num, t);
                        fp_add(c, t, num, num);
                    } else {
                        fp_sub(c, py, y1, num);
                    }
                    fp_mul(c, num, inv.data() + k * n, lam);
                    fp_mul(c, lam, lam, x3);
                    fp_sub(c, x3, x1, x3);
                    fp_sub(c, x3, px, x3);
                    fp_sub(c, x1, x3, t);
                    fp_mul(c, lam, t, t);
                    fp_sub(c, t, y1, y1);
                    fp_copy(c, x3, x1);
                }
            }
            // bucket combine (descending running sum, mixed adds)
            G1 running, accp;
            g1_set_identity(c, &running);
            g1_set_identity(c, &accp);
            for (size_t b = nb; b-- > 0;) {
                if (has[b])
                    g1_madd(c, &running, bx.data() + b * n, by.data() + b * n,
                            &running);
                g1_add(c, &accp, &running, &accp);
            }
            window_sums[w] = accp;
        }
    });
    G1 total;
    g1_set_identity(c, &total);
    for (int w = num_windows - 1; w >= 0; --w) {
        for (int d = 0; d < window_bits; ++d) g1_double(c, &total, &total);
        g1_add(c, &total, &window_sums[w], &total);
    }
    *out = total;
}

// Fixed-base MSM: out[i] = scalars[i] * base, using an 8-bit window table.
void swtpu_g1_fixed_base(const FpCtx* c, const G1* base, const uint64_t* scalars,
                         size_t count, G1* out) {
    const int wbits = 8;
    const int num_windows = 32;  // 256 / 8
    const size_t tsize = 255;
    std::vector<G1> table(num_windows * tsize);
    G1 cur = *base;
    for (int w = 0; w < num_windows; ++w) {
        G1 acc = cur;
        for (size_t k = 0; k < tsize; ++k) {
            table[w * tsize + k] = acc;        // (k+1)·cur
            g1_add(c, &acc, &cur, &acc);
        }
        cur = acc;  // acc ended at 256·cur — the next window's base
    }
    parallel_for(count, 256, [&](size_t lo, size_t hi) {
        for (size_t i = lo; i < hi; ++i) {
            G1 acc;
            g1_set_identity(c, &acc);
            for (int w = 0; w < num_windows; ++w) {
                uint64_t digit = (scalars[i * 4 + (w * 8) / 64] >> ((w * 8) % 64)) & 0xFF;
                if (digit) g1_add(c, &acc, &table[w * tsize + digit - 1], &acc);
            }
            out[i] = acc;
        }
    });
}

}  // extern "C"

// ---------------------------------------------------------------- extras ----

extern "C" {

// acc += scalar * poly  (all Montgomery form), elementwise over count limbs-vectors
void swtpu_fp_axpy(const FpCtx* c, uint64_t* acc, const uint64_t* poly,
                   const uint64_t* scalar_mont, size_t count) {
    parallel_for(count, 8192, [&](size_t lo, size_t hi) {
        uint64_t tmp[6];
        for (size_t i = lo; i < hi; ++i) {
            fp_mul(c, poly + i * c->n, scalar_mont, tmp);
            fp_add(c, acc + i * c->n, tmp, acc + i * c->n);
        }
    });
}

// Horner evaluation: out = sum coeffs[i] * z^i  (Montgomery form in/out)
void swtpu_fp_horner(const FpCtx* c, const uint64_t* coeffs, size_t count,
                     const uint64_t* z_mont, uint64_t* out) {
    uint64_t acc[6];
    fp_set_zero(c, acc);
    for (size_t i = count; i-- > 0;) {
        fp_mul(c, acc, z_mont, acc);
        fp_add(c, acc, coeffs + i * c->n, acc);
    }
    std::memcpy(out, acc, c->n * 8);
}

// ---------------------------------------------------- FrVec batch kernels ----
// The vectorized host ops backing simpleworks_tpu.fields.frvec (the prover's
// polynomial data plane; replaces per-element Python bigint loops).

// Montgomery batch inversion (Fermat exponent supplied by the caller as p-2
// limbs).  Zeros map to zero, as in arkworks' batch_inversion.
void swtpu_fp_inv_batch(const FpCtx* c, const uint64_t* a, const uint64_t* p_minus_2,
                        uint64_t* out, size_t count) {
    const int n = c->n;
    std::vector<uint64_t> prefix((count + 1) * n);
    fp_copy(c, c->one, prefix.data());
    size_t live = 0;  // number of nonzero entries folded so far
    std::vector<size_t> live_idx;
    live_idx.reserve(count);
    for (size_t i = 0; i < count; ++i) {
        const uint64_t* ai = a + i * n;
        if (fp_is_zero(c, ai)) continue;
        fp_mul(c, prefix.data() + live * n, ai, prefix.data() + (live + 1) * n);
        live_idx.push_back(i);
        ++live;
    }
    uint64_t inv_all[6];
    fp_pow(c, prefix.data() + live * n, p_minus_2, n, inv_all);
    std::memset(out, 0, count * n * 8);
    for (size_t k = live; k-- > 0;) {
        size_t i = live_idx[k];
        fp_mul(c, prefix.data() + k * n, inv_all, out + i * n);
        fp_mul(c, inv_all, a + i * n, inv_all);
    }
}

// Sparse accumulate: out[rows[i]] += coeffs[i] * x[cols[i]] (all Montgomery).
// One kernel covers both AHP scatter shapes — z_M = M·z (rows=constraint
// rows, x=z) and t-evals (rows=matrix cols, x=u_alpha row weights).
void swtpu_fp_spmv(const FpCtx* c, size_t n_terms, const uint32_t* rows,
                   const uint32_t* cols, const uint64_t* coeffs,
                   const uint64_t* x, uint64_t* out) {
    const int n = c->n;
    uint64_t tmp[6];
    for (size_t i = 0; i < n_terms; ++i) {
        fp_mul(c, coeffs + i * n, x + (size_t)cols[i] * n, tmp);
        uint64_t* o = out + (size_t)rows[i] * n;
        fp_add(c, o, tmp, o);
    }
}

// out[i] = scalar - a[i]  (Montgomery form) — the (α − h^i) builder.
void swtpu_fp_scalar_sub_vec(const FpCtx* c, const uint64_t* scalar,
                             const uint64_t* a, uint64_t* out, size_t count) {
    parallel_for(count, 16384, [&](size_t lo, size_t hi) {
        for (size_t i = lo; i < hi; ++i)
            fp_sub(c, scalar, a + i * c->n, out + i * c->n);
    });
}

// Synthetic division by (X − z): quotient[count-2..0], remainder (Montgomery).
// The KZG opening-witness computation.
void swtpu_fp_div_linear(const FpCtx* c, const uint64_t* coeffs, size_t count,
                         const uint64_t* z_mont, uint64_t* quotient, uint64_t* rem) {
    const int n = c->n;
    uint64_t acc[6];
    fp_set_zero(c, acc);
    for (size_t i = count; i-- > 1;) {
        fp_mul(c, acc, z_mont, acc);
        fp_add(c, acc, coeffs + i * n, acc);
        std::memcpy(quotient + (i - 1) * n, acc, n * 8);
    }
    fp_mul(c, acc, z_mont, acc);
    fp_add(c, acc, coeffs, acc);
    std::memcpy(rem, acc, n * 8);
}

// out[i] = a[i] * b[i] + d[i]  (fused elementwise multiply-add, Montgomery).
void swtpu_fp_mul_add_batch(const FpCtx* c, const uint64_t* a, const uint64_t* b,
                            const uint64_t* d, uint64_t* out, size_t count) {
    parallel_for(count, 8192, [&](size_t lo, size_t hi) {
        uint64_t tmp[6];
        for (size_t i = lo; i < hi; ++i) {
            fp_mul(c, a + i * c->n, b + i * c->n, tmp);
            fp_add(c, tmp, d + i * c->n, out + i * c->n);
        }
    });
}

}  // extern "C"
