// 8-way batched BN254 Montgomery multiplication with AVX-512 IFMA
// (radix-2^52, 5 limbs): vpmadd52luq/vpmadd52huq accumulate 52x52-bit
// products into 64-bit lanes, so one CIOS pass multiplies EIGHT
// independent field elements at ~3x the scalar ADX rate. Structure:
// limbs are stored SoA — __m512i L[5], lane k = element k's limb.
//
// The proof kernels batch naturally (sumcheck pairs, MSM bucket lanes),
// so the 8-way form slots under the streaming kernels of frvec.cpp.
// Conversion 4x64 <-> 5x52 is a cheap shift/mask shuffle done at the
// kernel boundary.
//
// Montgomery domain: mul8 reduces by 2^260 (five 52-bit limbs) while the
// scalar 4x64 engine reduces by 2^256, so each mul8 drifts the result by
// 2^-4. Values are kept as the PLAIN radix-52 split of the 4x64
// Montgomery residue (exact, < p — every carry/borrow bound holds), and
// callers compensate the drift by pre-scaling exactly ONE operand per
// multiply with the plain value 2^260 ("mont(16)" = 16 * 2^256 mod p for
// constants and small tables, or 2^264 mod p applied vectorially) —
// see the kernel call sites in frvec.cpp / msm.cpp.

#pragma once
#if defined(__AVX512IFMA__) && defined(__AVX512VL__)
#define MONT52_AVAILABLE 1

#include <immintrin.h>
#include <cstdint>

namespace mont52 {

typedef uint64_t u64;
typedef unsigned __int128 u128;

static const u64 MASK52 = (1ULL << 52) - 1;

// BN254 base/scalar modulus limbs are supplied by the includer via a
// constants struct (the same header serves Fr and Fq).
struct Ctx {
    u64 p52[5];     // modulus, radix-2^52
    u64 n0inv52;    // -p^{-1} mod 2^52
};

// ---- scalar reference helpers (for conversions and tests) ------------------

// 4x64 -> 5x52
static inline void split52(const u64 a[4], u64 o[5]) {
    o[0] = a[0] & MASK52;
    o[1] = ((a[0] >> 52) | (a[1] << 12)) & MASK52;
    o[2] = ((a[1] >> 40) | (a[2] << 24)) & MASK52;
    o[3] = ((a[2] >> 28) | (a[3] << 36)) & MASK52;
    o[4] = a[3] >> 16;
}

// 5x52 -> 4x64 (inputs fully reduced, limbs < 2^52)
static inline void join52(const u64 a[5], u64 o[4]) {
    o[0] = a[0] | (a[1] << 52);
    o[1] = (a[1] >> 12) | (a[2] << 40);
    o[2] = (a[2] >> 24) | (a[3] << 28);
    o[3] = (a[3] >> 36) | (a[4] << 16);
}

// ---- 8-way CIOS multiply ---------------------------------------------------
//
// In/out: SoA limbs A[5], B[5], O[5] of 8 lanes each; values < p, limbs
// < 2^52. Computes O = A*B*2^-260 mod p, O < 2p (lazy; caller reduces
// when needed). Accumulator growth: each t[j] receives at most
// 2 products (lo parts) + carry per outer round; after madd52 chains the
// lanes stay < 2^57 — far from 2^64.

struct V5 { __m512i l[5]; };

static inline V5 load5(const u64* const base[5], long idx) {
    V5 v;
    for (int j = 0; j < 5; j++)
        v.l[j] = _mm512_loadu_si512((const void*)(base[j] + idx));
    return v;
}

static inline void store5(u64* const base[5], long idx, const V5& v) {
    for (int j = 0; j < 5; j++)
        _mm512_storeu_si512((void*)(base[j] + idx), v.l[j]);
}

static inline V5 mul8(const Ctx& c, const V5& A, const V5& B) {
    const __m512i zero = _mm512_setzero_si512();
    const __m512i mask = _mm512_set1_epi64((long long)MASK52);
    const __m512i n0 = _mm512_set1_epi64((long long)c.n0inv52);
    __m512i P[5];
    for (int j = 0; j < 5; j++)
        P[j] = _mm512_set1_epi64((long long)c.p52[j]);

    __m512i t0 = zero, t1 = zero, t2 = zero, t3 = zero, t4 = zero,
            t5 = zero;
    for (int i = 0; i < 5; i++) {
        __m512i ai = A.l[i];
        // t += ai * B  (lo parts into t[j], hi parts into t[j+1])
        t0 = _mm512_madd52lo_epu64(t0, ai, B.l[0]);
        t1 = _mm512_madd52lo_epu64(t1, ai, B.l[1]);
        t2 = _mm512_madd52lo_epu64(t2, ai, B.l[2]);
        t3 = _mm512_madd52lo_epu64(t3, ai, B.l[3]);
        t4 = _mm512_madd52lo_epu64(t4, ai, B.l[4]);
        t1 = _mm512_madd52hi_epu64(t1, ai, B.l[0]);
        t2 = _mm512_madd52hi_epu64(t2, ai, B.l[1]);
        t3 = _mm512_madd52hi_epu64(t3, ai, B.l[2]);
        t4 = _mm512_madd52hi_epu64(t4, ai, B.l[3]);
        t5 = _mm512_madd52hi_epu64(t5, ai, B.l[4]);
        // m = (t0 * n0inv) mod 2^52  — t0 may exceed 52 bits (deferred
        // carries), but only its low 52 bits matter for m
        __m512i m = _mm512_and_si512(
            _mm512_madd52lo_epu64(zero, _mm512_and_si512(t0, mask), n0),
            mask);
        // t += m * p; then shift one limb down. After adding m*p the low
        // limb's low 52 bits are zero BY CONSTRUCTION only modulo carry:
        // t0_low52 + (m*p0)_low52 == 0 mod 2^52, so the outgoing carry is
        // (t0 + m*p0) >> 52.
        t0 = _mm512_madd52lo_epu64(t0, m, P[0]);
        __m512i carry = _mm512_srli_epi64(t0, 52);
        t0 = _mm512_add_epi64(_mm512_madd52lo_epu64(carry, m, P[1]), t1);
        t0 = _mm512_madd52hi_epu64(t0, m, P[0]);
        t1 = _mm512_add_epi64(_mm512_madd52lo_epu64(zero, m, P[2]), t2);
        t1 = _mm512_madd52hi_epu64(t1, m, P[1]);
        t2 = _mm512_add_epi64(_mm512_madd52lo_epu64(zero, m, P[3]), t3);
        t2 = _mm512_madd52hi_epu64(t2, m, P[2]);
        t3 = _mm512_add_epi64(_mm512_madd52lo_epu64(zero, m, P[4]), t4);
        t3 = _mm512_madd52hi_epu64(t3, m, P[3]);
        t4 = _mm512_madd52hi_epu64(zero, m, P[4]);
        t4 = _mm512_add_epi64(t4, t5);
        t5 = zero;
    }
    // carry-normalize to 52-bit limbs
    V5 o;
    __m512i carry = _mm512_srli_epi64(t0, 52);
    o.l[0] = _mm512_and_si512(t0, mask);
    t1 = _mm512_add_epi64(t1, carry);
    carry = _mm512_srli_epi64(t1, 52);
    o.l[1] = _mm512_and_si512(t1, mask);
    t2 = _mm512_add_epi64(t2, carry);
    carry = _mm512_srli_epi64(t2, 52);
    o.l[2] = _mm512_and_si512(t2, mask);
    t3 = _mm512_add_epi64(t3, carry);
    carry = _mm512_srli_epi64(t3, 52);
    o.l[3] = _mm512_and_si512(t3, mask);
    o.l[4] = _mm512_add_epi64(t4, carry);
    return o;
}

// conditional subtract p when o >= p (lane-wise), o < 2p in
static inline V5 reduce8(const Ctx& c, const V5& a) {
    const __m512i mask = _mm512_set1_epi64((long long)MASK52);
    __m512i borrow = _mm512_setzero_si512();
    V5 d;
    for (int j = 0; j < 5; j++) {
        __m512i pj = _mm512_set1_epi64((long long)c.p52[j]);
        __m512i cur = _mm512_sub_epi64(
            _mm512_add_epi64(a.l[j],
                             _mm512_set1_epi64(1LL << 52)),
            _mm512_add_epi64(pj, borrow));
        d.l[j] = _mm512_and_si512(cur, mask);
        // borrow = 1 - (cur >> 52)
        borrow = _mm512_sub_epi64(_mm512_set1_epi64(1),
                                  _mm512_srli_epi64(cur, 52));
    }
    // if borrow == 0 take d else keep a
    __mmask8 ge = _mm512_cmpeq_epi64_mask(borrow, _mm512_setzero_si512());
    V5 o;
    for (int j = 0; j < 5; j++)
        o.l[j] = _mm512_mask_blend_epi64(ge, a.l[j], d.l[j]);
    return o;
}

// ---- lazy arithmetic helpers ----------------------------------------------

// a + b with carry normalization (limbs stay < 2^52); value may reach 4p
static inline V5 add8(const V5& a, const V5& b) {
    const __m512i mask = _mm512_set1_epi64((long long)MASK52);
    V5 o;
    __m512i carry = _mm512_setzero_si512();
    for (int j = 0; j < 5; j++) {
        __m512i cur = _mm512_add_epi64(_mm512_add_epi64(a.l[j], b.l[j]),
                                       carry);
        o.l[j] = (j < 4) ? _mm512_and_si512(cur, mask) : cur;
        carry = _mm512_srli_epi64(cur, 52);
    }
    return o;
}

// a - b + 2p (valid for a < 2p, b < 2p; result < 4p). Two passes keep
// every limb expression under 2^53 so the carry/borrow chains are exact.
static inline V5 sub8(const Ctx& c, const V5& a, const V5& b) {
    const __m512i mask = _mm512_set1_epi64((long long)MASK52);
    // pass 1: t = a + 2p (carry chain)
    V5 t;
    __m512i carry = _mm512_setzero_si512();
    for (int j = 0; j < 5; j++) {
        u64 p2j = ((c.p52[j] << 1) | (j ? (c.p52[j - 1] >> 51) : 0))
                  & MASK52;
        __m512i cur = _mm512_add_epi64(
            _mm512_add_epi64(a.l[j], _mm512_set1_epi64((long long)p2j)),
            carry);
        t.l[j] = (j < 4) ? _mm512_and_si512(cur, mask) : cur;
        carry = _mm512_srli_epi64(cur, 52);
    }
    // pass 2: o = t - b (borrow chain; t >= b at value level)
    V5 o;
    __m512i borrow = _mm512_setzero_si512();
    for (int j = 0; j < 5; j++) {
        __m512i cur = _mm512_sub_epi64(
            _mm512_add_epi64(t.l[j], _mm512_set1_epi64(1LL << 52)),
            _mm512_add_epi64(b.l[j], borrow));
        o.l[j] = (j < 4) ? _mm512_and_si512(cur, mask)
                         : _mm512_sub_epi64(
                               cur, _mm512_set1_epi64(1LL << 52));
        borrow = _mm512_sub_epi64(_mm512_set1_epi64(1),
                                  _mm512_srli_epi64(cur, 52));
    }
    return o;
}

// full reduction from < 4p to < p: conditional subtract 2p, then p
static inline V5 cond_sub(const Ctx& c, const V5& a, int shift) {
    const __m512i mask = _mm512_set1_epi64((long long)MASK52);
    __m512i borrow = _mm512_setzero_si512();
    V5 d;
    for (int j = 0; j < 5; j++) {
        u64 pj = (c.p52[j] << shift) & MASK52;
        if (shift && j) pj |= c.p52[j - 1] >> (52 - shift);
        __m512i cur = _mm512_sub_epi64(
            _mm512_add_epi64(a.l[j], _mm512_set1_epi64(1LL << 52)),
            _mm512_add_epi64(_mm512_set1_epi64((long long)pj), borrow));
        d.l[j] = _mm512_and_si512(cur, mask);
        borrow = _mm512_sub_epi64(_mm512_set1_epi64(1),
                                  _mm512_srli_epi64(cur, 52));
    }
    __mmask8 ge = _mm512_cmpeq_epi64_mask(borrow, _mm512_setzero_si512());
    V5 o;
    for (int j = 0; j < 5; j++)
        o.l[j] = _mm512_mask_blend_epi64(ge, a.l[j], d.l[j]);
    return o;
}

static inline V5 reduce_full(const Ctx& c, const V5& a) {
    return cond_sub(c, cond_sub(c, a, 1), 0);
}

// ---- 4x64 Montgomery (R = 2^256) interop -----------------------------------
//
// Convention: 52-domain values are the PLAIN radix-52 split of the 4x64
// Montgomery residue x~ = x*2^256 mod p (exact, < p — every borrow-chain
// bound holds). mul8 divides by 2^260 instead of 2^256, so each multiply
// drifts by 2^-4; the caller compensates by pre-scaling exactly ONE
// operand per multiply with 2^4 (a scalar fr_mul by mont(16) on
// constants / small tables). Conversion out is then a plain reduce+join
// — no multiply at all.

struct Interop {
    Ctx ctx;
};

// load 8 consecutive 4x64 Montgomery elements (exact split, < p)
static inline V5 to52_8(const Interop& io, const u64* base) {
    (void)io;
    alignas(64) u64 cols[5][8];
    for (int k = 0; k < 8; k++) {
        u64 t[5];
        split52(base + 4 * k, t);
        for (int j = 0; j < 5; j++) cols[j][k] = t[j];
    }
    V5 v;
    for (int j = 0; j < 5; j++)
        v.l[j] = _mm512_load_si512((const void*)cols[j]);
    return v;
}

// store 8 lanes back as 4x64 Montgomery elements (input < 4p)
static inline void from52_8(const Interop& io, const V5& a, u64* base) {
    V5 o = reduce_full(io.ctx, a);
    alignas(64) u64 cols[5][8];
    for (int j = 0; j < 5; j++)
        _mm512_store_si512((void*)cols[j], o.l[j]);
    for (int k = 0; k < 8; k++) {
        u64 t[5];
        for (int j = 0; j < 5; j++) t[j] = cols[j][k];
        join52(t, base + 4 * k);
    }
}

}  // namespace mont52
#endif  // __AVX512IFMA__
