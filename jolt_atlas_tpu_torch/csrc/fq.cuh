// BN254 Montgomery arithmetic over its two primes, the base field Fq and the
// scalar field Fr, and the complete projective point add over Fq, as device
// functions shared by curve.cu, msm.cu, combine.cu, reduction.cu and
// rows.cu.
//
// Replaces the register-resident body of the Pallas kernel
// jolt_atlas_tpu/tpu/pallas_curve.py (_mont_mul, _cond_sub_p, _fadd, _fsub,
// _pp_add_body) and the Fr planes of jolt_atlas_tpu/tpu/fqplanes.py
// (PlanesCtx(FR_MODULUS), used by tpu/reduction.py). The TPU version worked
// on 16 planes of 16-bit limbs in 32-bit vector lanes because its VPU has no
// wide multiply. Hopper has no 64-bit integer multiplier either, but its
// 32-bit IMAD takes and gives a carry flag: here one thread holds a field
// element as 8 x u32 Montgomery limbs (R = 2^256, the same bytes as the
// host's 4 x u64 layout) and multiplies by 32-bit CIOS, each row of partial
// products one PTX carry chain (mad.lo.cc / madc.hi.cc / addc), with add,
// sub and the conditional subtract as add.cc / sub.cc chains. A Montgomery
// product is 8 rows of a * b_i and 8 of m * p: 264 32-bit multiplies. Every
// result is canonical (< p), so the outputs are the same numbers the
// reference produces.
//
// The modulus is a template parameter: a struct of p, -p^-1 mod 2^32 and
// R mod p (FqField, FrField). fq_* and fr_* are the two instances; the Fq
// ones compile to the code the Fq-only core gave (device/kernel_report.py
// compares the SASS).
//
// Tensor cores and TMA do not serve this work: it is 256-bit modular
// multiplies (IMAD throughput) and random gathers of bases.
#pragma once

#include <cstdint>

namespace jolt {

typedef unsigned long long u64;
typedef uint32_t u32;

// BN254 base field: p, -p^-1 mod 2^32, R mod p (little-endian 32-bit limbs)
struct FqField {
  __device__ __forceinline__ static u32 p(int i) {
    constexpr u32 P[8] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
                          0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return P[i];
  }
  static constexpr u32 N0 = 0xe4866389u;
  __device__ __forceinline__ static u32 one(int i) {
    constexpr u32 ONE[8] = {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du,
                            0x0a78eb28u, 0x7879462cu, 0x666ea36fu,
                            0x9a07df2fu, 0x0e0a77c1u};
    return ONE[i];
  }
};

// BN254 scalar field r, the same three constants
struct FrField {
  __device__ __forceinline__ static u32 p(int i) {
    constexpr u32 P[8] = {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
                          0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return P[i];
  }
  static constexpr u32 N0 = 0xefffffffu;
  __device__ __forceinline__ static u32 one(int i) {
    constexpr u32 ONE[8] = {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u,
                            0x36fc7695u, 0x7879462eu, 0x666ea36fu,
                            0x9a07df2fu, 0x0e0a77c1u};
    return ONE[i];
  }
};

__device__ __forceinline__ u32 fq_p(int i) { return FqField::p(i); }
__device__ __forceinline__ u32 fq_one(int i) { return FqField::one(i); }

// a field element (of either field): 8 x u32 Montgomery limbs
struct U256 {
  u32 v[8];
};
typedef U256 Fq;
typedef U256 Fr;

struct Point {  // homogeneous projective (X : Y : Z), identity (0 : 1 : 0)
  Fq x, y, z;
};

// t[0..9] += a[0..7] * b: the low halves of the partial products in one
// carry chain, the high halves (one limb up) in a second; t[9] takes both
// final carries.
__device__ __forceinline__ void mad_row(u32 t[10], const u32 a[8], u32 b) {
  asm("mad.lo.cc.u32  %0, %10, %18, %0;\n\t"
      "madc.lo.cc.u32 %1, %11, %18, %1;\n\t"
      "madc.lo.cc.u32 %2, %12, %18, %2;\n\t"
      "madc.lo.cc.u32 %3, %13, %18, %3;\n\t"
      "madc.lo.cc.u32 %4, %14, %18, %4;\n\t"
      "madc.lo.cc.u32 %5, %15, %18, %5;\n\t"
      "madc.lo.cc.u32 %6, %16, %18, %6;\n\t"
      "madc.lo.cc.u32 %7, %17, %18, %7;\n\t"
      "addc.cc.u32    %8, %8, 0;\n\t"
      "addc.u32       %9, %9, 0;\n\t"
      "mad.hi.cc.u32  %1, %10, %18, %1;\n\t"
      "madc.hi.cc.u32 %2, %11, %18, %2;\n\t"
      "madc.hi.cc.u32 %3, %12, %18, %3;\n\t"
      "madc.hi.cc.u32 %4, %13, %18, %4;\n\t"
      "madc.hi.cc.u32 %5, %14, %18, %5;\n\t"
      "madc.hi.cc.u32 %6, %15, %18, %6;\n\t"
      "madc.hi.cc.u32 %7, %16, %18, %7;\n\t"
      "madc.hi.cc.u32 %8, %17, %18, %8;\n\t"
      "addc.u32       %9, %9, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b));
}

// r + top * 2^256 lies in [0, 2p): subtract p once if it is >= p
template <class F>
__device__ __forceinline__ void mont_cond_sub(U256& r, u32 top) {
  u32 d[8], hi;
  asm("sub.cc.u32  %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32    %8, %25, 0;"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]),
        "=r"(d[5]), "=r"(d[6]), "=r"(d[7]), "=r"(hi)
      : "r"(r.v[0]), "r"(r.v[1]), "r"(r.v[2]), "r"(r.v[3]), "r"(r.v[4]),
        "r"(r.v[5]), "r"(r.v[6]), "r"(r.v[7]), "r"(F::p(0)), "r"(F::p(1)),
        "r"(F::p(2)), "r"(F::p(3)), "r"(F::p(4)), "r"(F::p(5)),
        "r"(F::p(6)), "r"(F::p(7)), "r"(top));
  // hi = top - borrow: all ones exactly when r + top * 2^256 < p
  const bool take = hi != 0xffffffffu;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = take ? d[j] : r.v[j];
}

// Montgomery product a*b/R mod p, CIOS over 32-bit words; a, b < p. The
// running sum stays below 2p after each of the 8 steps (p < 2^254), so
// t[8] <= 1 and t[9] = 0 after each shift.
template <class F>
__device__ __forceinline__ U256 mont_mul(const U256& a, const U256& b) {
  u32 t[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  u32 p[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) p[j] = F::p(j);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mad_row(t, a.v, b.v[i]);
    const u32 m = t[0] * F::N0;
    mad_row(t, p, m);  // t[0] becomes 0: shift down one word
#pragma unroll
    for (int j = 0; j < 9; ++j) t[j] = t[j + 1];
    t[9] = 0;
  }
  U256 r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = t[j];
  mont_cond_sub<F>(r, t[8]);
  return r;
}

// (a b + c d) / R mod p, canonical: one Montgomery reduction for the sum of
// two products. CIOS over the words of b and d at once: each of the 8
// steps is a row of a * b_i, one of c * d_i and one of m * p (49 IMAD; 392
// for the sum, where two products are 528). a and c may be p itself (a
// negated zero, mont_neg_raw); b, d < p. The running sum stays below
// t / 2^32 + 3p < 4p after each step (so t[9] = 0), and ends at (a b + c d
// + M p) / R < (2p / R + 1) p < 1.38 p: one conditional subtraction.
// Registers as mont_mul's, and a single 10-limb accumulator.
template <class F>
__device__ __forceinline__ U256 mont_mul_sum2(const U256& a, const U256& b,
                                              const U256& c, const U256& d) {
  u32 t[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  u32 p[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) p[j] = F::p(j);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mad_row(t, a.v, b.v[i]);
    mad_row(t, c.v, d.v[i]);
    const u32 m = t[0] * F::N0;
    mad_row(t, p, m);  // t[0] becomes 0: shift down one word
#pragma unroll
    for (int j = 0; j < 9; ++j) t[j] = t[j + 1];
    t[9] = 0;
  }
  U256 r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = t[j];
  mont_cond_sub<F>(r, t[8]);
  return r;
}

// p - a for a <= p, not reduced: a = 0 gives p (a factor mont_mul_sum2
// takes; for 0 < a < p, the canonical -a)
template <class F>
__device__ __forceinline__ U256 mont_neg_raw(const U256& a) {
  U256 r;
  asm("sub.cc.u32  %0, %8, %16;\n\t"
      "subc.cc.u32 %1, %9, %17;\n\t"
      "subc.cc.u32 %2, %10, %18;\n\t"
      "subc.cc.u32 %3, %11, %19;\n\t"
      "subc.cc.u32 %4, %12, %20;\n\t"
      "subc.cc.u32 %5, %13, %21;\n\t"
      "subc.cc.u32 %6, %14, %22;\n\t"
      "subc.u32    %7, %15, %23;"
      : "=r"(r.v[0]), "=r"(r.v[1]), "=r"(r.v[2]), "=r"(r.v[3]),
        "=r"(r.v[4]), "=r"(r.v[5]), "=r"(r.v[6]), "=r"(r.v[7])
      : "r"(F::p(0)), "r"(F::p(1)), "r"(F::p(2)), "r"(F::p(3)),
        "r"(F::p(4)), "r"(F::p(5)), "r"(F::p(6)), "r"(F::p(7)),
        "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]),
        "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]));
  return r;
}

// a + b < 2p < 2^255: no carry out of the top limb
template <class F>
__device__ __forceinline__ U256 mont_add(const U256& a, const U256& b) {
  U256 r = a;
  asm("add.cc.u32  %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32    %7, %7, %15;"
      : "+r"(r.v[0]), "+r"(r.v[1]), "+r"(r.v[2]), "+r"(r.v[3]),
        "+r"(r.v[4]), "+r"(r.v[5]), "+r"(r.v[6]), "+r"(r.v[7])
      : "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]), "r"(b.v[4]),
        "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]));
  mont_cond_sub<F>(r, 0);
  return r;
}

// a - b, plus p where it borrows (branch-free: p & the borrow mask)
template <class F>
__device__ __forceinline__ U256 mont_sub(const U256& a, const U256& b) {
  U256 r = a;
  u32 mask;
  const u32 zero = 0;
  asm("sub.cc.u32  %0, %0, %9;\n\t"
      "subc.cc.u32 %1, %1, %10;\n\t"
      "subc.cc.u32 %2, %2, %11;\n\t"
      "subc.cc.u32 %3, %3, %12;\n\t"
      "subc.cc.u32 %4, %4, %13;\n\t"
      "subc.cc.u32 %5, %5, %14;\n\t"
      "subc.cc.u32 %6, %6, %15;\n\t"
      "subc.cc.u32 %7, %7, %16;\n\t"
      "subc.u32    %8, %17, %17;"
      : "+r"(r.v[0]), "+r"(r.v[1]), "+r"(r.v[2]), "+r"(r.v[3]),
        "+r"(r.v[4]), "+r"(r.v[5]), "+r"(r.v[6]), "+r"(r.v[7]), "=r"(mask)
      : "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]), "r"(b.v[4]),
        "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]), "r"(zero));
  // the carry out cancels the borrow
  asm("add.cc.u32  %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32    %7, %7, %15;"
      : "+r"(r.v[0]), "+r"(r.v[1]), "+r"(r.v[2]), "+r"(r.v[3]),
        "+r"(r.v[4]), "+r"(r.v[5]), "+r"(r.v[6]), "+r"(r.v[7])
      : "r"(F::p(0) & mask), "r"(F::p(1) & mask), "r"(F::p(2) & mask),
        "r"(F::p(3) & mask), "r"(F::p(4) & mask), "r"(F::p(5) & mask),
        "r"(F::p(6) & mask), "r"(F::p(7) & mask));
  return r;
}

// ---------------------------------------------------------------------------
// Lazy sums of products (kernel 5): sum_k a_k b_k with one reduction for the
// whole sum, not one a product. Each a_k b_k is a plain 256 x 256 -> 512-bit
// product (8 mad_row rows, 128 IMAD) added into a 16-limb accumulator T;
// one Montgomery reduction (8 steps of m = t[i] N0, t += m p: 136 IMAD) then
// gives T / R mod p. Bounds, for canonical inputs (< p < 2^254, p / R =
// 0.189): n products sum below n p^2, under 2^512 (16 limbs) for n <= 27.
// The reduction returns u + H with u = (L + M p) / R <= p (L the low half
// of T, M < R) and H = floor(T / R) < 0.189 n p, so below (1 + 0.189 n) p;
// that must fit 256 bits, so n <= 22, the most terms a sum may take before
// it is reduced. Two conditional subtractions (2p, then p) make any value
// below 4p canonical: n <= 15; n = 16 to 22 take a third (4p) first.
// ---------------------------------------------------------------------------

struct U512 {
  u32 v[16];
};

__device__ __forceinline__ U512 wide_zero() {
  U512 r;
#pragma unroll
  for (int j = 0; j < 16; ++j) r.v[j] = 0;
  return r;
}

// acc += a * b (the full 512-bit product); the caller keeps acc < 2^512
__device__ __forceinline__ void wide_mad(U512& acc, const U256& a,
                                         const U256& b) {
  u32 t[17];
#pragma unroll
  for (int j = 0; j < 17; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) mad_row(t + i, a.v, b.v[i]);  // t < 2^512
  u32 c;
  asm("add.cc.u32  %0, %0, %9;\n\t"
      "addc.cc.u32 %1, %1, %10;\n\t"
      "addc.cc.u32 %2, %2, %11;\n\t"
      "addc.cc.u32 %3, %3, %12;\n\t"
      "addc.cc.u32 %4, %4, %13;\n\t"
      "addc.cc.u32 %5, %5, %14;\n\t"
      "addc.cc.u32 %6, %6, %15;\n\t"
      "addc.cc.u32 %7, %7, %16;\n\t"
      "addc.u32    %8, 0, 0;"
      : "+r"(acc.v[0]), "+r"(acc.v[1]), "+r"(acc.v[2]), "+r"(acc.v[3]),
        "+r"(acc.v[4]), "+r"(acc.v[5]), "+r"(acc.v[6]), "+r"(acc.v[7]),
        "=r"(c)
      : "r"(t[0]), "r"(t[1]), "r"(t[2]), "r"(t[3]), "r"(t[4]), "r"(t[5]),
        "r"(t[6]), "r"(t[7]));
  // c + 0xffffffff sets the carry flag exactly when c = 1
  asm("add.cc.u32  %8, %8, 0xffffffff;\n\t"
      "addc.cc.u32 %0, %0, %9;\n\t"
      "addc.cc.u32 %1, %1, %10;\n\t"
      "addc.cc.u32 %2, %2, %11;\n\t"
      "addc.cc.u32 %3, %3, %12;\n\t"
      "addc.cc.u32 %4, %4, %13;\n\t"
      "addc.cc.u32 %5, %5, %14;\n\t"
      "addc.cc.u32 %6, %6, %15;\n\t"
      "addc.u32    %7, %7, %16;"
      : "+r"(acc.v[8]), "+r"(acc.v[9]), "+r"(acc.v[10]), "+r"(acc.v[11]),
        "+r"(acc.v[12]), "+r"(acc.v[13]), "+r"(acc.v[14]), "+r"(acc.v[15]),
        "+r"(c)
      : "r"(t[8]), "r"(t[9]), "r"(t[10]), "r"(t[11]), "r"(t[12]),
        "r"(t[13]), "r"(t[14]), "r"(t[15]));
}

// r -= (p << S) where r >= p << S (S = 1, 2: 2p, 4p; both below 2^256)
template <class F, int S>
__device__ __forceinline__ void mont_cond_sub_shifted(U256& r) {
  u32 m[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    m[j] = (F::p(j) << S) | (j ? F::p(j - 1) >> (32 - S) : 0u);
  u32 d[8], borrow;
  asm("sub.cc.u32  %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32    %8, 0, 0;"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]),
        "=r"(d[5]), "=r"(d[6]), "=r"(d[7]), "=r"(borrow)
      : "r"(r.v[0]), "r"(r.v[1]), "r"(r.v[2]), "r"(r.v[3]), "r"(r.v[4]),
        "r"(r.v[5]), "r"(r.v[6]), "r"(r.v[7]), "r"(m[0]), "r"(m[1]),
        "r"(m[2]), "r"(m[3]), "r"(m[4]), "r"(m[5]), "r"(m[6]), "r"(m[7]));
  const bool take = borrow == 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = take ? d[j] : r.v[j];
}

// T / R mod p, canonical, for T a sum of at most N products of canonical
// values (the bounds above)
template <class F, int N>
__device__ __forceinline__ U256 mont_redc_sum(const U512& T) {
  static_assert(N >= 1 && N <= 22, "a lazy sum takes at most 22 products");
  u32 t[10];
#pragma unroll
  for (int j = 0; j < 8; ++j) t[j] = T.v[j];
  t[8] = 0;
  t[9] = 0;
  u32 p[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) p[j] = F::p(j);
#pragma unroll
  for (int i = 0; i < 8; ++i) {  // as mont_mul's reduction rows
    const u32 m = t[0] * F::N0;
    mad_row(t, p, m);
#pragma unroll
    for (int j = 0; j < 9; ++j) t[j] = t[j + 1];
    t[9] = 0;
  }
  U256 r;  // u + H: below 2^256 by the bound on N
  asm("add.cc.u32  %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32    %7, %15, %23;"
      : "=r"(r.v[0]), "=r"(r.v[1]), "=r"(r.v[2]), "=r"(r.v[3]),
        "=r"(r.v[4]), "=r"(r.v[5]), "=r"(r.v[6]), "=r"(r.v[7])
      : "r"(t[0]), "r"(t[1]), "r"(t[2]), "r"(t[3]), "r"(t[4]), "r"(t[5]),
        "r"(t[6]), "r"(t[7]), "r"(T.v[8]), "r"(T.v[9]), "r"(T.v[10]),
        "r"(T.v[11]), "r"(T.v[12]), "r"(T.v[13]), "r"(T.v[14]),
        "r"(T.v[15]));
  if (N > 15) mont_cond_sub_shifted<F, 2>(r);
  mont_cond_sub_shifted<F, 1>(r);
  mont_cond_sub<F>(r, 0);
  return r;
}

__device__ __forceinline__ Fq fq_mul(const Fq& a, const Fq& b) {
  return mont_mul<FqField>(a, b);
}
__device__ __forceinline__ Fq fq_add(const Fq& a, const Fq& b) {
  return mont_add<FqField>(a, b);
}
__device__ __forceinline__ Fq fq_sub(const Fq& a, const Fq& b) {
  return mont_sub<FqField>(a, b);
}
__device__ __forceinline__ Fr fr_mul(const Fr& a, const Fr& b) {
  return mont_mul<FrField>(a, b);
}
__device__ __forceinline__ Fr fr_add(const Fr& a, const Fr& b) {
  return mont_add<FrField>(a, b);
}
__device__ __forceinline__ Fr fr_sub(const Fr& a, const Fr& b) {
  return mont_sub<FrField>(a, b);
}

__device__ __forceinline__ Point pp_identity() {
  Point r;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    r.x.v[j] = 0;
    r.y.v[j] = fq_one(j);
    r.z.v[j] = 0;
  }
  return r;
}

// RCB15 Algorithm 7 (a = 0, b3 = 3b = 9): complete addition, correct for
// doubling, inverses and the identity without branches. The same values as
// pallas_curve._pp_add_body, with its last six products taken as three
// sums of two (X3 = t3 t1 - t4 Y3, Y3 = Y3 t0 + t1 Z3, Z3 = Z3 t4 + t0 t3;
// the difference as t3 t1 + (p - t4) Y3), each reduced once
// (mont_mul_sum2), not two products and an add or a sub. Six Montgomery
// products (264 IMAD each) and three sums (392): 2,760 IMAD an add, not
// 3,168.
// Every result is canonical, so the outputs are the reference's numbers.
__device__ __forceinline__ Fq fq_mul_b3(const Fq& x) {  // 9x = 8x + x
  const Fq x2 = fq_add(x, x);
  const Fq x4 = fq_add(x2, x2);
  return fq_add(fq_add(x4, x4), x);
}

__device__ __forceinline__ Point pp_add_dev(const Point& P1,
                                            const Point& P2) {
  const Fq &X1 = P1.x, &Y1 = P1.y, &Z1 = P1.z;
  const Fq &X2 = P2.x, &Y2 = P2.y, &Z2 = P2.z;
  // the six independent products first
  Fq t0 = fq_mul(X1, X2);
  Fq t1 = fq_mul(Y1, Y2);
  const Fq t2 = fq_mul(Z1, Z2);
  Fq t3 = fq_mul(fq_add(X1, Y1), fq_add(X2, Y2));
  Fq t4 = fq_mul(fq_add(Y1, Z1), fq_add(Y2, Z2));
  Fq Y3 = fq_mul(fq_add(X1, Z1), fq_add(X2, Z2));
  t3 = fq_sub(t3, fq_add(t0, t1));  // X1Y2 + X2Y1
  t4 = fq_sub(t4, fq_add(t1, t2));  // Y1Z2 + Y2Z1
  Y3 = fq_sub(Y3, fq_add(t0, t2));  // X1Z2 + X2Z1
  t0 = fq_add(fq_add(t0, t0), t0);  // 3 X1X2
  const Fq b3t2 = fq_mul_b3(t2);    // b3 Z1Z2
  const Fq Z3 = fq_add(t1, b3t2);
  t1 = fq_sub(t1, b3t2);
  Y3 = fq_mul_b3(Y3);  // b3 (X1Z2 + X2Z1)
  Point r;
  r.x = mont_mul_sum2<FqField>(t3, t1, mont_neg_raw<FqField>(t4), Y3);
  r.y = mont_mul_sum2<FqField>(Y3, t0, t1, Z3);
  r.z = mont_mul_sum2<FqField>(Z3, t4, t0, t3);
  return r;
}

// An affine base (x, y), finite: the MSM's bases (kernel 2) are kept so,
// 64 bytes a base
struct Affine {
  Fq x, y;
};

// RCB15 Algorithm 8 (a = 0, b3 = 9): the complete mixed add P1 + P2 for any
// projective P1 (the identity and P1 = +-P2 included) and an affine, finite
// P2. It is Algorithm 7 at Z2 = 1, so its outputs are pp_add_dev's with P2 =
// (x2 : y2 : 1); the products by Z2 go, and Y1 Z2 + Y2 Z1 and X1 Z2 + X2 Z1
// become one product and an add each. Five Montgomery products and the
// three sums of pp_add_dev: 2,496 IMAD an add, not 2,760.
__device__ __forceinline__ Point pm_add_dev(const Point& P1,
                                            const Affine& P2) {
  const Fq &X1 = P1.x, &Y1 = P1.y, &Z1 = P1.z;
  const Fq &X2 = P2.x, &Y2 = P2.y;
  Fq t0 = fq_mul(X1, X2);
  Fq t1 = fq_mul(Y1, Y2);
  Fq t3 = fq_mul(fq_add(X1, Y1), fq_add(X2, Y2));
  const Fq t4 = fq_add(fq_mul(Y2, Z1), Y1);  // Y1 + Y2Z1
  Fq Y3 = fq_add(fq_mul(X2, Z1), X1);        // X1 + X2Z1
  t3 = fq_sub(t3, fq_add(t0, t1));           // X1Y2 + X2Y1
  t0 = fq_add(fq_add(t0, t0), t0);           // 3 X1X2
  const Fq b3z = fq_mul_b3(Z1);              // b3 Z1
  const Fq Z3 = fq_add(t1, b3z);
  t1 = fq_sub(t1, b3z);
  Y3 = fq_mul_b3(Y3);
  Point r;
  r.x = mont_mul_sum2<FqField>(t3, t1, mont_neg_raw<FqField>(t4), Y3);
  r.y = mont_mul_sum2<FqField>(Y3, t0, t1, Z3);
  r.z = mont_mul_sum2<FqField>(Z3, t4, t0, t3);
  return r;
}

// RCB15 Algorithm 9 (a = 0, b3 = 9): the complete doubling 2P, the identity
// included. Six Montgomery products and one sum of two (Y3 = 8 Y^2 b3 Z^2 +
// (Y^2 - 3 b3 Z^2)(Y^2 + b3 Z^2)): 1,976 IMAD, not an add's 2,760. Its
// outputs differ from pp_add_dev(P, P) as projective triples, not as points.
__device__ __forceinline__ Point pp_double_dev(const Point& P) {
  const Fq t0 = fq_mul(P.y, P.y);
  const Fq t1 = fq_mul(P.y, P.z);
  const Fq zz = fq_mul(P.z, P.z);
  const Fq xy = fq_mul(P.x, P.y);
  const Fq t0x2 = fq_add(t0, t0);
  const Fq t0x4 = fq_add(t0x2, t0x2);
  const Fq y8 = fq_add(t0x4, t0x4);      // 8 Y^2
  const Fq t2 = fq_mul_b3(zz);           // b3 Z^2
  const Fq s = fq_add(t0, t2);           // Y^2 + b3 Z^2
  const Fq d = fq_sub(t0, fq_add(fq_add(t2, t2), t2));  // Y^2 - 3 b3 Z^2
  Point r;
  r.z = fq_mul(t1, y8);
  r.y = mont_mul_sum2<FqField>(t2, y8, d, s);
  const Fq x = fq_mul(d, xy);
  r.x = fq_add(x, x);
  return r;
}

// (N, 4) u64 limbs in memory are the same bytes as (N, 8) u32: two 16-byte
// loads or stores an element (of either field)
__device__ __forceinline__ U256 load_fq(const u64* base, int64_t i) {
  const uint4* p = reinterpret_cast<const uint4*>(base + 4 * i);
  const uint4 lo = p[0], hi = p[1];
  U256 r;
  r.v[0] = lo.x;
  r.v[1] = lo.y;
  r.v[2] = lo.z;
  r.v[3] = lo.w;
  r.v[4] = hi.x;
  r.v[5] = hi.y;
  r.v[6] = hi.z;
  r.v[7] = hi.w;
  return r;
}

__device__ __forceinline__ void store_fq(u64* base, int64_t i,
                                         const U256& a) {
  uint4* p = reinterpret_cast<uint4*>(base + 4 * i);
  p[0] = make_uint4(a.v[0], a.v[1], a.v[2], a.v[3]);
  p[1] = make_uint4(a.v[4], a.v[5], a.v[6], a.v[7]);
}

// Fr loads, stores and block sums, shared by reduction.cu and rows.cu
__device__ __forceinline__ Fr load_fr(const u64* base, int64_t i) {
  return load_fq(base, i);
}

__device__ __forceinline__ void store_fr(u64* base, int64_t i, const Fr& a) {
  store_fq(base, i, a);
}

// a load of data other blocks of this launch wrote (through L2, not L1)
__device__ __forceinline__ Fr ldcg_fr(const u64* base, int64_t i) {
  const uint4* q = reinterpret_cast<const uint4*>(base + 4 * i);
  const uint4 lo = __ldcg(q), hi = __ldcg(q + 1);
  Fr r;
  r.v[0] = lo.x;
  r.v[1] = lo.y;
  r.v[2] = lo.z;
  r.v[3] = lo.w;
  r.v[4] = hi.x;
  r.v[5] = hi.y;
  r.v[6] = hi.z;
  r.v[7] = hi.w;
  return r;
}

__device__ __forceinline__ Fr fr_zero() {
  Fr r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = 0;
  return r;
}

__device__ __forceinline__ Fr fr_shfl_down(const Fr& a, int d) {
  Fr r;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    r.v[j] = __shfl_down_sync(0xffffffffu, a.v[j], d);
  return r;
}

// Sum of x over the block (blockDim.x a multiple of 32), valid in thread 0.
// warp_sums: 32 elements of shared memory.
__device__ __forceinline__ Fr block_sum(Fr x, Fr* warp_sums) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x = fr_add(x, fr_shfl_down(x, d));
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) warp_sums[warp] = x;
  __syncthreads();
  Fr s = fr_zero();
  if (threadIdx.x == 0) {
    const int nwarps = blockDim.x >> 5;
    for (int k = 0; k < nwarps; ++k) s = fr_add(s, warp_sums[k]);
  }
  __syncthreads();  // warp_sums may be reused
  return s;
}

__device__ __forceinline__ Point load_point(const u64* x, const u64* y,
                                            const u64* z, int64_t i) {
  Point p;
  p.x = load_fq(x, i);
  p.y = load_fq(y, i);
  p.z = load_fq(z, i);
  return p;
}

__device__ __forceinline__ void store_point(u64* x, u64* y, u64* z,
                                            int64_t i, const Point& p) {
  store_fq(x, i, p.x);
  store_fq(y, i, p.y);
  store_fq(z, i, p.z);
}

__device__ __forceinline__ Affine load_affine(const u64* x, const u64* y,
                                              int64_t i) {
  Affine p;
  p.x = load_fq(x, i);
  p.y = load_fq(y, i);
  return p;
}

// -a when neg, else a: p - y is canonical, as a finite base's y is never 0
// (BN254's G1 has odd order)
__device__ __forceinline__ Affine affine_neg_if(const Affine& a, bool neg) {
  Affine r;
  r.x = a.x;
  const Fq ny = mont_neg_raw<FqField>(a.y);
#pragma unroll
  for (int j = 0; j < 8; ++j) r.y.v[j] = neg ? ny.v[j] : a.y.v[j];
  return r;
}

// (x : y : 1)
__device__ __forceinline__ Point affine_point(const Affine& a) {
  Point r;
  r.x = a.x;
  r.y = a.y;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.z.v[j] = fq_one(j);
  return r;
}

}  // namespace jolt
