// BN254 base field (Fq) Montgomery arithmetic and the complete projective
// point add, as device functions shared by curve.cu and msm.cu.
//
// Replaces the register-resident body of the Pallas kernel
// jolt_atlas_tpu/tpu/pallas_curve.py (_mont_mul, _cond_sub_p, _fadd, _fsub,
// _pp_add_body). The TPU version worked on 16 planes of 16-bit limbs in
// 32-bit vector lanes because its VPU has no wide multiply; here one thread
// holds a field element as 4 x u64 Montgomery limbs (R = 2^256, the host
// layout) and multiplies with mul.lo/__umul64hi, so a Montgomery product is
// a 4-step CIOS instead of a 16-step one. Every result is canonical (< p),
// so the outputs are the same numbers the Pallas kernel produces.
#pragma once

#include <cstdint>

namespace jolt {

typedef unsigned long long u64;

__device__ __forceinline__ u64 fq_p(int i) {
  return i == 0 ? 0x3c208c16d87cfd47ULL
       : i == 1 ? 0x97816a916871ca8dULL
       : i == 2 ? 0xb85045b68181585dULL
                : 0x30644e72e131a029ULL;
}
// -p^-1 mod 2^64
constexpr u64 FQ_N0 = 0x87d20782e4866389ULL;
// R mod p (Montgomery one)
__device__ __forceinline__ u64 fq_one(int i) {
  return i == 0 ? 0xd35d438dc58f0d9dULL
       : i == 1 ? 0x0a78eb28f5c70b3dULL
       : i == 2 ? 0x666ea36f7879462cULL
                : 0x0e0a77c19a07df2fULL;
}

struct Fq {
  u64 v[4];
};

struct Point {  // homogeneous projective (X : Y : Z), identity (0 : 1 : 0)
  Fq x, y, z;
};

// low 64 bits of t + a*b + carry; carry <- high 64 bits (never overflows:
// (2^64-1)^2 + 2(2^64-1) = 2^128 - 1)
__device__ __forceinline__ u64 mac(u64 t, u64 a, u64 b, u64& carry) {
  u64 lo = a * b;
  u64 hi = __umul64hi(a, b);
  lo += t;
  hi += (lo < t);
  lo += carry;
  hi += (lo < carry);
  carry = hi;
  return lo;
}

// a + b + carry, carry in/out in {0, 1}
__device__ __forceinline__ u64 adc(u64 a, u64 b, u64& carry) {
  u64 s = a + b;
  u64 c1 = s < a;
  u64 s2 = s + carry;
  u64 c2 = s2 < s;
  carry = c1 | c2;
  return s2;
}

// a - b - borrow, borrow in/out in {0, 1}
__device__ __forceinline__ u64 sbb(u64 a, u64 b, u64& borrow) {
  u64 d = a - b;
  u64 b1 = a < b;
  u64 d2 = d - borrow;
  u64 b2 = d < borrow;
  borrow = b1 | b2;
  return d2;
}

// r + top * 2^256 lies in [0, 2p): subtract p once if it is >= p
__device__ __forceinline__ void fq_cond_sub(Fq& r, u64 top) {
  Fq d;
  u64 borrow = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) d.v[j] = sbb(r.v[j], fq_p(j), borrow);
  const bool take = top != 0 || borrow == 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) r.v[j] = take ? d.v[j] : r.v[j];
}

// Montgomery product a*b/R mod p, CIOS over 64-bit words; a, b < p
__device__ __forceinline__ Fq fq_mul(const Fq& a, const Fq& b) {
  u64 t[6] = {0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) t[j] = mac(t[j], a.v[i], b.v[j], c);
    u64 c2 = 0;
    t[4] = adc(t[4], c, c2);
    t[5] = c2;
    const u64 m = t[0] * FQ_N0;
    c = 0;
    (void)mac(t[0], m, fq_p(0), c);  // low word is zero by choice of m
#pragma unroll
    for (int j = 1; j < 4; ++j) t[j - 1] = mac(t[j], m, fq_p(j), c);
    c2 = 0;
    t[3] = adc(t[4], c, c2);
    t[4] = t[5] + c2;
  }
  Fq r;
#pragma unroll
  for (int j = 0; j < 4; ++j) r.v[j] = t[j];
  fq_cond_sub(r, t[4]);
  return r;
}

__device__ __forceinline__ Fq fq_add(const Fq& a, const Fq& b) {
  Fq r;
  u64 c = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) r.v[j] = adc(a.v[j], b.v[j], c);
  fq_cond_sub(r, c);
  return r;
}

__device__ __forceinline__ Fq fq_sub(const Fq& a, const Fq& b) {
  Fq r;
  u64 borrow = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) r.v[j] = sbb(a.v[j], b.v[j], borrow);
  if (borrow) {  // a < b: add p back; the carry out cancels the borrow
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) r.v[j] = adc(r.v[j], fq_p(j), c);
  }
  return r;
}

__device__ __forceinline__ Point pp_identity() {
  Point r;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    r.x.v[j] = 0;
    r.y.v[j] = fq_one(j);
    r.z.v[j] = 0;
  }
  return r;
}

// RCB15 Algorithm 7 (a = 0, b3 = 3b = 9): complete addition, correct for
// doubling, inverses and the identity without branches. The same sequence
// of operations as pallas_curve._pp_add_body, op for op.
__device__ __forceinline__ Point pp_add_dev(const Point& P1,
                                            const Point& P2) {
  const Fq &X1 = P1.x, &Y1 = P1.y, &Z1 = P1.z;
  const Fq &X2 = P2.x, &Y2 = P2.y, &Z2 = P2.z;
  Fq t0 = fq_mul(X1, X2);
  Fq t1 = fq_mul(Y1, Y2);
  Fq t2 = fq_mul(Z1, Z2);
  Fq t3 = fq_add(X1, Y1);
  Fq t4 = fq_add(X2, Y2);
  t3 = fq_mul(t3, t4);
  t4 = fq_add(t0, t1);
  t3 = fq_sub(t3, t4);  // X1Y2 + X2Y1
  t4 = fq_add(Y1, Z1);
  Fq X3 = fq_add(Y2, Z2);
  t4 = fq_mul(t4, X3);
  X3 = fq_add(t1, t2);
  t4 = fq_sub(t4, X3);  // Y1Z2 + Y2Z1
  X3 = fq_add(X1, Z1);
  Fq Y3 = fq_add(X2, Z2);
  X3 = fq_mul(X3, Y3);
  Y3 = fq_add(t0, t2);
  Y3 = fq_sub(X3, Y3);  // X1Z2 + X2Z1
  X3 = fq_add(t0, t0);
  t0 = fq_add(X3, t0);  // 3 X1X2
  {                     // t2 = b3 * t2 = 8 t2 + t2
    Fq x2 = fq_add(t2, t2);
    Fq x4 = fq_add(x2, x2);
    Fq x8 = fq_add(x4, x4);
    t2 = fq_add(x8, t2);
  }
  Fq Z3 = fq_add(t1, t2);
  t1 = fq_sub(t1, t2);
  {  // Y3 = b3 * Y3
    Fq x2 = fq_add(Y3, Y3);
    Fq x4 = fq_add(x2, x2);
    Fq x8 = fq_add(x4, x4);
    Y3 = fq_add(x8, Y3);
  }
  X3 = fq_mul(t4, Y3);
  t2 = fq_mul(t3, t1);
  X3 = fq_sub(t2, X3);
  Y3 = fq_mul(Y3, t0);
  t1 = fq_mul(t1, Z3);
  Y3 = fq_add(t1, Y3);
  t0 = fq_mul(t0, t3);
  Z3 = fq_mul(Z3, t4);
  Z3 = fq_add(Z3, t0);
  Point r;
  r.x = X3;
  r.y = Y3;
  r.z = Z3;
  return r;
}

__device__ __forceinline__ Fq load_fq(const u64* base, int64_t i) {
  const ulonglong2* p = reinterpret_cast<const ulonglong2*>(base + 4 * i);
  const ulonglong2 lo = p[0], hi = p[1];
  Fq r;
  r.v[0] = lo.x;
  r.v[1] = lo.y;
  r.v[2] = hi.x;
  r.v[3] = hi.y;
  return r;
}

__device__ __forceinline__ void store_fq(u64* base, int64_t i, const Fq& a) {
  ulonglong2* p = reinterpret_cast<ulonglong2*>(base + 4 * i);
  p[0] = make_ulonglong2(a.v[0], a.v[1]);
  p[1] = make_ulonglong2(a.v[2], a.v[3]);
}

}  // namespace jolt
