// 4x64-limb Montgomery multiplication, mulx/adcx/adox fast path.
//
// Modulus-generic CIOS over the dual-carry-chain x86-64 extension ISA
// (BMI2 + ADX): ~2x over the portable __int128 CIOS on the same core
// (measured 20 ns vs 41 ns dependent-chain latency on Cascade Lake).
// Used for both BN254 Fr (frvec.cpp) and Fq (msm.cpp) — the same role
// arkworks' derived asm backend plays under the reference's field layer
// (joltworks/src/field/mod.rs:103 riding ark_ff's asm feature).
//
// qc layout: qc[0..3] = modulus limbs (LE), qc[4] = -q^{-1} mod 2^64.
// Requires modulus < 2^63 * 2^192 (top limb < 2^63) so the 5th CIOS word
// fits one register with both carry chains folded in; BN254 Fr and Fq
// both have top limb 0x30644e72e131a029 < 2^62.
//
// out may alias a or b (result is written only at the end).
#pragma once
#include <cstdint>

#if defined(__ADX__) && defined(__BMI2__) && defined(__x86_64__)
#define MONT4_ADX 1

typedef uint64_t mont4_out_t[4];
typedef const uint64_t mont4_in_t[4];
typedef const uint64_t mont4_qc_t[5];

static inline void mont4_mul_adx(uint64_t* o, const uint64_t* a,
                                 const uint64_t* b, const uint64_t* qc) {
  // Precise memory constraints (no "memory" clobber): a full barrier per
  // mul defeats the compiler's scheduling in the vector kernels' loops.
  asm(
    // ---- i = 0: T = a0 * b ------------------------------------------
    "movq 0(%[A]), %%rdx\n\t"
    "xorq %%rcx, %%rcx\n\t"
    "mulxq 0(%[B]), %%r8, %%r9\n\t"
    "mulxq 8(%[B]), %%rax, %%r10\n\t"
    "adcxq %%rax, %%r9\n\t"
    "mulxq 16(%[B]), %%rax, %%r11\n\t"
    "adcxq %%rax, %%r10\n\t"
    "mulxq 24(%[B]), %%rax, %%r12\n\t"
    "adcxq %%rax, %%r11\n\t"
    "adcxq %%rcx, %%r12\n\t"
    // reduce: m = t0 * qinv; T = (T + m*q) >> 64 -> (r9,r10,r11,r12)
    "movq %%r8, %%rdx\n\t"
    "imulq 32(%[Q]), %%rdx\n\t"
    "xorq %%rcx, %%rcx\n\t"
    "mulxq 0(%[Q]), %%rax, %%rbx\n\t"
    "adcxq %%r8, %%rax\n\t"
    "adoxq %%rbx, %%r9\n\t"
    "mulxq 8(%[Q]), %%rax, %%rbx\n\t"
    "adcxq %%rax, %%r9\n\t"
    "adoxq %%rbx, %%r10\n\t"
    "mulxq 16(%[Q]), %%rax, %%rbx\n\t"
    "adcxq %%rax, %%r10\n\t"
    "adoxq %%rbx, %%r11\n\t"
    "mulxq 24(%[Q]), %%rax, %%rbx\n\t"
    "adcxq %%rax, %%r11\n\t"
    "adoxq %%rbx, %%r12\n\t"
    "adcxq %%rcx, %%r12\n\t"
    "adoxq %%rcx, %%r12\n\t"
    // ---- i = 1: T += a1 * b; 5th word in r8 --------------------------
    "movq 8(%[A]), %%rdx\n\t"
    "xorq %%r8, %%r8\n\t"
    "mulxq 0(%[B]), %%rax, %%rbx\n\t"
    "adcxq %%rax, %%r9\n\t"
    "adoxq %%rbx, %%r10\n\t"
    "mulxq 8(%[B]), %%rax, %%rbx\n\t"
    "adcxq %%rax, %%r10\n\t"
    "adoxq %%rbx, %%r11\n\t"
    "mulxq 16(%[B]), %%rax, %%rbx\n\t"
    "adcxq %%rax, %%r11\n\t"
    "adoxq %%rbx, %%r12\n\t"
    "mulxq 24(%[B]), %%rax, %%rbx\n\t"
    "adcxq %%rax, %%r12\n\t"
    "adoxq %%rbx, %%r8\n\t"
    "adcxq %%rcx, %%r8\n\t"
    // reduce -> (r10,r11,r12,r8)
    "movq %%r9, %%rdx\n\t"
    "imulq 32(%[Q]), %%rdx\n\t"
    "xorq %%rcx, %%rcx\n\t"
    "mulxq 0(%[Q]), %%rax, %%rbx\n\t"
    "adcxq %%r9, %%rax\n\t"
    "adoxq %%rbx, %%r10\n\t"
    "mulxq 8(%[Q]), %%rax, %%rbx\n\t"
    "adcxq %%rax, %%r10\n\t"
    "adoxq %%rbx, %%r11\n\t"
    "mulxq 16(%[Q]), %%rax, %%rbx\n\t"
    "adcxq %%rax, %%r11\n\t"
    "adoxq %%rbx, %%r12\n\t"
    "mulxq 24(%[Q]), %%rax, %%rbx\n\t"
    "adcxq %%rax, %%r12\n\t"
    "adoxq %%rbx, %%r8\n\t"
    "adcxq %%rcx, %%r8\n\t"
    "adoxq %%rcx, %%r8\n\t"
    // ---- i = 2: 5th word in r9 ---------------------------------------
    "movq 16(%[A]), %%rdx\n\t"
    "xorq %%r9, %%r9\n\t"
    "mulxq 0(%[B]), %%rax, %%rbx\n\t"
    "adcxq %%rax, %%r10\n\t"
    "adoxq %%rbx, %%r11\n\t"
    "mulxq 8(%[B]), %%rax, %%rbx\n\t"
    "adcxq %%rax, %%r11\n\t"
    "adoxq %%rbx, %%r12\n\t"
    "mulxq 16(%[B]), %%rax, %%rbx\n\t"
    "adcxq %%rax, %%r12\n\t"
    "adoxq %%rbx, %%r8\n\t"
    "mulxq 24(%[B]), %%rax, %%rbx\n\t"
    "adcxq %%rax, %%r8\n\t"
    "adoxq %%rbx, %%r9\n\t"
    "adcxq %%rcx, %%r9\n\t"
    // reduce -> (r11,r12,r8,r9)
    "movq %%r10, %%rdx\n\t"
    "imulq 32(%[Q]), %%rdx\n\t"
    "xorq %%rcx, %%rcx\n\t"
    "mulxq 0(%[Q]), %%rax, %%rbx\n\t"
    "adcxq %%r10, %%rax\n\t"
    "adoxq %%rbx, %%r11\n\t"
    "mulxq 8(%[Q]), %%rax, %%rbx\n\t"
    "adcxq %%rax, %%r11\n\t"
    "adoxq %%rbx, %%r12\n\t"
    "mulxq 16(%[Q]), %%rax, %%rbx\n\t"
    "adcxq %%rax, %%r12\n\t"
    "adoxq %%rbx, %%r8\n\t"
    "mulxq 24(%[Q]), %%rax, %%rbx\n\t"
    "adcxq %%rax, %%r8\n\t"
    "adoxq %%rbx, %%r9\n\t"
    "adcxq %%rcx, %%r9\n\t"
    "adoxq %%rcx, %%r9\n\t"
    // ---- i = 3: 5th word in r10 --------------------------------------
    "movq 24(%[A]), %%rdx\n\t"
    "xorq %%r10, %%r10\n\t"
    "mulxq 0(%[B]), %%rax, %%rbx\n\t"
    "adcxq %%rax, %%r11\n\t"
    "adoxq %%rbx, %%r12\n\t"
    "mulxq 8(%[B]), %%rax, %%rbx\n\t"
    "adcxq %%rax, %%r12\n\t"
    "adoxq %%rbx, %%r8\n\t"
    "mulxq 16(%[B]), %%rax, %%rbx\n\t"
    "adcxq %%rax, %%r8\n\t"
    "adoxq %%rbx, %%r9\n\t"
    "mulxq 24(%[B]), %%rax, %%rbx\n\t"
    "adcxq %%rax, %%r9\n\t"
    "adoxq %%rbx, %%r10\n\t"
    "adcxq %%rcx, %%r10\n\t"
    // reduce -> (r12,r8,r9,r10)
    "movq %%r11, %%rdx\n\t"
    "imulq 32(%[Q]), %%rdx\n\t"
    "xorq %%rcx, %%rcx\n\t"
    "mulxq 0(%[Q]), %%rax, %%rbx\n\t"
    "adcxq %%r11, %%rax\n\t"
    "adoxq %%rbx, %%r12\n\t"
    "mulxq 8(%[Q]), %%rax, %%rbx\n\t"
    "adcxq %%rax, %%r12\n\t"
    "adoxq %%rbx, %%r8\n\t"
    "mulxq 16(%[Q]), %%rax, %%rbx\n\t"
    "adcxq %%rax, %%r8\n\t"
    "adoxq %%rbx, %%r9\n\t"
    "mulxq 24(%[Q]), %%rax, %%rbx\n\t"
    "adcxq %%rax, %%r9\n\t"
    "adoxq %%rbx, %%r10\n\t"
    "adcxq %%rcx, %%r10\n\t"
    "adoxq %%rcx, %%r10\n\t"
    // conditional subtract q, store
    "movq %%r12, %%rax\n\t"
    "movq %%r8, %%rbx\n\t"
    "movq %%r9, %%rcx\n\t"
    "movq %%r10, %%rdx\n\t"
    "subq 0(%[Q]), %%rax\n\t"
    "sbbq 8(%[Q]), %%rbx\n\t"
    "sbbq 16(%[Q]), %%rcx\n\t"
    "sbbq 24(%[Q]), %%rdx\n\t"
    "cmovcq %%r12, %%rax\n\t"
    "cmovcq %%r8, %%rbx\n\t"
    "cmovcq %%r9, %%rcx\n\t"
    "cmovcq %%r10, %%rdx\n\t"
    "movq %%rax, 0(%[O])\n\t"
    "movq %%rbx, 8(%[O])\n\t"
    "movq %%rcx, 16(%[O])\n\t"
    "movq %%rdx, 24(%[O])\n\t"
    : "=m"(*(mont4_out_t*)o)
    : [A]"r"(a), [B]"r"(b), [Q]"r"(qc), [O]"r"(o),
      "m"(*(mont4_in_t*)a), "m"(*(mont4_in_t*)b), "m"(*(mont4_qc_t*)qc)
    : "rax","rbx","rcx","rdx","r8","r9","r10","r11","r12","cc");
}
#endif  // __ADX__ && __BMI2__ && __x86_64__
