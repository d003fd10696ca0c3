// An Einsum operand partially evaluated at its exclusive output variables on
// the card: out[k] = sum_e A[k, e] eq[e] mod r, one launch a bind
// (device/bind.py drives it; zkops/ops.py's _prove_einsum asks for it).
//
// Replaces no TPU kernel: the JAX package binds on the host
// (jolt_atlas_tpu/zkops/ops.py:360-380, EinsumLayout.bound_operand, an
// object-dtype np.einsum mod r), and so did the port until this kernel. A
// is the operand laid out (K, E), its exclusive axes last, as signed 32- or
// 64-bit integers (the model's weights stay resident on the card as int32);
// eq is the exclusive variables' eq table, E field elements in Montgomery
// form ((E, 4) u64, the host's FrArray layout); out is K field elements in
// Montgomery form.
//
// What bounds it on this card: bytes. The kernel reads A once (K E 4 or 8
// bytes), the eq table once from device memory (E x 32, then from L2 by
// every row) and writes K x 32; GPT-2's layer binds 20,971,520 weight
// elements a proof, 83.9 MB as int32: 25 us at 3.35 TB/s. Its arithmetic
// is one 8-limb row of 32-bit products an element (16 IMADs, 32 for int64),
// 20 us for the same binds at the IMAD peak; no Montgomery product an
// element:
//
// - eq[e] is already x_e R mod r and A[k, e] a plain integer, so the
//   integer sum of A[k, e] eq[e] is congruent to the bound value's
//   Montgomery form. Each thread keeps that sum lazily, unreduced, in 12
//   32-bit limbs: a signed a is offset to u = a + 2^31 (2^63 for int64),
//   a nonnegative word (two for int64, the high one added a limb up), and
//   the thread also sums eq[e] itself (9 limbs); the row's value is then
//   sum u eq - 2^31 sum eq. With fewer than 2^32 elements a row neither
//   sum can overflow (sum u eq < 2^350, sum eq < 2^286).
// - A group of G lanes takes a row (G a power of two up to the 256 threads
//   of a block: the host picks it from E), striding along E, so a warp's
//   loads of A and of eq are coalesced; the group sums its lanes' wide sums
//   by shuffles (and, past a warp, through shared memory), then its first
//   lane reduces both sums once: a Montgomery reduction of each (the
//   512-bit form of mont_redc_sum, whose bound holds for any value below
//   2^384) and a product by R^2 (and by 2^31 R^2) mod r, so the row costs
//   three Montgomery products whatever E is.
//
// Sums are exact, so the partition changes no value: the plain version
// (device/bind.py) sums positive and negative parts apart instead and
// gives the same canonical limbs.
#include "fq.cuh"

namespace jolt {

constexpr int BIND_THREADS = 256;
constexpr int BIND_ACC = 12;  // limbs of sum u eq
constexpr int BIND_SUM = 9;   // limbs of sum eq

// R^2 mod r, 2^31 R^2 mod r and 2^63 R^2 mod r (32-bit limbs)
__device__ __forceinline__ U256 bind_const(int which) {
  constexpr u32 C[3][8] = {
      {0xae216da7u, 0x1bb8e645u, 0xe35c59e3u, 0x53fe3ab1u, 0x53bb8085u,
       0x8c49833du, 0x7f4e44a5u, 0x0216d0b1u},
      {0xfa795fa8u, 0xd8c835f8u, 0x0d6604b3u, 0xae58b1b0u, 0x3bc2757du,
       0x14a46827u, 0xb28b94b4u, 0x1d9c85fbu},
      {0x1359e4d5u, 0x5a70e57eu, 0x5433453eu, 0x0a026cd9u, 0x38655398u,
       0x63a9b475u, 0xbe0bac2cu, 0x1db405e0u}};
  U256 r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = C[which][j];
  return r;
}

// t[0..10] += b * m: the low halves in one carry chain, the high halves a
// limb up in a second; the caller keeps t below 2^352
__device__ __forceinline__ void bind_mad(u32* t, const U256& b, u32 m) {
  asm("mad.lo.cc.u32  %0, %11, %19, %0;\n\t"
      "madc.lo.cc.u32 %1, %12, %19, %1;\n\t"
      "madc.lo.cc.u32 %2, %13, %19, %2;\n\t"
      "madc.lo.cc.u32 %3, %14, %19, %3;\n\t"
      "madc.lo.cc.u32 %4, %15, %19, %4;\n\t"
      "madc.lo.cc.u32 %5, %16, %19, %5;\n\t"
      "madc.lo.cc.u32 %6, %17, %19, %6;\n\t"
      "madc.lo.cc.u32 %7, %18, %19, %7;\n\t"
      "addc.cc.u32    %8, %8, 0;\n\t"
      "addc.cc.u32    %9, %9, 0;\n\t"
      "addc.u32       %10, %10, 0;\n\t"
      "mad.hi.cc.u32  %1, %11, %19, %1;\n\t"
      "madc.hi.cc.u32 %2, %12, %19, %2;\n\t"
      "madc.hi.cc.u32 %3, %13, %19, %3;\n\t"
      "madc.hi.cc.u32 %4, %14, %19, %4;\n\t"
      "madc.hi.cc.u32 %5, %15, %19, %5;\n\t"
      "madc.hi.cc.u32 %6, %16, %19, %6;\n\t"
      "madc.hi.cc.u32 %7, %17, %19, %7;\n\t"
      "madc.hi.cc.u32 %8, %18, %19, %8;\n\t"
      "addc.cc.u32    %9, %9, 0;\n\t"
      "addc.u32       %10, %10, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]),
        "+r"(t[10])
      : "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]), "r"(b.v[4]),
        "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]), "r"(m));
}

// s[0..8] += b
__device__ __forceinline__ void bind_add(u32 s[BIND_SUM], const U256& b) {
  asm("add.cc.u32  %0, %0, %9;\n\t"
      "addc.cc.u32 %1, %1, %10;\n\t"
      "addc.cc.u32 %2, %2, %11;\n\t"
      "addc.cc.u32 %3, %3, %12;\n\t"
      "addc.cc.u32 %4, %4, %13;\n\t"
      "addc.cc.u32 %5, %5, %14;\n\t"
      "addc.cc.u32 %6, %6, %15;\n\t"
      "addc.cc.u32 %7, %7, %16;\n\t"
      "addc.u32    %8, %8, 0;"
      : "+r"(s[0]), "+r"(s[1]), "+r"(s[2]), "+r"(s[3]), "+r"(s[4]),
        "+r"(s[5]), "+r"(s[6]), "+r"(s[7]), "+r"(s[8])
      : "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]), "r"(b.v[4]),
        "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]));
}

// x[0..N-1] += y[0..N-1] (the sums' bounds keep the top limb from
// overflowing); outside the element loop, so plain 64-bit adds
template <int N>
__device__ __forceinline__ void bind_wide_add(u32* x, const u32* y) {
  u64 carry = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    carry += (u64)x[j] + y[j];
    x[j] = (u32)carry;
    carry >>= 32;
  }
}

// x mod r for a wide sum x below 2^384: its Montgomery reduction x / R
// (mont_redc_sum: x's high half is below 2^128, so u + H < 2r), times c / R
template <int N>
__device__ __forceinline__ U256 bind_reduce(const u32* x, const U256& c) {
  U512 T = wide_zero();
#pragma unroll
  for (int j = 0; j < N; ++j) T.v[j] = x[j];
  return mont_mul<FrField>(mont_redc_sum<FrField, 1>(T), c);
}

// W: the operand's bytes an element (4: int32, 8: int64). A group of G
// lanes a row, BIND_THREADS / G rows a block.
template <int W>
__global__ void __launch_bounds__(BIND_THREADS)
    einsum_bind_kernel(const void* __restrict__ A, const u64* __restrict__ eq,
                       u64* __restrict__ out, int64_t K, int64_t E, int G) {
  __shared__ u32 part[BIND_THREADS / 32][BIND_ACC + BIND_SUM];
  const int lane = threadIdx.x & (G - 1);
  const int64_t row =
      (int64_t)blockIdx.x * (BIND_THREADS / G) + threadIdx.x / G;
  u32 x[BIND_ACC + BIND_SUM];  // sum u eq, then sum eq
#pragma unroll
  for (int j = 0; j < BIND_ACC + BIND_SUM; ++j) x[j] = 0;
  u32* acc = x;
  u32* sum = x + BIND_ACC;
  if (row < K) {
    for (int64_t e = lane; e < E; e += G) {
      const U256 b = load_fr(eq, e);
      if constexpr (W == 4) {
        const int32_t a = static_cast<const int32_t*>(A)[row * E + e];
        bind_mad(acc, b, (u32)a ^ 0x80000000u);  // a + 2^31
      } else {
        const u64 u =
            (u64)static_cast<const int64_t*>(A)[row * E + e] ^ (1ull << 63);
        bind_mad(acc, b, (u32)u);
        bind_mad(acc + 1, b, (u32)(u >> 32));
      }
      bind_add(sum, b);
    }
  }
  // the group's sum: shuffles within a warp, then its warps' partials
  const int width = G < 32 ? G : 32;
  for (int d = width >> 1; d > 0; d >>= 1) {
    u32 y[BIND_ACC + BIND_SUM];
#pragma unroll
    for (int j = 0; j < BIND_ACC + BIND_SUM; ++j)
      y[j] = __shfl_down_sync(0xffffffffu, x[j], d, width);
    bind_wide_add<BIND_ACC>(acc, y);
    bind_wide_add<BIND_SUM>(sum, y + BIND_ACC);
  }
  if (G > 32) {
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int j = 0; j < BIND_ACC + BIND_SUM; ++j) part[warp][j] = x[j];
    }
    __syncthreads();
    if (lane == 0) {
      for (int w = warp + 1; w < warp + G / 32; ++w) {
        bind_wide_add<BIND_ACC>(acc, part[w]);
        bind_wide_add<BIND_SUM>(sum, part[w] + BIND_ACC);
      }
    }
  }
  if (lane != 0 || row >= K) return;
  const U256 value = bind_reduce<BIND_ACC>(acc, bind_const(0));
  const U256 offset = bind_reduce<BIND_SUM>(sum, bind_const(W == 4 ? 1 : 2));
  store_fr(out, row, mont_sub<FrField>(value, offset));
}

}  // namespace jolt

// out (K, 4) u64 = A (K, E; `width` bytes an element, signed) bound against
// eq (E, 4) u64, a group of `group` lanes a row (a power of two up to 256).
// If out_host is given (pinned host memory), out is copied there and the
// stream synchronised: the bind's one fetch. Returns the first CUDA error.
extern "C" int jolt_einsum_bind(const void* A, int64_t width, int64_t K,
                                int64_t E, const void* eq, void* out,
                                int64_t group, void* out_host, void* stream) {
  if ((width != 4 && width != 8) || K < 1 || E < 1 || E >= (1ll << 32) ||
      group < 1 || group > jolt::BIND_THREADS || (group & (group - 1)))
    return (int)cudaErrorInvalidValue;
  const int64_t rows = jolt::BIND_THREADS / group;
  const int64_t blocks = (K + rows - 1) / rows;
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (width == 4)
    jolt::einsum_bind_kernel<4><<<(unsigned)blocks, jolt::BIND_THREADS, 0, s>>>(
        A, (const jolt::u64*)eq, (jolt::u64*)out, K, E, (int)group);
  else
    jolt::einsum_bind_kernel<8><<<(unsigned)blocks, jolt::BIND_THREADS, 0, s>>>(
        A, (const jolt::u64*)eq, (jolt::u64*)out, K, E, (int)group);
  int rc = (int)cudaGetLastError();
  if (rc != 0 || out_host == nullptr) return rc;
  rc = (int)cudaMemcpyAsync(out_host, out, K * 32, cudaMemcpyDeviceToHost, s);
  if (rc != 0) return rc;
  return (int)cudaStreamSynchronize(s);
}
