// Kernel 9: the exact integer matrix product of the quantized forward.
//
// Replaces the XLA program jolt_atlas_tpu/jaxexec.py exact_matmul_rescale
// (:34) with _digits_rescale_saturate (:71), and the int64 jnp.einsum of
// its general Einsum branch (:163-167). For each batch b, row m and column
// n:
//
//   s = sum_{k < K} a[b, m, k] b[b, k, n]            (i32 operands)
//   out[b, m, n] = sat_i32(floor(s / 2^shift))
//
// held exactly (|s| < 2^74 for K <= 4096) or, with `wrap`, s taken mod
// 2^64 as a signed int64 first, as XLA's s64 einsum wraps. The reference
// cannot lower an s64 dot on the TPU, so it splits each operand into four
// 8-bit limbs and runs 16 int32 products and a carry cascade; the card
// multiplies 32 x 32 -> 64 bits in one IMAD.WIDE, so here b is split once
// into a low 16-bit half (0 .. 2^16 - 1) and a signed high half (b >> 16),
// and each product costs two IMAD.WIDE into two int64 sums:
//
//   lo = sum a (b & 0xffff),  |a (b & 0xffff)| < 2^47
//   hi = sum a (b >> 16),     |a (b >> 16)|   <= 2^46
//
// For K <= 4096 neither sum leaves int64 (|lo| < 2^59, |hi| <= 2^58), and
// s = hi 2^16 + lo is formed once in __int128 at the end. With `wrap` only
// s mod 2^64 matters, which wrapping (unsigned) sums give for any K.
//
// Bound: the two IMAD a product over the card's IMAD rate at the bench's
// widths; a GPT-2 sized product (1024 x 768 x 3072) needs 4.8e9 IMAD,
// about 0.29 ms at 16.7 T/s, against 15.7 MB of operands and output (5 us
// at 3.35 TB/s). The design is a plain shared-memory tile: a block of 256
// threads takes a 64 x 64 tile of the output, stages 16-deep slices of a
// and of b's two halves in shared memory, and each thread keeps a 4 x 4
// sub-tile's 32 int64 sums in registers. Operands are read through their
// strides (any layout, a batch stride of 0 broadcasts), so the wrapper
// never copies a transposed operand. Tensor cores (int8 IMMA over an 8-bit
// limb split) are a later redesign.
#include <cuda_runtime.h>
#include <stdint.h>

namespace jolt {

constexpr int EXACT_TILE = 64;     // output rows and columns a block
constexpr int EXACT_DEPTH = 16;    // k a shared slice
constexpr int EXACT_SUB = 4;       // rows and columns a thread
constexpr int EXACT_THREADS = 256;  // (64 / 4)^2

// floor(s / 2^k) for either sign, with no right shift of a negative value
// (whose rounding C++ leaves to the implementation): for s < 0 it is
// ~(~s >> k), and ~s = -s - 1 >= 0 never overflows
template <typename T>
__device__ __forceinline__ T floor_shift(T s, int k) {
  return s >= 0 ? (s >> k) : ~((~s) >> k);
}

__device__ __forceinline__ int32_t saturate_i32_128(__int128 v) {
  if (v > (__int128)INT32_MAX) return INT32_MAX;
  if (v < (__int128)INT32_MIN) return INT32_MIN;
  return (int32_t)v;
}

__global__ void __launch_bounds__(EXACT_THREADS)
exact_matmul_kernel(const int32_t* __restrict__ a,
                    const int32_t* __restrict__ b, int32_t* __restrict__ out,
                    int64_t M, int64_t K, int64_t N, int64_t sab, int64_t sam,
                    int64_t sak, int64_t sbb, int64_t sbk, int64_t sbn,
                    int shift, int wrap) {
  // a's slice transposed, its rows padded so that a warp's 16 stores of
  // one row's k entries fall in different banks
  __shared__ int32_t as[EXACT_DEPTH][EXACT_TILE + 1];
  __shared__ int32_t bl[EXACT_DEPTH][EXACT_TILE];
  __shared__ int32_t bh[EXACT_DEPTH][EXACT_TILE];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t batch = blockIdx.z;
  const int64_t m0 = (int64_t)blockIdx.y * EXACT_TILE;
  const int64_t n0 = (int64_t)blockIdx.x * EXACT_TILE;
  a += batch * sab;
  b += batch * sbb;
  uint64_t lo[EXACT_SUB][EXACT_SUB], hi[EXACT_SUB][EXACT_SUB];
#pragma unroll
  for (int i = 0; i < EXACT_SUB; ++i)
#pragma unroll
    for (int j = 0; j < EXACT_SUB; ++j) lo[i][j] = hi[i][j] = 0;
  for (int64_t k0 = 0; k0 < K; k0 += EXACT_DEPTH) {
    // each thread stages 4 entries of a's slice and 4 of b's (zero past
    // the edges)
#pragma unroll
    for (int e = 0; e < EXACT_DEPTH * EXACT_TILE / EXACT_THREADS; ++e) {
      const int idx = threadIdx.x + e * EXACT_THREADS;
      const int r = idx / EXACT_DEPTH, c = idx % EXACT_DEPTH;  // a: row, k
      const int64_t m = m0 + r, k = k0 + c;
      as[c][r] = (m < M && k < K) ? a[m * sam + k * sak] : 0;
      const int kr = idx / EXACT_TILE, nc = idx % EXACT_TILE;  // b: k, col
      const int64_t kb = k0 + kr, n = n0 + nc;
      const int32_t v = (kb < K && n < N) ? b[kb * sbk + n * sbn] : 0;
      bl[kr][nc] = v & 0xffff;
      bh[kr][nc] = floor_shift(v, 16);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < EXACT_DEPTH; ++kk) {
      int32_t av[EXACT_SUB], lv[EXACT_SUB], hv[EXACT_SUB];
#pragma unroll
      for (int i = 0; i < EXACT_SUB; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < EXACT_SUB; ++j) {
        lv[j] = bl[kk][tx + 16 * j];
        hv[j] = bh[kk][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < EXACT_SUB; ++i)
#pragma unroll
        for (int j = 0; j < EXACT_SUB; ++j) {
          lo[i][j] += (uint64_t)((int64_t)av[i] * lv[j]);
          hi[i][j] += (uint64_t)((int64_t)av[i] * hv[j]);
        }
    }
    __syncthreads();
  }
  out += batch * M * N;
#pragma unroll
  for (int i = 0; i < EXACT_SUB; ++i)
#pragma unroll
    for (int j = 0; j < EXACT_SUB; ++j) {
      const int64_t m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m >= M || n >= N) continue;
      int32_t r;
      if (wrap) {
        const int64_t s = (int64_t)((hi[i][j] << 16) + lo[i][j]);
        const int64_t q = floor_shift(s, shift);
        r = q > INT32_MAX ? INT32_MAX : (q < INT32_MIN ? INT32_MIN
                                                        : (int32_t)q);
      } else {
        const __int128 s = (__int128)(int64_t)hi[i][j] * 65536 +
                           (__int128)(int64_t)lo[i][j];
        r = saturate_i32_128(floor_shift(s, shift));
      }
      out[m * N + n] = r;
    }
}

}  // namespace jolt

// out (batch, M, N) int32, contiguous; a and b read through their element
// strides. K <= 4096 unless wrap; 0 <= shift <= 63.
extern "C" int jolt_exact_matmul(const void* a, const void* b, void* out,
                                 int64_t batch, int64_t M, int64_t K,
                                 int64_t N, int64_t sab, int64_t sam,
                                 int64_t sak, int64_t sbb, int64_t sbk,
                                 int64_t sbn, int shift, int wrap,
                                 void* stream) {
  using jolt::EXACT_TILE;
  if (batch < 0 || M < 0 || N < 0 || K < 0 || shift < 0 || shift > 63 ||
      (!wrap && K > 4096) || batch > 65535 ||
      (M + EXACT_TILE - 1) / EXACT_TILE > 65535)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || M == 0 || N == 0) return 0;
  const dim3 grid((unsigned)((N + EXACT_TILE - 1) / EXACT_TILE),
                  (unsigned)((M + EXACT_TILE - 1) / EXACT_TILE),
                  (unsigned)batch);
  jolt::exact_matmul_kernel<<<grid, jolt::EXACT_THREADS, 0,
                              (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)b, (int32_t*)out, M, K, N, sab, sam,
      sak, sbb, sbk, sbn, shift, wrap);
  return (int)cudaGetLastError();
}
