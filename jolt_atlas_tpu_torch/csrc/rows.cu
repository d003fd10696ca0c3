// Kernel 7: the round message of a dense Gruen rows instance, the head
// rounds of the IOP's sumchecks on the card.
//
// Replaces the XLA program jolt_atlas_tpu/parallel/shardedrows.py
// _points_kernel (on one device its psum over 'sp' is the identity), and
// computes what the host's csrc/frvec.cpp frv_gruen_round_p does:
//
//   out[i] = sum_{j < n/2} w(j) sum_k c_k prod_{f in F_k} (lo_f[j] + t d_f[j])
//
// mod r, for the i-th point t of 0, 2, 3, ..., nevals, where lo_f and
// hi_f = lo_f + d_f are the halves of row f (HighToLow binding pairs j with
// j + n/2). A term with no factor adds c_k. The split-eq weight w(j) is
// wlo[j & (2^log_wlo - 1)] if log_wlo >= 0, times whi[(j >> whi_shift) &
// (whi_n - 1)] if whi_n > 1, and one where neither table is given.
//
// The P rows are one (P n, 4) u64 Montgomery buffer, row p at p n (the
// layout kernel 4 binds as P lanes). A thread takes one pair j at one point
// t (blockIdx.y picks t): the bench's instances have 2^12-2^14 elements, so
// pairs alone would not fill the card. The host keeps every row's value at
// every point (e[P][nevals], frvec.cpp); here a thread recomputes lo + t d
// for each factor where its term needs it, from loads that the block's
// other points and terms share in L1/L2, with t d as a short chain of adds
// (t is a small integer), so registers do not grow with P or nevals. A
// product chain stops at a zero factor and a coefficient of one is not
// multiplied, as on the host. Each block sums its threads' values into one
// canonical partial a point (warp shuffles, then the warp sums); a second
// pass, one block a point, adds a point's partials. Field sums are exact,
// so the order is free and the plain version need not follow the
// partition. Bound by IMAD throughput: per pair and point, the term
// products, the coefficient products and the weight's.
//
// Kernel 8, rows_from_i64: most of the IOP's rows are small integers
// (witness values, chunks, indicators). The reference converts every row
// to Montgomery form on the host and sends 32 bytes an element
// (shardedrows.py:303, p.to_field()); here such a row goes up as int64, 8
// bytes an element, and a thread an element forms v R mod r as the
// Montgomery product of |v| by R^2 mod r, negated when v < 0. Bound by
// IMAD throughput (one product an element) next to 40 bytes moved.
#include <cuda_runtime.h>

#include "fq.cuh"

namespace jolt {

constexpr int ROWS_THREADS = 128;
constexpr int ROWS_MAX_EVALS = 20;  // frvec GruenInstance.MAXE

__device__ __forceinline__ bool fr_is_zero(const Fr& a) {
  u32 o = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) o |= a.v[j];
  return o == 0;
}

__device__ __forceinline__ bool fr_is_one(const Fr& a) {
  bool eq = true;
#pragma unroll
  for (int j = 0; j < 8; ++j) eq = eq && a.v[j] == FrField::one(j);
  return eq;
}

// lo + t (hi - lo) of row `row` at pair j; m = t - 1 >= 1 when t >= 2
__device__ __forceinline__ Fr row_at(const u64* row, int64_t j, int64_t half,
                                     int t, int m, int top) {
  const Fr lo = load_fr(row, j);
  if (t == 0) return lo;
  const Fr hi = load_fr(row, j + half);
  const Fr d = fr_sub(hi, lo);
  Fr md = d;  // m d by doubling and adding, from m's top bit down
  for (int b = top - 1; b >= 0; --b) {
    md = fr_add(md, md);
    if ((m >> b) & 1) md = fr_add(md, d);
  }
  return fr_add(hi, md);
}

// partials[i * nblk + b]: block b's sum at point i (gridDim = (nblk, nevals))
__global__ void __launch_bounds__(ROWS_THREADS)
    rows_points_kernel(const u64* __restrict__ x, int64_t n,
                       const u64* __restrict__ coeffs,
                       const int64_t* __restrict__ offs,
                       const int64_t* __restrict__ fidx, int64_t T,
                       const u64* __restrict__ tab, int64_t whi_off,
                       int64_t whi_n, int whi_shift, int64_t wlo_off,
                       int log_wlo, u64* __restrict__ partials,
                       int64_t nblk) {
  __shared__ Fr warp_sums[32];
  const int i = blockIdx.y;
  const int t = i ? i + 1 : 0;
  const int m = t > 0 ? t - 1 : 1;
  const int top = 31 - __clz(m);
  const int64_t half = n >> 1;
  const int64_t j = (int64_t)blockIdx.x * ROWS_THREADS + threadIdx.x;
  Fr v = fr_zero();
  if (j < half) {
    for (int64_t k = 0; k < T; ++k) {
      const int64_t a = offs[k], b = offs[k + 1];
      const Fr c = load_fr(coeffs, k);
      if (a == b) {  // a constant term
        v = fr_add(v, c);
        continue;
      }
      Fr prod = row_at(x + 4 * fidx[a] * n, j, half, t, m, top);
      for (int64_t f = a + 1; f < b && !fr_is_zero(prod); ++f)
        prod = fr_mul(prod, row_at(x + 4 * fidx[f] * n, j, half, t, m, top));
      if (fr_is_zero(prod)) continue;
      if (!fr_is_one(c)) prod = fr_mul(prod, c);
      v = fr_add(v, prod);
    }
    if (!fr_is_zero(v)) {
      const bool lo_w = log_wlo >= 0, hi_w = whi_n > 1;
      if (lo_w || hi_w) {
        Fr w = fr_zero();
        if (lo_w)
          w = load_fr(tab, wlo_off + (j & (((int64_t)1 << log_wlo) - 1)));
        if (hi_w) {
          const int sh = whi_shift < 63 ? whi_shift : 63;
          const Fr h = load_fr(tab, whi_off + ((j >> sh) & (whi_n - 1)));
          w = lo_w ? fr_mul(w, h) : h;
        }
        v = fr_mul(v, w);
      }
    }
  }
  v = block_sum(v, warp_sums);
  if (threadIdx.x == 0) store_fr(partials, (int64_t)i * nblk + blockIdx.x, v);
}

// out[i] = the sum of partials[i * nblk ..][:nblk] (one block a point)
__global__ void __launch_bounds__(ROWS_THREADS)
    rows_sum_kernel(const u64* __restrict__ partials, int64_t nblk,
                    u64* __restrict__ out) {
  __shared__ Fr warp_sums[32];
  const int64_t i = blockIdx.x;
  Fr s = fr_zero();
  for (int64_t b = threadIdx.x; b < nblk; b += ROWS_THREADS)
    s = fr_add(s, load_fr(partials, i * nblk + b));
  s = block_sum(s, warp_sums);
  if (threadIdx.x == 0) store_fr(out, i, s);
}

// out[i] = src[i] (int64) as a canonical Montgomery Fr element
__global__ void __launch_bounds__(ROWS_THREADS)
    rows_from_i64_kernel(const int64_t* __restrict__ src, int64_t n,
                         u64* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * ROWS_THREADS + threadIdx.x;
  if (i >= n) return;
  const int64_t v = src[i];
  const u64 u = v < 0 ? (u64)0 - (u64)v : (u64)v;  // |v|, also for -2^63
  Fr a = fr_zero();
  a.v[0] = (u32)u;
  a.v[1] = (u32)(u >> 32);
  Fr r2;  // R^2 mod r
  constexpr u32 R2[8] = {0xae216da7u, 0x1bb8e645u, 0xe35c59e3u, 0x53fe3ab1u,
                         0x53bb8085u, 0x8c49833du, 0x7f4e44a5u, 0x0216d0b1u};
#pragma unroll
  for (int j = 0; j < 8; ++j) r2.v[j] = R2[j];
  Fr m = fr_mul(a, r2);
  if (v < 0) m = fr_sub(fr_zero(), m);
  store_fr(out, i, m);
}

}  // namespace jolt

// out (nevals, 4 u64): the round message's points t = 0, 2, ..., nevals of
// the rows x ((P n, 4) u64 Montgomery, row p at p n; n >= 2) under the
// terms (coeffs (T, 4) u64 Montgomery; offs T + 1 int64 offsets into fidx,
// int64 row indices < P) and the weight tables in tab (rows of (4) u64:
// whi at whi_off, used when whi_n > 1; wlo at wlo_off, used when log_wlo >=
// 0). partials: (nevals * nblk, 4) u64 scratch, nblk = the blocks of
// ROWS_THREADS pairs; unused when nblk == 1. Two launches on `stream` (one
// when nblk == 1), no allocation, returns cudaGetLastError().
extern "C" int jolt_rows_points(const void* x, int64_t n, int nevals,
                                const void* coeffs, const void* offs,
                                const void* fidx, int64_t T, const void* tab,
                                int64_t whi_off, int64_t whi_n, int whi_shift,
                                int64_t wlo_off, int log_wlo, void* partials,
                                void* out, void* stream) {
  using jolt::u64;
  if (n < 2 || nevals < 1 || nevals > jolt::ROWS_MAX_EVALS || T < 0 ||
      whi_shift < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t half = n >> 1;
  const int64_t nblk = (half + jolt::ROWS_THREADS - 1) / jolt::ROWS_THREADS;
  u64* part = (u64*)(nblk == 1 ? out : partials);
  const dim3 grid((unsigned)nblk, (unsigned)nevals);
  jolt::rows_points_kernel<<<grid, jolt::ROWS_THREADS, 0,
                             (cudaStream_t)stream>>>(
      (const u64*)x, n, (const u64*)coeffs, (const int64_t*)offs,
      (const int64_t*)fidx, T, (const u64*)tab, whi_off, whi_n, whi_shift,
      wlo_off, log_wlo, part, nblk);
  if (nblk > 1) {
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    jolt::rows_sum_kernel<<<(unsigned)nevals, jolt::ROWS_THREADS, 0,
                            (cudaStream_t)stream>>>((const u64*)partials,
                                                    nblk, (u64*)out);
  }
  return (int)cudaGetLastError();
}

// out (n, 4 u64): src (n int64) as canonical Montgomery Fr elements. One
// launch on `stream`, no allocation, returns cudaGetLastError().
extern "C" int jolt_rows_from_i64(const void* src, int64_t n, void* out,
                                  void* stream) {
  using jolt::u64;
  if (n <= 0) return 0;
  const int64_t blocks = (n + jolt::ROWS_THREADS - 1) / jolt::ROWS_THREADS;
  jolt::rows_from_i64_kernel<<<(unsigned)blocks, jolt::ROWS_THREADS, 0,
                               (cudaStream_t)stream>>>(
      (const int64_t*)src, n, (u64*)out);
  return (int)cudaGetLastError();
}
