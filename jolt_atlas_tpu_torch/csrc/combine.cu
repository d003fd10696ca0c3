// Kernel 3: Pippenger bucket combine and window fold: for every MSM,
// sum_w 2^(c w) sum_j weight(j) S_{w, j}, one projective point an MSM.
//
// Replaces jolt_atlas_tpu/tpu/msm.py:_combine_kernel with its
// _reduce_axis1, the top-window fold of _accum_body, and the host Horner
// over the window sums (tpu/msm.py:_combine_windows): on the TPU, one
// jitted program of lax.fori_loops over launch-sized Pallas adds
// (pallas_curve._add_kernel), the bucket index split as b = h * Gl + l, and
// then a Python loop of Jacobian doublings and adds on the host.
//
// The digits are signed (device/msm.py:digit_lanes): a window has B =
// 2^(c-1) lanes, lane j of weight j + 1 (|digit| - 1). The top window
// spreads each of its buckets over S sub-lanes (lane = (digit - 1) * S +
// occurrence mod S), so that there lane j has weight j / S + 1.
//
// Each (MSM, window) is split over G blocks of T threads, G and T powers of
// two, and thread u = b T + t walks the lanes [u q, u q + q) (q = chunk, a
// power of two) from high to low with a running sum T_u and a weighted sum
// A_u whose weights count from the range's lowest bucket: A_u = sum_j (j /
// S - lo_u / S) S_j. The range's sum is A_u + kappa_u T_u, kappa_u = u q /
// S + 1. By Abel summation over the threads of a block (kappa grows by
// sigma = max(1, q / S) at each thread t with t q = 0 mod S, else by 0),
// the block's sum is
//   P_b + kappa_{bT} Z_b,  P_b = sum_t A_t + sigma sum_{t >= 1, t q = 0
//   mod S} Zs_t,  Z_b = Zs_0,
// Zs_t = sum_{t' >= t} T_t' a suffix sum, taken in shared memory
// (combine_tail: log2 T levels of adds, two trees of log2 T levels, and
// log2 sigma doublings by thread 0). The G blocks of a window are the same
// sum one level up (q = T chunk): bucket_combine_groups, a block a window
// and a thread a block, gives the window's sum P + Z; with G = 1 the fold
// adds P_0 + Z_0 itself. No thread multiplies by its range's weight.
//
// bucket_combine_fold then folds each MSM's W window sums, sum_w 2^(c w)
// R_w: a block an MSM and a thread a window, which doubles its sum c w
// times (complete doublings, pp_double_dev), then a halving tree of adds;
// all MSMs of the launch at once. The top window's chain of (W - 1) c
// doublings is serial, a few milliseconds whatever the batch (a thread's
// dependent 256-bit products); the host then only converts each MSM's
// point to affine (one inversion).
//
// Like kernels 1 and 2 the walk is bound by integer multiply throughput:
// every step is one complete add (csrc/fq.cuh), and the bucket sums are
// read once (3 x 32 bytes a bucket). Tensor cores and TMA do not serve this
// work: chains of dependent 256-bit modular multiplies.
#include <cuda_runtime.h>

#include "fq.cuh"

// Blocks of 128 threads an SM must hold: ptxas then caps the registers at
// 65536 / (128 x 3) = 170 (PERF.md).
#ifndef JOLT_COMBINE_MIN_BLOCKS
#define JOLT_COMBINE_MIN_BLOCKS 3
#endif

namespace jolt {

constexpr int COMBINE_MAX_THREADS = 128;

// The block's n = blockDim.x threads hold their (A_t, T_t) in (A, Z); s1,
// s2 are n points of shared memory each. Returns with thread 0 holding, in
// A, sum_t A_t + sigma sum_{t >= 1, t q = 0 mod S} Zs_t (sigma = max(1, q /
// S)) and, in Z, Zs_0 = sum_t T_t (Zs_t = sum_{t' >= t} T_t'). The order of
// the adds is bucket_combine_plain's (device/msm.py:_combine_tail).
__device__ __forceinline__ void combine_tail(Point& A, Point& Z, int64_t q,
                                             int64_t S, Point* s1,
                                             Point* s2) {
  const int t = threadIdx.x, n = blockDim.x;
  s1[t] = Z;
  __syncthreads();
  for (int d = 1; d < n; d <<= 1) {  // suffix sums, Hillis-Steele
    const bool has = t + d < n;
    Point o;
    if (has) o = s1[t + d];
    __syncthreads();
    if (has) {
      Z = pp_add_dev(Z, o);
      s1[t] = Z;
    }
    __syncthreads();
  }
  Point E = (t >= 1 && ((int64_t)t * q) % S == 0) ? Z : pp_identity();
  s1[t] = A;
  s2[t] = E;
  __syncthreads();
  for (int s = n >> 1; s > 0; s >>= 1) {
    if (t < s) {
      A = pp_add_dev(A, s1[t + s]);
      E = pp_add_dev(E, s2[t + s]);
      s1[t] = A;
      s2[t] = E;
    }
    __syncthreads();
  }
  if (t == 0) {
    for (int64_t sigma = q / S; sigma > 1; sigma >>= 1) E = pp_double_dev(E);
    A = pp_add_dev(A, E);
  }
}

__global__ void __launch_bounds__(COMBINE_MAX_THREADS,
                                  JOLT_COMBINE_MIN_BLOCKS)
    bucket_combine_kernel(const u64* __restrict__ ax,
                          const u64* __restrict__ ay,
                          const u64* __restrict__ az, int64_t B, int W,
                          int G, int64_t s_top, int64_t chunk,
                          u64* __restrict__ px, u64* __restrict__ py,
                          u64* __restrict__ pz, u64* __restrict__ zx,
                          u64* __restrict__ zy, u64* __restrict__ zz) {
  __shared__ Point s1[COMBINE_MAX_THREADS], s2[COMBINE_MAX_THREADS];
  const int64_t u = (int64_t)(blockIdx.x % G) * blockDim.x + threadIdx.x;
  const int64_t mw = blockIdx.x / G;  // msm * W + window
  const int64_t S = ((int)(mw % W) == W - 1) ? s_top : 1;
  const int64_t lo = u * chunk < B ? u * chunk : B;
  const int64_t hi = lo + chunk < B ? lo + chunk : B;
  const int64_t first = mw * B;  // lane 0 of this window
  const int64_t wlo = lo / S;

  // the first lane taken as it is, and the first weighted add a copy
  Point T = pp_identity(), A = pp_identity();
  bool hT = false, hA = false;
  for (int64_t j = hi - 1; j >= lo; --j) {
    const Point P = load_point(ax, ay, az, first + j);
    T = hT ? pp_add_dev(T, P) : P;
    hT = true;
    // A = sum over the bucket starts above lo's bucket of T there
    if (j % S == 0 && j / S > wlo) {
      A = hA ? pp_add_dev(A, T) : T;
      hA = true;
    }
  }
  combine_tail(A, T, chunk, S, s1, s2);
  if (threadIdx.x == 0) {
    store_point(px, py, pz, blockIdx.x, A);
    store_point(zx, zy, zz, blockIdx.x, T);
  }
}

// A block a (MSM, window), a thread a block b of it (G threads): the
// window's sum P + Z by combine_tail over the blocks' (P_b, Z_b), q = T
// chunk lanes a block, into r[mw].
__global__ void __launch_bounds__(COMBINE_MAX_THREADS)
    bucket_combine_groups(const u64* __restrict__ px,
                          const u64* __restrict__ py,
                          const u64* __restrict__ pz,
                          const u64* __restrict__ zx,
                          const u64* __restrict__ zy,
                          const u64* __restrict__ zz, int W, int64_t s_top,
                          int64_t q, u64* __restrict__ rx,
                          u64* __restrict__ ry, u64* __restrict__ rz) {
  __shared__ Point s1[COMBINE_MAX_THREADS], s2[COMBINE_MAX_THREADS];
  const int64_t mw = blockIdx.x;
  const int64_t S = ((int)(mw % W) == W - 1) ? s_top : 1;
  const int64_t i = mw * blockDim.x + threadIdx.x;
  Point A = load_point(px, py, pz, i);
  Point Z = load_point(zx, zy, zz, i);
  combine_tail(A, Z, q, S, s1, s2);
  if (threadIdx.x == 0) store_point(rx, ry, rz, mw, pp_add_dev(A, Z));
}

// R_w of MSM m: r[m W + w], or P + Z of the window's one block (pairs: G =
// 1)
__device__ __forceinline__ Point window_sum(const u64* rx, const u64* ry,
                                            const u64* rz, const u64* zx,
                                            const u64* zy, const u64* zz,
                                            bool pairs, int64_t i) {
  const Point R = load_point(rx, ry, rz, i);
  return pairs ? pp_add_dev(R, load_point(zx, zy, zz, i)) : R;
}

// A block an MSM m, a thread a window w (blockDim.x the power of two at or
// above W): R_w doubled c w times, then the block's halving tree of the
// 2^(c w) R_w (the identity past W), sum_w 2^(c w) R_w into out[m]. The
// top window's c (W - 1) doublings are the chain; no add waits in it.
__global__ void __launch_bounds__(COMBINE_MAX_THREADS)
    bucket_combine_fold(const u64* __restrict__ rx,
                        const u64* __restrict__ ry,
                        const u64* __restrict__ rz,
                        const u64* __restrict__ zx,
                        const u64* __restrict__ zy,
                        const u64* __restrict__ zz, int pairs, int W, int c,
                        u64* __restrict__ ox, u64* __restrict__ oy,
                        u64* __restrict__ oz) {
  __shared__ Point s1[COMBINE_MAX_THREADS];
  const int64_t m = blockIdx.x;
  const int w = threadIdx.x;
  Point R = pp_identity();
  if (w < W) {
    R = window_sum(rx, ry, rz, zx, zy, zz, pairs, m * W + w);
    for (int i = 0; i < c * w; ++i) R = pp_double_dev(R);
  }
  s1[w] = R;
  __syncthreads();
  for (int s = blockDim.x >> 1; s > 0; s >>= 1) {
    if (w < s) {
      R = pp_add_dev(R, s1[w + s]);
      s1[w] = R;
    }
    __syncthreads();
  }
  if (w == 0) store_point(ox, oy, oz, m, R);
}

}  // namespace jolt

// out[m] = sum_w 2^(c w) sum_j weight(j) S_{m, w, j} for k MSMs of W windows
// of B = 2^(c-1) lanes each (weight(j) = j / S + 1, S = s_top in the top
// window, else 1). Inputs are (k, W * B, 4) u64 Montgomery limbs of
// projective X, Y, Z; outputs (k, 4). `threads` (a power of two <= 128) and
// `groups` (G, a power of two <= 128) fix the partition of the lanes (a
// thread walks chunk = max(1, B / (G threads)) of them) and the order of
// the adds, which bucket_combine_plain follows. Scratch: p* and z* (k * W *
// G, 4) u64 each, the blocks' partials, and r* (k * W, 4) each, the window
// sums when G > 1. Two launches (G = 1) or three, on `stream`; allocates
// nothing, and returns cudaGetLastError() (or cudaErrorInvalidValue for a
// bad shape).
extern "C" int jolt_bucket_combine(const void* ax, const void* ay,
                                   const void* az, int64_t k, int c, int W,
                                   int64_t s_top, int threads, int groups,
                                   void* px, void* py, void* pz, void* zx,
                                   void* zy, void* zz, void* rx, void* ry,
                                   void* rz, void* ox, void* oy, void* oz,
                                   void* stream) {
  using jolt::u64;
  if (k <= 0) return 0;
  const auto pow2 = [](int64_t v) { return v > 0 && !(v & (v - 1)); };
  if (!pow2(threads) || threads > jolt::COMBINE_MAX_THREADS ||
      !pow2(groups) || groups > jolt::COMBINE_MAX_THREADS || c < 2 ||
      c > 30 || W <= 0 || W > jolt::COMBINE_MAX_THREADS || !pow2(s_top))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t B = (int64_t)1 << (c - 1);
  const int64_t span = (int64_t)groups * threads;
  const int64_t chunk = span < B ? B / span : 1;
  jolt::bucket_combine_kernel<<<(unsigned)(k * W * groups), threads, 0, s>>>(
      (const u64*)ax, (const u64*)ay, (const u64*)az, B, W, groups, s_top,
      chunk, (u64*)px, (u64*)py, (u64*)pz, (u64*)zx, (u64*)zy, (u64*)zz);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const bool pairs = groups == 1;
  if (!pairs) {
    jolt::bucket_combine_groups<<<(unsigned)(k * W), groups, 0, s>>>(
        (const u64*)px, (const u64*)py, (const u64*)pz, (const u64*)zx,
        (const u64*)zy, (const u64*)zz, W, s_top, threads * chunk,
        (u64*)rx, (u64*)ry, (u64*)rz);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  int wide = 1;
  while (wide < W) wide <<= 1;
  jolt::bucket_combine_fold<<<(unsigned)k, wide, 0, s>>>(
      (const u64*)(pairs ? px : rx), (const u64*)(pairs ? py : ry),
      (const u64*)(pairs ? pz : rz), (const u64*)zx, (const u64*)zy,
      (const u64*)zz, pairs, W, c, (u64*)ox, (u64*)oy, (u64*)oz);
  return (int)cudaGetLastError();
}
