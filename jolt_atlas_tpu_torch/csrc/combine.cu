// Kernel 3: Pippenger bucket combine, sum_b b * S_b for every (MSM, window).
//
// Replaces jolt_atlas_tpu/tpu/msm.py:_combine_kernel with its
// _reduce_axis1, and the top-window fold of _accum_body: on the TPU, one
// jitted program of lax.fori_loops over launch-sized Pallas adds
// (pallas_curve._add_kernel), the bucket index split as b = h * Gl + l.
//
// Here each (MSM, window) is split over G blocks of T threads, and each of
// its G * T threads walks a contiguous range of its buckets from high to
// low with the running sum and the weighted sum in registers; the range's
// lowest weight is multiplied in by a short double-and-add, and the block
// adds its thread partials in a shared-memory tree (96 bytes a point).
// With G > 1 a second launch (bucket_combine_groups) adds the G block
// partials of each (MSM, window) in block order. G is chosen by the caller
// so that a launch has a few blocks per SM while each thread keeps a run of
// buckets. Like kernels 1 and 2 it is bound by integer multiply
// throughput: every step is one complete add (csrc/fq.cuh), and the bucket
// sums are read once (3 x 32 bytes a bucket). Tensor cores and TMA do not
// serve this work: chains of dependent 256-bit modular multiplies.
//
// The top window spreads each of its 2^topbits buckets over S sub-lanes
// (lane = digit * S + occurrence mod S): there, lane j has weight j / S and
// the weighted sum takes the running sum only at each bucket's lowest
// sub-lane, so the fold of the sub-lanes costs one add a lane, like any
// other bucket.
#include <cuda_runtime.h>

#include "fq.cuh"

// Blocks of 128 threads an SM must hold: ptxas then caps the registers at
// 65536 / (128 x 3) = 170. On an H100 (sm_90a) this kernel takes 242
// registers uncapped (2 blocks an SM), 168 at 3 blocks without spills, and
// 128 at 4 blocks with 144 bytes of spills, no faster than 3 (PERF.md).
#ifndef JOLT_COMBINE_MIN_BLOCKS
#define JOLT_COMBINE_MIN_BLOCKS 3
#endif

namespace jolt {

constexpr int COMBINE_MAX_THREADS = 128;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__global__ void __launch_bounds__(COMBINE_MAX_THREADS,
                                  JOLT_COMBINE_MIN_BLOCKS)
    bucket_combine_kernel(const u64* __restrict__ ax,
                          const u64* __restrict__ ay,
                          const u64* __restrict__ az, int c, int W, int G,
                          int64_t s_top, u64* __restrict__ ox,
                          u64* __restrict__ oy, u64* __restrict__ oz) {
  __shared__ Fq sx[COMBINE_MAX_THREADS], sy[COMBINE_MAX_THREADS],
      sz[COMBINE_MAX_THREADS];
  const int nthreads = blockDim.x;
  const int64_t u = (int64_t)(blockIdx.x % G) * nthreads + threadIdx.x;
  const int64_t mw = blockIdx.x / G;  // msm * W + window
  const int w = (int)(mw % W);
  const int64_t B = (int64_t)1 << c;
  const int64_t S = (w == W - 1) ? s_top : 1;  // sub-lanes per bucket
  // lanes [S, B) carry weights 1 .. B/S - 1; weight 0 (digit 0) is empty
  const int64_t chunk = (B - S + (int64_t)G * nthreads - 1) /
                        ((int64_t)G * nthreads);
  const int64_t hi = min64(S + (u + 1) * chunk, B);
  const int64_t lo = min64(S + u * chunk, hi);
  const int64_t first = mw * B;  // lane 0 of this window

  Point T = pp_identity();
  Point A = pp_identity();
  for (int64_t j = hi - 1; j >= lo; --j) {
    T = pp_add_dev(T, load_point(ax, ay, az, first + j));
    // A = sum over weights v in (wlo, whi] of T after all lanes >= v
    if (j % S == 0 && j / S > lo / S) A = pp_add_dev(A, T);
  }
  // the range's sum equals A + wlo * T, wlo the lowest weight in it
  const int64_t wlo = lo < hi ? lo / S : 0;
  Point R = pp_identity();
  bool started = false;
  for (int bit = c - 1; bit >= 0; --bit) {
    if (started) R = pp_add_dev(R, R);
    if ((wlo >> bit) & 1) {
      R = started ? pp_add_dev(R, T) : T;
      started = true;
    }
  }
  Point P = started ? pp_add_dev(A, R) : A;

  const int t = threadIdx.x;
  sx[t] = P.x;
  sy[t] = P.y;
  sz[t] = P.z;
  __syncthreads();
  for (int s = nthreads >> 1; s > 0; s >>= 1) {
    if (t < s) {
      Point Q;
      Q.x = sx[t + s];
      Q.y = sy[t + s];
      Q.z = sz[t + s];
      P = pp_add_dev(P, Q);
      sx[t] = P.x;
      sy[t] = P.y;
      sz[t] = P.z;
    }
    __syncthreads();
  }
  if (t == 0) store_point(ox, oy, oz, blockIdx.x, P);
}

// out[i] = part[i * G] + part[i * G + 1] + ... + part[i * G + G - 1]
__global__ void bucket_combine_groups(const u64* __restrict__ px,
                                      const u64* __restrict__ py,
                                      const u64* __restrict__ pz, int64_t n,
                                      int G, u64* __restrict__ ox,
                                      u64* __restrict__ oy,
                                      u64* __restrict__ oz) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Point acc = load_point(px, py, pz, i * G);
  for (int g = 1; g < G; ++g)
    acc = pp_add_dev(acc, load_point(px, py, pz, i * G + g));
  store_point(ox, oy, oz, i, acc);
}

}  // namespace jolt

// out[m, w] = sum over buckets b of b * S_{m, w, b} for k MSMs of W windows
// of 2^c lanes each. Inputs are (k, W * 2^c, 4) u64 Montgomery limbs, the
// top window's buckets spread over s_top sub-lanes each; outputs (k, W, 4).
// `threads` (a power of two <= 128) and `groups` (G >= 1 blocks per
// window) fix the partition of the lanes and the order of the adds, which
// bucket_combine_plain follows. With G > 1 the block partials go to
// `part` ((k * W * G, 4) u64 each, scratch) and a second launch adds them.
// Launches on `stream`, allocates nothing, and returns cudaGetLastError()
// (or cudaErrorInvalidValue for a bad shape).
extern "C" int jolt_bucket_combine(const void* ax, const void* ay,
                                   const void* az, int64_t k, int c, int W,
                                   int64_t s_top, int threads, int groups,
                                   void* px, void* py, void* pz, void* ox,
                                   void* oy, void* oz, void* stream) {
  using jolt::u64;
  if (k <= 0) return 0;
  if (threads <= 0 || threads > jolt::COMBINE_MAX_THREADS ||
      (threads & (threads - 1)) || c <= 0 || c > 30 || W <= 0 ||
      groups <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool two = groups > 1;
  jolt::bucket_combine_kernel<<<(unsigned)(k * W * groups), threads, 0, s>>>(
      (const u64*)ax, (const u64*)ay, (const u64*)az, c, W, groups, s_top,
      (u64*)(two ? px : ox), (u64*)(two ? py : oy), (u64*)(two ? pz : oz));
  int rc = (int)cudaGetLastError();
  if (rc || !two) return rc;
  const int64_t n = k * W;
  jolt::bucket_combine_groups<<<(unsigned)((n + 127) / 128), 128, 0, s>>>(
      (const u64*)px, (const u64*)py, (const u64*)pz, n, groups, (u64*)ox,
      (u64*)oy, (u64*)oz);
  return (int)cudaGetLastError();
}
