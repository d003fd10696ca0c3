// Kernel 3: Pippenger bucket combine, sum_b b * S_b for every (MSM, window).
//
// Replaces jolt_atlas_tpu/tpu/msm.py:_combine_kernel with its
// _reduce_axis1, and the top-window fold of _accum_body: on the TPU, one
// jitted program of lax.fori_loops over launch-sized Pallas adds
// (pallas_curve._add_kernel), the bucket index split as b = h * Gl + l.
// Here one block owns one (MSM, window) and each thread a contiguous range
// of its buckets, walked from high to low with the running sum T and the
// weighted sum A in registers; the range's offset is multiplied in by a
// short double-and-add, and the block adds the thread partials in shared
// memory (96 bytes a point). Like kernels 1 and 2 it is bound by integer
// multiply throughput: every step is one complete add, and the bucket sums
// are read once (3 x 32 bytes a bucket).
//
// The top window spreads each of its 2^topbits buckets over S sub-lanes
// (lane = digit * S + occurrence mod S): there, lane j has weight j / S and
// A takes T only at each bucket's lowest sub-lane, so the fold of the
// sub-lanes costs one add a lane, like any other bucket.
#include <cuda_runtime.h>

#include "fq.cuh"

namespace jolt {

constexpr int COMBINE_MAX_THREADS = 256;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ Point load_point(const u64* x, const u64* y,
                                            const u64* z, int64_t i) {
  Point p;
  p.x = load_fq(x, i);
  p.y = load_fq(y, i);
  p.z = load_fq(z, i);
  return p;
}

__global__ void __launch_bounds__(COMBINE_MAX_THREADS)
    bucket_combine_kernel(const u64* __restrict__ ax,
                          const u64* __restrict__ ay,
                          const u64* __restrict__ az, int c, int W,
                          int64_t s_top, u64* __restrict__ ox,
                          u64* __restrict__ oy, u64* __restrict__ oz) {
  __shared__ Fq sx[COMBINE_MAX_THREADS], sy[COMBINE_MAX_THREADS],
      sz[COMBINE_MAX_THREADS];
  const int nthreads = blockDim.x;
  const int t = threadIdx.x;
  const int64_t msm = blockIdx.x / W;
  const int w = blockIdx.x % W;
  const int64_t B = (int64_t)1 << c;
  const int64_t S = (w == W - 1) ? s_top : 1;  // sub-lanes per bucket
  // lanes [S, B) carry weights 1 .. B/S - 1; weight 0 (digit 0) is empty
  const int64_t chunk = (B - S + nthreads - 1) / nthreads;
  const int64_t hi = min64(S + (t + 1) * chunk, B);
  const int64_t lo = min64(S + t * chunk, hi);
  const int64_t first = (msm * W + w) * B;  // lane 0 of this window

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
  if (t == 0) {
    const int64_t o = msm * W + w;
    store_fq(ox, o, P.x);
    store_fq(oy, o, P.y);
    store_fq(oz, o, P.z);
  }
}

}  // namespace jolt

// out[m, w] = sum over buckets b of b * S_{m, w, b} for k MSMs of W windows
// of 2^c lanes each. Inputs are (k, W * 2^c, 4) u64 Montgomery limbs, the
// top window's buckets spread over s_top sub-lanes each; outputs (k, W, 4).
// `threads` is a power of two <= 256: the partition of the lanes and the
// order of the adds, which bucket_combine_plain follows. One block per
// (MSM, window). Launches on `stream`, allocates nothing, and returns
// cudaGetLastError() (or cudaErrorInvalidValue for a bad shape).
extern "C" int jolt_bucket_combine(const void* ax, const void* ay,
                                   const void* az, int64_t k, int c, int W,
                                   int64_t s_top, int threads, void* ox,
                                   void* oy, void* oz, void* stream) {
  using jolt::u64;
  if (k <= 0) return 0;
  if (threads <= 0 || threads > jolt::COMBINE_MAX_THREADS ||
      (threads & (threads - 1)) || c <= 0 || c > 30 || W <= 0)
    return (int)cudaErrorInvalidValue;
  jolt::bucket_combine_kernel<<<(unsigned)(k * W), threads, 0,
                                (cudaStream_t)stream>>>(
      (const u64*)ax, (const u64*)ay, (const u64*)az, c, W, s_top, (u64*)ox,
      (u64*)oy, (u64*)oz);
  return (int)cudaGetLastError();
}
