// Kernel 2: Pippenger bucket accumulation over the (lane, point) entries of
// one MSM, sorted by lane (CSR: lane starts plus point ids in lane order).
//
// Replaces the accumulation loop of jolt_atlas_tpu/tpu/msm.py:_accum_body
// (a lax.fori_loop that, per row of a (rows, lanes) grid, gathers one base
// per lane and runs one launch-sized Pallas complete add,
// tpu/pallas_curve.py:_add_kernel). A grid gives each thread a lane, and a
// warp then runs as long as its deepest lane over every grid row. Here each
// thread takes an equal run of `run` entries instead and adds consecutive
// entries of one lane in ascending point order, the first entry of a
// segment loaded as it is (no add to the identity):
//
//   pass 1 (bucket_accumulate_runs): a lane that starts and ends inside the
//     run is written to its bucket; the run's first lane, when it began in
//     an earlier run, leaves a head partial, and its last lane, when it goes
//     on past the run, a tail partial;
//   pass 2 (bucket_accumulate_join): the run in which a cut lane starts
//     adds its tail partial and the head partials of the runs it covers, in
//     run order, and writes the bucket; empty lanes get the identity.
//
// Bound by integer multiply throughput (12 Montgomery products a complete
// add, csrc/fq.cuh); every thread does ~run adds, whatever the lane depths.
// The entries are read once and coalesced; the base gathers are random
// 96-byte reads that the L2 mostly serves. Tensor cores and TMA do not
// serve this work: 256-bit modular multiplies and gathers by index.
#include <cuda_runtime.h>

#include "fq.cuh"

namespace jolt {

// The part of lane `l`'s entries in [e0, e1), summed in acc: to its bucket
// when the lane lies inside the run, else to the run's head or tail slot.
__device__ __forceinline__ void flush_segment(
    const Point& acc, int l, int64_t e0, int64_t e1, int64_t run_id,
    const int32_t* __restrict__ starts, u64* hx, u64* hy, u64* hz, u64* tx,
    u64* ty, u64* tz, u64* ox, u64* oy, u64* oz) {
  if (starts[l] < e0)
    store_point(hx, hy, hz, run_id, acc);
  else if (starts[l + 1] > e1)
    store_point(tx, ty, tz, run_id, acc);
  else
    store_point(ox, oy, oz, l, acc);
}

__global__ void bucket_accumulate_runs(
    const u64* __restrict__ bx, const u64* __restrict__ by,
    const u64* __restrict__ bz, const int32_t* __restrict__ pts,
    const int32_t* __restrict__ lane, const int32_t* __restrict__ starts,
    int64_t L, int64_t nruns, int run, u64* hx, u64* hy, u64* hz, u64* tx,
    u64* ty, u64* tz, u64* ox, u64* oy, u64* oz) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= nruns) return;
  const int64_t E = starts[L];  // entries with a nonzero digit
  const int64_t e0 = r * run;
  if (e0 >= E) return;
  const int64_t e1 = e0 + run < E ? e0 + run : E;
  int l = lane[e0];
  Point acc = load_point(bx, by, bz, pts[e0]);
  for (int64_t e = e0 + 1; e < e1; ++e) {
    const int le = lane[e];
    const Point B = load_point(bx, by, bz, pts[e]);
    if (le != l) {
      flush_segment(acc, l, e0, e1, r, starts, hx, hy, hz, tx, ty, tz, ox,
                    oy, oz);
      l = le;
      acc = B;
    } else {
      acc = pp_add_dev(acc, B);
    }
  }
  flush_segment(acc, l, e0, e1, r, starts, hx, hy, hz, tx, ty, tz, ox, oy,
                oz);
}

__global__ void bucket_accumulate_join(
    const int32_t* __restrict__ lane, const int32_t* __restrict__ starts,
    int64_t L, int64_t nruns, int run, const u64* __restrict__ hx,
    const u64* __restrict__ hy, const u64* __restrict__ hz,
    const u64* __restrict__ tx, const u64* __restrict__ ty,
    const u64* __restrict__ tz, u64* __restrict__ ox, u64* __restrict__ oy,
    u64* __restrict__ oz) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < L && starts[t] == starts[t + 1])
    store_point(ox, oy, oz, t, pp_identity());
  if (t >= nruns) return;
  const int64_t E = starts[L];
  const int64_t e0 = t * run;
  if (e0 >= E) return;
  const int64_t e1 = e0 + run < E ? e0 + run : E;
  const int l = lane[e1 - 1];
  const int64_t end = starts[l + 1];
  if (starts[l] < e0 || end <= e1) return;  // not a lane cut after this run
  Point acc = load_point(tx, ty, tz, t);
  const int64_t last = (end - 1) / run;
  for (int64_t q = t + 1; q <= last; ++q)
    acc = pp_add_dev(acc, load_point(hx, hy, hz, q));
  store_point(ox, oy, oz, l, acc);
}

}  // namespace jolt

// acc[l] = the sum of the bases base[pts[e]] over the entries e of lane l
// (lane[e] == l, e in [starts[l], starts[l + 1])), added in entry order
// within runs of `run` entries and then across runs; the identity for an
// empty lane. Bases and outputs are (N, 4) / (L, 4) u64 Montgomery limbs;
// pts and lane hold n_entries int32 (entries from starts[L] on are
// ignored), starts L + 1 int32. The head and tail partials are
// ceil(n_entries / run) x 4 u64 each, scratch. Two launches on `stream`;
// allocates nothing, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a bad shape).
extern "C" int jolt_bucket_accumulate(
    const void* bx, const void* by, const void* bz, const void* pts,
    const void* lane, const void* starts, int64_t n_entries, int64_t L,
    int run, void* hx, void* hy, void* hz, void* tx, void* ty, void* tz,
    void* ox, void* oy, void* oz, void* stream) {
  using jolt::u64;
  if (L <= 0) return 0;
  if (run <= 0 || n_entries < 0) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int64_t nruns = (n_entries + run - 1) / run;
  cudaStream_t s = (cudaStream_t)stream;
  if (nruns > 0) {
    jolt::bucket_accumulate_runs<<<(unsigned)((nruns + threads - 1) /
                                              threads),
                                   threads, 0, s>>>(
        (const u64*)bx, (const u64*)by, (const u64*)bz, (const int32_t*)pts,
        (const int32_t*)lane, (const int32_t*)starts, L, nruns, run,
        (u64*)hx, (u64*)hy, (u64*)hz, (u64*)tx, (u64*)ty, (u64*)tz,
        (u64*)ox, (u64*)oy, (u64*)oz);
    const int rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  const int64_t n2 = nruns > L ? nruns : L;
  jolt::bucket_accumulate_join<<<(unsigned)((n2 + threads - 1) / threads),
                                 threads, 0, s>>>(
      (const int32_t*)lane, (const int32_t*)starts, L, nruns, run,
      (const u64*)hx, (const u64*)hy, (const u64*)hz, (const u64*)tx,
      (const u64*)ty, (const u64*)tz, (u64*)ox, (u64*)oy, (u64*)oz);
  return (int)cudaGetLastError();
}
