// Kernel 2: Pippenger bucket accumulation over the (lane, point) entries of
// one MSM, sorted by lane (CSR: lane starts plus signed point ids in lane
// order; device/msm.py:digit_lanes recodes the scalars into signed digits,
// so a window has 2^(c-1) lanes, and bit 31 of an entry's id is its digit's
// sign).
//
// Replaces the accumulation loop of jolt_atlas_tpu/tpu/msm.py:_accum_body
// (a lax.fori_loop that, per row of a (rows, lanes) grid, gathers one base
// per lane and runs one launch-sized Pallas complete add,
// tpu/pallas_curve.py:_add_kernel). A grid gives each thread a lane, and a
// warp then runs as long as its deepest lane over every grid row; the
// reference refuses scalars whose deepest lane passes max(64, 32 x the
// mean). Here each thread takes an equal run of `run` entries instead, so
// any depth is taken, and adds consecutive entries of one lane in
// ascending point order, the first entry of a segment taken as it is, (x :
// +-y : 1) (no add to the identity):
//
//   level 0 (bucket_accumulate_runs): the bases are affine (x, y), 64
//     bytes, and each is added with the complete mixed add (csrc/fq.cuh
//     pm_add_dev), negated on load where the entry's digit is negative; the
//     next entry's lane, id and base are fetched before the add of the
//     current one, so the gather is off the thread's dependent chain. A
//     lane that starts and ends inside the run is written to its bucket;
//     the run's first lane, when it began in an earlier run, leaves a head
//     partial, and its last lane, when it goes on past the run, a tail
//     partial;
//   level k >= 1 (bucket_accumulate_level): the head partials of level
//     k - 1 are the positions of level k, taken in chunks of `join`, each
//     lane's positions in a chunk summed in order by one thread (a thread
//     a chunk where lanes are long, else a thread a segment), with the
//     same rule and the complete projective add (pp_add_dev): a lane whose
//     positions lie inside the chunk is finished there, its bucket being
//     the tail partials of levels 0 .. k - 1 (one a level, where the lane
//     starts) plus the chunk's sum, in that order; a lane cut by the chunk
//     leaves a head partial for level k + 1 or a tail partial of level k.
//     Level 1 also writes the identity to the empty lanes.
//
// A lane of depth d so costs about log_join(d / run) launches of join adds
// on its path, and no thread adds more than max(run, join) partials a
// level, whatever the skew of the scalars. The levels are launched while
// more than one position is left, ceil(log_join(entries / run)) of them.
//
// Bound by integer multiply throughput (five Montgomery products and three
// sums of two a mixed add, csrc/fq.cuh); every thread does ~run adds,
// whatever the lane depths. The entries are read once and coalesced; the
// base gathers are random 64-byte reads that the L2 mostly serves. Tensor
// cores and TMA do not serve this work: 256-bit modular multiplies and
// gathers by index.
#include <cuda_runtime.h>

#include "fq.cuh"

namespace jolt {

// The part of lane `l`'s entries in [e0, e1), summed in acc: to its bucket
// when the lane lies inside the run, else to the run's head or tail slot.
// s0, s1 = starts[l], starts[l + 1], loaded when the lane began.
__device__ __forceinline__ void flush_segment(
    const Point& acc, int l, int64_t s0, int64_t s1, int64_t e0, int64_t e1,
    int64_t run_id, u64* hx, u64* hy, u64* hz, u64* tx, u64* ty, u64* tz,
    u64* ox, u64* oy, u64* oz) {
  if (s0 < e0)
    store_point(hx, hy, hz, run_id, acc);
  else if (s1 > e1)
    store_point(tx, ty, tz, run_id, acc);
  else
    store_point(ox, oy, oz, l, acc);
}

constexpr int32_t ID_MASK = 0x7fffffff;  // an entry's id without its sign
// Threads a block of the runs (128 registers a thread on an H100);
// scripts/msm_kernels_bench.py --plans times 128 and 512 beside it
// (PERF.md)
constexpr int ACCUM_THREADS = 256;

__global__ void bucket_accumulate_runs(
    const u64* __restrict__ bx, const u64* __restrict__ by,
    const int32_t* __restrict__ pts, const int32_t* __restrict__ lane,
    const int32_t* __restrict__ starts, int64_t L, int64_t nruns, int run,
    u64* hx, u64* hy, u64* hz, u64* tx, u64* ty, u64* tz, u64* ox, u64* oy,
    u64* oz) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= nruns) return;
  const int64_t E = starts[L];  // entries with a nonzero digit
  const int64_t e0 = r * run;
  if (e0 >= E) return;
  const int64_t e1 = e0 + run < E ? e0 + run : E;
  int l = lane[e0];
  int64_t s0 = starts[l], s1 = starts[l + 1];  // read at the flush
  int32_t id = pts[e0];
  Affine nb = load_affine(bx, by, id & ID_MASK);
  Point acc = affine_point(affine_neg_if(nb, id < 0));
  // entry e + 1's lane, id and base, fetched before entry e's add
  int nl = 0;
  if (e0 + 1 < e1) {
    nl = lane[e0 + 1];
    id = pts[e0 + 1];
    nb = load_affine(bx, by, id & ID_MASK);
  }
  for (int64_t e = e0 + 1; e < e1; ++e) {
    const int le = nl;
    const Affine B = affine_neg_if(nb, id < 0);
    if (e + 1 < e1) {
      nl = lane[e + 1];
      id = pts[e + 1];
      nb = load_affine(bx, by, id & ID_MASK);
    }
    if (le != l) {
      flush_segment(acc, l, s0, s1, e0, e1, r, hx, hy, hz, tx, ty, tz, ox,
                    oy, oz);
      l = le;
      s0 = starts[l];
      s1 = starts[l + 1];
      acc = affine_point(B);
    } else {
      acc = pm_add_dev(acc, B);
    }
  }
  flush_segment(acc, l, s0, s1, e0, e1, r, hx, hy, hz, tx, ty, tz, ox, oy,
                oz);
}

// Lane l's positions at level k: [s, e), from its entries [starts[l],
// starts[l + 1]) at level 0. Level 1's positions are runs of `run`
// entries, each later level's chunks of `join` positions of the one below;
// a lane has a position at level k for each chunk of level k - 1 after the
// one where it starts, up to the one where it ends (its head partials).
__device__ __forceinline__ void lane_range(const int32_t* __restrict__ starts,
                                           int l, int k, int run, int join,
                                           int64_t* s, int64_t* e) {
  int64_t a = starts[l], b = starts[l + 1];
  for (int i = 0; i < k; ++i) {
    const int64_t q = i ? join : run;
    a = a / q + 1;
    b = b > 0 ? (b - 1) / q + 1 : 0;
  }
  *s = a;
  *e = b;
}

// Lane l's bucket once its positions at level k lie inside one chunk and sum
// to `acc`: its tail partials of levels 0 .. k - 1, at the chunk where the
// lane starts at each level, then acc. Level i's tails are rows
// [off_i, off_i + P_{i+1}) of t*, P_1 = nruns and P_{i+1} = ceil(P_i /
// join), off_0 = 0 and off_{i+1} = off_i + P_{i+1}.
__device__ __forceinline__ Point lane_total(
    const Point& acc, const int32_t* __restrict__ starts, int l, int k,
    int run, int join, int64_t nruns, const u64* __restrict__ tx,
    const u64* __restrict__ ty, const u64* __restrict__ tz) {
  int64_t a = starts[l] / run;  // level 0: the run where the lane starts
  Point out = load_point(tx, ty, tz, a);
  int64_t off = 0, P = nruns;
  for (int i = 1; i < k; ++i) {
    a = a + 1;  // the lane's first position at level i ...
    a /= join;  // ... and its chunk
    off += P;
    P = (P + join - 1) / join;
    out = pp_add_dev(out, load_point(tx, ty, tz, off + a));
  }
  return pp_add_dev(out, acc);
}

// Level k >= 1: positions [0, P) (the head partials v* of level k - 1, a
// position p being the chunk whose first entry is p * span, span = run *
// join^(k - 1)) in chunks of `join`. A lane's positions inside chunk j (a
// segment) are summed in order: the chunk's first segment, when its lane
// began in an earlier chunk, goes to row j of the next level's heads nh*;
// its last, when the lane goes on, to row j of this level's tails nt*; a
// lane inside the chunk is finished. Positions of no lane (a chunk where a
// lane starts, or one it ended in) are skipped. `per_chunk`: a thread a
// chunk, walking its segments in turn, for long segments (a warp's threads
// all add); else a thread a position, the thread of a segment's first
// position summing it (short segments in parallel), the others returning.
// Either way no thread adds more than join partials a level.
__device__ __forceinline__ void level_flush(
    const Point& acc, int l, int64_t s, int64_t e, int64_t j, int64_t c0,
    int64_t c1, const int32_t* __restrict__ starts, int k, int run,
    int join, int64_t nruns, const u64* __restrict__ tx,
    const u64* __restrict__ ty, const u64* __restrict__ tz, u64* nhx,
    u64* nhy, u64* nhz, u64* ntx, u64* nty, u64* ntz, u64* ox, u64* oy,
    u64* oz) {
  if (s < c0)
    store_point(nhx, nhy, nhz, j, acc);
  else if (e > c1)
    store_point(ntx, nty, ntz, j, acc);
  else
    store_point(ox, oy, oz, l,
                lane_total(acc, starts, l, k, run, join, nruns, tx, ty, tz));
}

__global__ void bucket_accumulate_level(
    const int32_t* __restrict__ lane, const int32_t* __restrict__ starts,
    int64_t L, int64_t nruns, int run, int join, int k, int64_t span,
    int64_t P, int per_chunk, const u64* __restrict__ vx,
    const u64* __restrict__ vy, const u64* __restrict__ vz,
    const u64* __restrict__ tx, const u64* __restrict__ ty,
    const u64* __restrict__ tz, u64* nhx, u64* nhy, u64* nhz, u64* ntx,
    u64* nty, u64* ntz, u64* __restrict__ ox, u64* __restrict__ oy,
    u64* __restrict__ oz) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k == 1 && i < L && starts[i] == starts[i + 1])
    store_point(ox, oy, oz, i, pp_identity());
  const int64_t E = starts[L];  // entries with a nonzero digit
  if (per_chunk) {
    const int64_t c0 = i * join;
    if (c0 >= P) return;
    const int64_t c1 = c0 + join < P ? c0 + join : P;
    int l = -1;
    int64_t s = 0, e = 0;
    bool have = false;
    Point acc = pp_identity();
    for (int64_t p = c0; p <= c1; ++p) {
      const int lp = (p < c1 && p * span < E) ? lane[p * span] : -1;
      if (lp != l) {
        if (have)
          level_flush(acc, l, s, e, i, c0, c1, starts, k, run, join, nruns,
                      tx, ty, tz, nhx, nhy, nhz, ntx, nty, ntz, ox, oy, oz);
        if (lp < 0) break;
        l = lp;
        lane_range(starts, l, k, run, join, &s, &e);
        have = false;
      }
      if (p < s || p >= e) continue;
      const Point v = load_point(vx, vy, vz, p);
      acc = have ? pp_add_dev(acc, v) : v;
      have = true;
    }
    return;
  }
  if (i >= P || i * span >= E) return;
  const int l = lane[i * span];
  int64_t s, e;
  lane_range(starts, l, k, run, join, &s, &e);
  const int64_t j = i / join;
  const int64_t c0 = j * join;
  const int64_t c1 = c0 + join < P ? c0 + join : P;
  if (i < s || i >= e || i != (s > c0 ? s : c0)) return;
  const int64_t end = e < c1 ? e : c1;
  Point acc = load_point(vx, vy, vz, i);
  for (int64_t q = i + 1; q < end; ++q)
    acc = pp_add_dev(acc, load_point(vx, vy, vz, q));
  level_flush(acc, l, s, e, j, c0, c1, starts, k, run, join, nruns, tx, ty,
              tz, nhx, nhy, nhz, ntx, nty, ntz, ox, oy, oz);
}

}  // namespace jolt

// acc[l] = the sum of the bases +-base[pts[e]] over the entries e of lane l
// (lane[e] == l, e in [starts[l], starts[l + 1])), added in entry order
// within runs of `run` entries and then level by level in chunks of `join`
// partials (the header above); the identity for an empty lane. Bases are
// (N, 4) u64 Montgomery limbs of affine x and y, every base finite; outputs
// (L, 4) of projective X, Y, Z. pts and lane hold n_entries int32 (entries
// from starts[L] on are ignored), an id's bit 31 set where its base is
// negated; starts L + 1 int32. The head and tail partials of every level
// are scratch of P_1 + P_2 + ... + P_{K+1} rows x 4 u64 each (P_1 =
// ceil(n_entries / run), P_{k+1} = ceil(P_k / join), level K the last with
// P_K >= 2, or 1), device/msm.py:accumulate_levels. `per_chunk`: level 1 a
// thread a chunk (else a thread a position;
// device/msm.py:accumulate_class). `stages`: 1 the runs, 2 the levels, 3
// both; the levels read the rows of the scratch that the runs (and the
// levels before) wrote and write other rows, so a levels-only call after
// one with the runs can be repeated. 1 + K launches on `stream`; allocates
// nothing, and returns cudaGetLastError() (or cudaErrorInvalidValue for a
// bad shape).
extern "C" int jolt_bucket_accumulate(
    const void* bx, const void* by, const void* pts, const void* lane,
    const void* starts, int64_t n_entries, int64_t L, int run, int join,
    int per_chunk, int stages, void* hx, void* hy, void* hz, void* tx,
    void* ty, void* tz, void* ox, void* oy, void* oz, void* stream) {
  using jolt::u64;
  if (L <= 0) return 0;
  if (run <= 0 || join < 2 || n_entries < 0 || stages < 1 || stages > 3)
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int64_t nruns = (n_entries + run - 1) / run;
  cudaStream_t s = (cudaStream_t)stream;
  u64 *h[3] = {(u64*)hx, (u64*)hy, (u64*)hz};
  u64 *t[3] = {(u64*)tx, (u64*)ty, (u64*)tz};
  if ((stages & 1) && nruns > 0) {
    const int rt = jolt::ACCUM_THREADS;
    jolt::bucket_accumulate_runs<<<(unsigned)((nruns + rt - 1) / rt), rt, 0,
                                   s>>>(
        (const u64*)bx, (const u64*)by, (const int32_t*)pts,
        (const int32_t*)lane, (const int32_t*)starts, L, nruns, run, h[0],
        h[1], h[2], t[0], t[1], t[2], (u64*)ox, (u64*)oy, (u64*)oz);
    const int rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  if (!(stages & 2)) return 0;
  // level k reads its positions at rows [off, off + P) of the heads and
  // writes the next level's heads and its own tails at [off + P, ...).
  // The later levels take a thread a position: their positions a lane are
  // 1 / join of the level before
  int64_t P = nruns, off = 0, span = run;
  int k = 1;
  do {
    const int64_t chunks = (P + join - 1) / join;
    const int chunked = k == 1 && per_chunk;
    const int64_t m = chunked ? chunks : P;
    const int64_t n = k == 1 && L > m ? L : m;
    if (n > 0) {
      jolt::bucket_accumulate_level<<<(unsigned)((n + threads - 1) /
                                                 threads),
                                      threads, 0, s>>>(
          (const int32_t*)lane, (const int32_t*)starts, L, nruns, run, join,
          k, span, P, chunked, h[0] + 4 * off, h[1] + 4 * off,
          h[2] + 4 * off, t[0], t[1], t[2], h[0] + 4 * (off + P),
          h[1] + 4 * (off + P), h[2] + 4 * (off + P), t[0] + 4 * (off + P),
          t[1] + 4 * (off + P), t[2] + 4 * (off + P), (u64*)ox, (u64*)oy,
          (u64*)oz);
      const int rc = (int)cudaGetLastError();
      if (rc) return rc;
    }
    off += P;
    P = chunks;
    span *= join;
    ++k;
  } while (P >= 2);
  return 0;
}
