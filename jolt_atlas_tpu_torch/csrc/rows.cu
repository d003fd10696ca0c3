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
// layout kernel 4 binds as P lanes). Bound by IMAD throughput: per pair and
// point, the term products, the coefficient products and the weight's.
// The design (device/rows.py:points_plan sizes it from P, the terms and the
// points at each launch):
//
// - A block takes a tile of `tile` pairs (a power of two >= 32) and a group
//   of `group` consecutive points. It stages every row's tile of lo and hi
//   into shared memory with cp.async, one contiguous span a row and half,
//   then turns them into d = hi - lo and e = the row at the group's first
//   point (lo, or hi + (t - 1) d by doubling). Each later point costs one
//   Fr add a row and pair (e += d; twice from t = 0 to t = 2), as the host
//   and the plain version (rows.py:term_sums) do: a row is evaluated once a
//   point, never once a factor. Shared rows are split into two planes of
//   16-byte halves, so a warp's 16-byte loads of 32 neighbouring pairs are
//   conflict-free.
// - Fewer products than one chain a term: the host groups the terms that
//   share a head (all of a term's factors but one, the most shared first;
//   rows.py:group_terms), and a group costs the head's chain once and one
//   product by its members' sum (the bench's 36-term class: two 5-factor
//   heads of 9 terms each, 42 products a pair and point instead of 122).
// - The groups, split where one would outweigh a slice, are dealt into
//   `slices` (balanced by their work on the host, Terms); a thread takes
//   one (slice, pair), a warp 32 pairs of one slice, so a warp runs one
//   part list. A product chain stops at a zero factor and a coefficient of
//   one is not multiplied, as on the host.
//   The slices' sums of a pair meet in shared memory, where the first
//   slice's threads add them, multiply by w(j) once (computed once a block)
//   and sum their warp's pairs by shuffles.
// - One launch a round: each block writes one canonical partial a point of
//   its group; the last block to finish (a ticket: an atomic counter that
//   the last block resets to 0 for the next launch) adds every block's
//   partials into out. Field sums are exact, so the order is free and the
//   plain version need not follow the partition. Launches that share a
//   counter must run in order (one stream).
//
// Kernel 8, rows_from_i64: most of the IOP's rows are small integers
// (witness values, chunks, indicators). The reference converts every row
// to Montgomery form on the host and sends 32 bytes an element
// (shardedrows.py:303, p.to_field()); here such a row goes up as int64, 8
// bytes an element, and the card forms v R mod r. The function needs far
// less than a Montgomery product by R^2 (608 SASS instructions for a value
// of two nonzero words): with C = 2^320 mod r, two CIOS steps over the two
// 32-bit words of |v| (a row of |v|_i C and one of m r each, 66 IMAD)
// leave |v| C / 2^64 = |v| R mod r below 2r, so one conditional
// subtraction makes it canonical, and r - x negates it where v < 0
// (fr_from_u64, kept here: only this kernel converts integers). That
// leaves the kernel bound by its 40 bytes an element. A thread takes one
// element (an 8-byte load, two 16-byte stores) and a grid sized from the
// card's SMs strides over them: on an H100 and the bench's 442,368 values
// (scripts/rows_points_bench.py --i64-variants), two elements a thread
// (one 16-byte load, a warp's stores spread over twice the lines) took
// 1.8x as long, four 2.8x.
#include <cuda_runtime.h>

#include "fq.cuh"

namespace jolt {

constexpr int ROWS_I64_THREADS = 256;  // kernel 8
constexpr int ROWS_MAX_EVALS = 20;  // frvec GruenInstance.MAXE
constexpr int ROWS_MAX_P = 96;      // frvec GruenInstance.MAXP
constexpr int ROWS_MAX_SLICES = 16;
constexpr int ROWS_MAX_BLOCK = 512;  // tile x slices
constexpr int ROWS_SMEM_MAX = 232448 - 2048;  // 227 KB less the static part

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

// 16-byte global -> shared copy in flight; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::
                   : "memory");
}

// a shared row of `tile` Fr elements in two planes: limbs 0-3 of element p
// at row[p], limbs 4-7 at row[tile + p]
__device__ __forceinline__ Fr lds_fr(const uint4* row, int p, int tile) {
  const uint4 lo = row[p], hi = row[tile + p];
  Fr r;
  r.v[0] = lo.x;
  r.v[1] = lo.y;
  r.v[2] = lo.z;
  r.v[3] = lo.w;
  r.v[4] = hi.x;
  r.v[5] = hi.y;
  r.v[6] = hi.z;
  r.v[7] = hi.w;
  return r;
}

__device__ __forceinline__ void sts_fr(uint4* row, int p, int tile,
                                       const Fr& a) {
  row[p] = make_uint4(a.v[0], a.v[1], a.v[2], a.v[3]);
  row[tile + p] = make_uint4(a.v[4], a.v[5], a.v[6], a.v[7]);
}

// shared bytes of a launch: e and d of P rows, w, the slices' sums (rows of
// `tile`), and one sum a point of the group and warp of the first slice
__host__ __device__ inline int64_t rows_points_smem(int P, int slices,
                                                    int tile, int group) {
  return (int64_t)(2 * P + 1 + slices) * tile * 32 +
         (int64_t)group * (tile / 32) * 32;
}

// gridDim = (tiles, point groups); blockDim = tile x slices.
// partials[i * tiles + b]: tile b's sum at point i.
__global__ void __launch_bounds__(ROWS_MAX_BLOCK)
    rows_points_kernel(const u64* __restrict__ x, int64_t n, int P,
                       int nevals, const u64* __restrict__ coeffs,
                       const int64_t* __restrict__ parts,
                       const int64_t* __restrict__ members,
                       const int64_t* __restrict__ fidx,
                       const int64_t* __restrict__ bounds, int slices,
                       const u64* __restrict__ tab, int64_t whi_off,
                       int64_t whi_n, int whi_shift, int64_t wlo_off,
                       int log_wlo, int log_tile, int group, u64* partials,
                       unsigned* counter, u64* __restrict__ out) {
  extern __shared__ uint4 sm[];
  __shared__ Fr warp_sums[32];
  __shared__ bool last;
  const int tile = 1 << log_tile;
  const int rowq = 2 * tile;  // uint4s a shared row
  uint4* E = sm;              // P rows: the rows at the current point
  uint4* D = E + P * rowq;    // P rows: hi - lo
  uint4* W = D + P * rowq;    // one row: w(j)
  uint4* RED = W + rowq;      // `slices` rows: each slice's sum
  uint4* WS = RED + slices * rowq;  // group x warps of the first slice,
                                    // an element in 2 consecutive uint4s
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int64_t half = n >> 1;
  const int64_t tiles = gridDim.x;
  const int64_t j0 = (int64_t)blockIdx.x << log_tile;
  const int i0 = blockIdx.y * group;
  const int gn = min(group, nevals - i0);
  const int nw = tile >> 5;

  // -- stage lo into E and hi into D: a warp copies 512 contiguous bytes
  // of a row (16 pairs) into the two planes
  for (int c = tid; c < P * rowq; c += nthr) {
    const int f = c >> (log_tile + 1), q = c & (rowq - 1);
    const int p = q >> 1, h = q & 1;
    const int64_t j = j0 + p;
    const bool ok = j < half;
    const u64* src = x + 4 * ((int64_t)f * n + (ok ? j : 0)) + 2 * h;
    const int dst = f * rowq + h * tile + p;
    cp_async16(E + dst, src, ok ? 16 : 0);
    cp_async16(D + dst, src + 4 * half, ok ? 16 : 0);
  }
  cp_async_wait_all();
  __syncthreads();
  // -- e at the group's first point t0: lo, or hi + (t0 - 1) d
  const int t0 = i0 ? i0 + 1 : 0;
  const int m = t0 > 1 ? t0 - 1 : 1, top = 31 - __clz(m);
  for (int c = tid; c < P * tile; c += nthr) {
    uint4* er = E + (c >> log_tile) * rowq;
    uint4* dr = D + (c >> log_tile) * rowq;
    const int p = c & (tile - 1);
    const Fr lo = lds_fr(er, p, tile), hi = lds_fr(dr, p, tile);
    const Fr d = fr_sub(hi, lo);
    if (t0) {
      Fr md = d;  // m d by doubling and adding, from m's top bit down
      for (int b = top - 1; b >= 0; --b) {
        md = fr_add(md, md);
        if ((m >> b) & 1) md = fr_add(md, d);
      }
      sts_fr(er, p, tile, fr_add(hi, md));
    }
    sts_fr(dr, p, tile, d);
  }
  const int p = tid & (tile - 1), s = tid >> log_tile;
  const int64_t j = j0 + p;
  const bool active = j < half;
  const bool lo_w = log_wlo >= 0, hi_w = whi_n > 1;
  if (s == 0 && (lo_w || hi_w)) {
    Fr w = fr_zero();
    if (active) {
      if (lo_w) w = load_fr(tab, wlo_off + (j & (((int64_t)1 << log_wlo) - 1)));
      if (hi_w) {
        const int sh = whi_shift < 63 ? whi_shift : 63;
        const Fr h = load_fr(tab, whi_off + ((j >> sh) & (whi_n - 1)));
        w = lo_w ? fr_mul(w, h) : h;
      }
    }
    sts_fr(W, p, tile, w);
  }
  __syncthreads();

  const int64_t ka = bounds[s], kb = bounds[s + 1];
  for (int g = 0; g < gn; ++g) {
    if (g) {  // the next point: e += d (from t = 0 to t = 2, twice)
      const bool twice = i0 + g == 1;
      for (int c = tid; c < P * tile; c += nthr) {
        uint4* er = E + (c >> log_tile) * rowq;
        const int q = c & (tile - 1);
        const Fr d = lds_fr(D + (c >> log_tile) * rowq, q, tile);
        Fr e = fr_add(lds_fr(er, q, tile), d);
        if (twice) e = fr_add(e, d);
        sts_fr(er, q, tile, e);
      }
      __syncthreads();
    }
    Fr v = fr_zero();
    for (int64_t q = ka; q < kb && active; ++q) {
      const int64_t ha = parts[4 * q], hb = parts[4 * q + 1];
      const int64_t ma = parts[4 * q + 2], mb = parts[4 * q + 3];
      Fr h;
      if (hb > ha) {  // the head's product
        h = lds_fr(E + fidx[ha] * rowq, p, tile);
        for (int64_t f = ha + 1; f < hb && !fr_is_zero(h); ++f)
          h = fr_mul(h, lds_fr(E + fidx[f] * rowq, p, tile));
        if (fr_is_zero(h)) continue;
      }
      Fr in = fr_zero();  // the members' sum
      for (int64_t k = ma; k < mb; ++k) {
        const int64_t a = members[2 * k], b = members[2 * k + 1];
        const Fr c = load_fr(coeffs, k);
        if (a == b) {  // the head alone, or a constant term
          in = fr_add(in, c);
          continue;
        }
        Fr prod = lds_fr(E + fidx[a] * rowq, p, tile);
        for (int64_t f = a + 1; f < b && !fr_is_zero(prod); ++f)
          prod = fr_mul(prod, lds_fr(E + fidx[f] * rowq, p, tile));
        if (fr_is_zero(prod)) continue;
        if (!fr_is_one(c)) prod = fr_mul(prod, c);
        in = fr_add(in, prod);
      }
      if (hb > ha) {
        if (!fr_is_zero(in)) v = fr_add(v, fr_mul(h, in));
      } else {
        v = fr_add(v, in);
      }
    }
    sts_fr(RED + s * rowq, p, tile, v);
    __syncthreads();  // also: every thread is done reading e at this point
    if (s == 0) {  // the first slice's warps: slices, weight, warp sum
      for (int q = 1; q < slices; ++q)
        v = fr_add(v, lds_fr(RED + q * rowq, p, tile));
      if ((lo_w || hi_w) && !fr_is_zero(v)) v = fr_mul(v, lds_fr(W, p, tile));
#pragma unroll
      for (int dd = 16; dd > 0; dd >>= 1) v = fr_add(v, fr_shfl_down(v, dd));
      if ((tid & 31) == 0) sts_fr(WS + 2 * (g * nw + (tid >> 5)), 0, 1, v);
    }
  }
  __syncthreads();
  if (tid < gn) {  // the block's partial at point i0 + tid
    Fr b = fr_zero();
    for (int w = 0; w < nw; ++w)
      b = fr_add(b, lds_fr(WS + 2 * (tid * nw + w), 0, 1));
    store_fr(partials, (int64_t)(i0 + tid) * tiles + blockIdx.x, b);
  }
  // -- the last block adds every block's partials
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(counter, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = 0; i < nevals; ++i) {
    Fr t = fr_zero();
    for (int64_t b = tid; b < tiles; b += nthr)
      t = fr_add(t, ldcg_fr(partials, i * tiles + b));
    t = block_sum(t, warp_sums);
    if (tid == 0) store_fr(out, i, t);
  }
  if (tid == 0) *counter = 0;
}

// |v| R mod r, canonical, for |v| = u < 2^64: two CIOS steps over u's
// words by C = 2^320 mod r. After each step t < 2r (u_i C + m r < 2^33
// r), so t[8] = 0; after the second t = u C / 2^64 = u R (mod r).
__device__ __forceinline__ Fr fr_from_u64(u64 u) {
  constexpr u32 C[8] = {0x7c5fb586u, 0xb4c6edf9u, 0xbfeb93beu, 0x708c8d50u,
                        0x04f7e0efu, 0x9ffd1de4u, 0x9a392866u, 0x215b02acu};
  u32 c[8], p[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c[j] = C[j];
    p[j] = FrField::p(j);
  }
  u32 t[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mad_row(t, c, (u32)(u >> (32 * i)));
    const u32 m = t[0] * FrField::N0;
    mad_row(t, p, m);
#pragma unroll
    for (int j = 0; j < 9; ++j) t[j] = t[j + 1];
    t[9] = 0;
  }
  Fr r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = t[j];
  mont_cond_sub<FrField>(r, 0);
  return r;
}

// v as a canonical Montgomery Fr element: |v| R mod r, then r - x where
// v < 0 (x != 0 there; -2^63's two's complement bits are |v|)
__device__ __forceinline__ Fr fr_from_i64(int64_t v) {
  const Fr x = fr_from_u64(v < 0 ? (u64)0 - (u64)v : (u64)v);
  return v < 0 ? mont_neg_raw<FrField>(x) : x;
}

// out[i] = src[i] (int64) as a canonical Montgomery Fr element, a thread
// an element, striding over the grid
__global__ void __launch_bounds__(ROWS_I64_THREADS)
    rows_from_i64_kernel(const int64_t* __restrict__ src, int64_t n,
                         u64* __restrict__ out) {
  for (int64_t i = (int64_t)blockIdx.x * ROWS_I64_THREADS + threadIdx.x;
       i < n; i += (int64_t)gridDim.x * ROWS_I64_THREADS)
    store_fr(out, i, fr_from_i64(src[i]));
}

}  // namespace jolt

// out (nevals, 4 u64): the round message's points t = 0, 2, ..., nevals of
// the P rows x ((P n, 4) u64 Montgomery, row p at p n; n >= 2) under the
// terms as parts (device/rows.py:Terms): parts (parts, 4) int64 [ha, hb,
// ma, mb], the head's factors fidx[ha .. hb) and the members ma .. mb;
// members (T, 2) int64 [ta, tb], a member's tail factors fidx[ta .. tb),
// its coefficient coeffs[k] ((T, 4) u64 Montgomery); fidx int64 row
// indices < P; bounds slices + 1 int64: slice s takes parts bounds[s] ..
// bounds[s + 1]. The weight tables are in tab (rows of (4) u64: whi at
// whi_off, used when whi_n > 1; wlo at wlo_off, used when log_wlo >= 0).
// tile: pairs a block, a power of two >= 32; group: points a block.
// partials: (nevals * tiles, 4) u64 scratch, tiles = ceil(n / 2 / tile);
// counter: one u32, 0 before the launch and after it. One launch on
// `stream`, no allocation, returns cudaGetLastError().
extern "C" int jolt_rows_points(const void* x, int64_t n, int P, int nevals,
                                const void* coeffs, const void* parts,
                                const void* members, const void* fidx,
                                const void* bounds, int slices,
                                const void* tab, int64_t whi_off,
                                int64_t whi_n, int whi_shift, int64_t wlo_off,
                                int log_wlo, int tile, int group,
                                void* partials, void* counter, void* out,
                                void* stream) {
  using jolt::u64;
  const int log_tile = tile > 0 ? 31 - __builtin_clz((unsigned)tile) : 0;
  if (n < 2 || nevals < 1 || nevals > jolt::ROWS_MAX_EVALS || P < 1 ||
      P > jolt::ROWS_MAX_P || slices < 1 || slices > jolt::ROWS_MAX_SLICES ||
      tile < 32 || tile != 1 << log_tile ||
      tile * slices > jolt::ROWS_MAX_BLOCK || group < 1 || group > nevals ||
      whi_shift < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t smem = jolt::rows_points_smem(P, slices, tile, group);
  if (smem > jolt::ROWS_SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int rc = (int)cudaFuncSetAttribute(
      jolt::rows_points_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (rc != 0) return rc;
  const int64_t tiles = ((n >> 1) + tile - 1) / tile;
  const dim3 grid((unsigned)tiles, (unsigned)((nevals + group - 1) / group));
  jolt::rows_points_kernel<<<grid, tile * slices, (size_t)smem,
                             (cudaStream_t)stream>>>(
      (const u64*)x, n, P, nevals, (const u64*)coeffs, (const int64_t*)parts,
      (const int64_t*)members, (const int64_t*)fidx, (const int64_t*)bounds,
      slices, (const u64*)tab,
      whi_off, whi_n, whi_shift, wlo_off, log_wlo, log_tile, group,
      (u64*)partials, (unsigned*)counter, (u64*)out);
  return (int)cudaGetLastError();
}

// out (n, 4 u64): src (n int64) as canonical Montgomery Fr elements. One
// launch on `stream` of enough blocks for n threads, at most as many as
// the card's SMs hold at once (2048 threads an SM); no allocation,
// returns cudaGetLastError().
extern "C" int jolt_rows_from_i64(const void* src, int64_t n, void* out,
                                  void* stream) {
  using jolt::ROWS_I64_THREADS;
  if (n <= 0) return 0;
  int dev = 0, sms = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc == 0)
    rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
  if (rc != 0) return rc;
  const int64_t need = (n + ROWS_I64_THREADS - 1) / ROWS_I64_THREADS;
  const int64_t most = (int64_t)sms * (2048 / ROWS_I64_THREADS);
  jolt::rows_from_i64_kernel<<<(unsigned)(need < most ? need : most),
                               ROWS_I64_THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t*)src, n, (jolt::u64*)out);
  return (int)cudaGetLastError();
}
