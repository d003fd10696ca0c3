// Kernels 4-6: the rounds of the batched opening reduction on the card, and
// a test kernel for the device transcript.
//
// Replace the three XLA programs of jolt_atlas_tpu/tpu/reduction.py:
// _bind_kernel (kernel 4), _q0_kernel (kernel 5) and _tail_kernel (kernel
// 6, with tpu/blake2b.py inside it). The reduction is a batched sumcheck
// over ~10^2 degree-2 instances, one per opening point, each a polynomial
// of 2^nr Fr elements bound high-to-low; instance k joins at round
// max_rounds - nr_k. Every joined instance is a *lane*. Lanes are numbered
// in join order, so at round r the joined lanes are 0 .. J_r - 1 and each
// holds 2^(max_rounds - r) elements: the working buffer is J_r segments of
// one size, lane s at s * 2^lg. A thread finds its lane by a shift, so no
// per-element index array is built or uploaded (the reference uploads four
// n-entry int32 arrays a round).
//
// - kernel 4, bind: buf'[s, j] = lo + c (hi - lo) with lo = buf[s, j], hi =
//   buf[s, j + 2^lg] for the lanes that continue (s < J_prev), and
//   init[init_off[s] + j] for the lanes that join this round. Bound by
//   bytes (one product per element against 96 bytes moved).
// - kernel 5, q0: per lane, q(0) = sum_j whi[j >> shift] wlo[j & mask]
//   lo[j] over the lane's lower half, mod r. The reference keeps 16-bit
//   lazy limb sums because the TPU has no u64; canonical sums are the same
//   number in any order. A thread's terms are laid out so that one weight
//   (whi, or else wlo) is the same for all of them: it sums the other
//   weight times lo and multiplies by that one once. That sum is lazy
//   (csrc/fq.cuh, mont_redc_sum): each term a plain 512-bit product into a
//   wide accumulator, one Montgomery reduction a thread, so a split-eq lane
//   costs 128 IMAD a term where a Montgomery product costs 264, and a lane
//   without tables only adds. Each block sums a chunk of one lane (a
//   warp-shuffle tree, then one warp); the last block of a lane to finish
//   (a ticket on a per-lane counter, which it resets) adds the lane's
//   partials and writes the lane's one canonical q(0). Bound by integer
//   throughput.
// - kernel 6, tail: one block, a thread a lane: q(1) = (Q - l0 q0) / l1,
//   the coefficient-weighted lane sums b0 (plus the constant of the lanes
//   not yet joined) and b2 summed side by side, their canonical forms on
//   two threads at once, then four lanes absorb "UniPoly\x01" || b0 || b2
//   (big-endian canonical bytes) in one long absorb and squeeze
//   (csrc/blake2b.cuh, a mix a lane), lane 0 masks the digest's low 16
//   bytes to 125 bits and multiplies by 2^384 mod r (the challenge in
//   Montgomery form), and every lane advances Q and its eq scalar at the
//   challenge. A serial transcript step: bound by latency.
//
// Every kernel launches on the caller's stream and synchronises nothing, so
// all rounds queue back to back with no host round trip.
#include <cuda_runtime.h>

#include "blake2b.cuh"
#include "fq.cuh"

namespace jolt {

constexpr int BIND_THREADS = 256;
constexpr int LOG_Q0_THREADS = 8;
constexpr int Q0_THREADS = 1 << LOG_Q0_THREADS;
constexpr int LOG_Q0_PER_THREAD = 4;  // 16 terms

constexpr int Q0_PER_THREAD = 1 << LOG_Q0_PER_THREAD;
constexpr int TAIL_MAX_LANES = 4096;
// kernel 6 takes a lane a thread up to TAIL_BLOCK_LANES lanes (its ~145
// registers a thread leave room for 13 warps a block); beyond, its wide
// form takes them on TAIL_WIDE_THREADS threads, several lanes each
constexpr int TAIL_BLOCK_LANES = 384;
constexpr int TAIL_WIDE_THREADS = 256;

__global__ void __launch_bounds__(BIND_THREADS)
    reduction_bind_kernel(const u64* __restrict__ buf,
                          const u64* __restrict__ init,
                          const u64* __restrict__ c,
                          const int64_t* __restrict__ init_off,
                          u64* __restrict__ out, int64_t j_prev,
                          int64_t n_out, int lg) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  const int64_t s = i >> lg;
  const int64_t j = i & (((int64_t)1 << lg) - 1);
  Fr r;
  if (s < j_prev) {
    const int64_t lo = ((2 * s) << lg) + j;
    const Fr a = load_fr(buf, lo);
    const Fr b = load_fr(buf, lo + ((int64_t)1 << lg));
    r = fr_add(a, fr_mul(fr_sub(b, a), load_fr(c, 0)));
  } else {
    r = load_fr(init, init_off[s] + j);
  }
  store_fr(out, i, r);
}

// lanep: 4 int64 a lane: whi_off, whi_shift, wlo_off, wlo_mask (tab[0] is
// Montgomery one, the weight of a missing table; wlo_mask + 1 a power of
// two). Block b of a lane sums its terms j in [b, b + 1) * Q0_THREADS *
// Q0_PER_THREAD. Thread t's k-th term has the chunk index t's low kb bits,
// then k, then t's other bits: kb = 8 puts k at the top (a warp reads 32
// consecutive terms for every k), kb = shift - LOG_Q0_PER_THREAD in [5, 8)
// keeps all of a thread's terms in one whi row at still 32 consecutive
// terms a warp read. whi is then the same over a thread's terms when k's
// bits lie below shift, wlo when they lie at or above log2(mask + 1).
// Lanes of one block write q(0) directly; a lane of bpl > 1 blocks goes
// through partials (bpl rows a lane) and its counter.
__global__ void __launch_bounds__(Q0_THREADS)
    reduction_q0_kernel(const u64* __restrict__ buf,
                        const u64* __restrict__ tab,
                        const int64_t* __restrict__ lanep,
                        u64* __restrict__ partials,
                        unsigned* __restrict__ counters, u64* __restrict__ out,
                        int lg, int64_t bpl) {
  __shared__ Fr warp_sums[32];
  __shared__ bool last;
  const int64_t s = blockIdx.x / bpl;
  const int64_t part = blockIdx.x % bpl;
  const int64_t half = (int64_t)1 << (lg - 1);
  const int64_t whi_off = lanep[4 * s], wlo_off = lanep[4 * s + 2];
  const int64_t wlo_mask = lanep[4 * s + 3];
  const int64_t whi_shift = lanep[4 * s + 1];
  const int sh = whi_shift < 63 ? (int)whi_shift : 63;
  const int log_wlo = __popcll((unsigned long long)wlo_mask);
  const int d = sh - LOG_Q0_PER_THREAD;
  const int kb = (d >= 5 && d < LOG_Q0_THREADS) ? d : LOG_Q0_THREADS;
  const bool hfix = kb + LOG_Q0_PER_THREAD <= sh;
  const bool lfix = kb >= log_wlo;
  const int tid = threadIdx.x;
  const int64_t j0 = (part << (LOG_Q0_THREADS + LOG_Q0_PER_THREAD)) |
                     (tid & ((1 << kb) - 1)) |
                     ((int64_t)(tid >> kb) << (kb + LOG_Q0_PER_THREAD));
  const u64* lo = buf + 4 * (s << lg);
  Fr acc = fr_zero();
  if (hfix && lfix) {  // one weight for all: adds only
    for (int k = 0; k < Q0_PER_THREAD; ++k) {
      const int64_t j = j0 | ((int64_t)k << kb);
      if (j < half) acc = fr_add(acc, load_fr(lo, j));
    }
  } else {  // the varying weight (both, multiplied, if neither is fixed)
    U512 wide = wide_zero();
    for (int k = 0; k < Q0_PER_THREAD; ++k) {
      const int64_t j = j0 | ((int64_t)k << kb);
      if (j < half) {
        Fr w;
        if (hfix) {
          w = load_fr(tab, wlo_off + (j & wlo_mask));
        } else {
          w = load_fr(tab, whi_off + (j >> sh));
          if (!lfix) w = fr_mul(w, load_fr(tab, wlo_off + (j & wlo_mask)));
        }
        wide_mad(wide, w, load_fr(lo, j));
      }
    }
    acc = mont_redc_sum<FrField, Q0_PER_THREAD>(wide);
  }
  if (j0 < half) {  // j0 is the thread's least term
    if (hfix) acc = fr_mul(acc, load_fr(tab, whi_off + (j0 >> sh)));
    if (lfix) acc = fr_mul(acc, load_fr(tab, wlo_off + (j0 & wlo_mask)));
  }
  acc = block_sum(acc, warp_sums);
  if (bpl == 1) {
    if (tid == 0) store_fr(out, s, acc);
    return;
  }
  // -- the lane's last block to finish adds the lane's partials
  if (tid == 0) {
    store_fr(partials, blockIdx.x, acc);
    __threadfence();
    last = atomicAdd(counters + s, 1u) == (unsigned)(bpl - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  acc = fr_zero();
  for (int64_t b = tid; b < bpl; b += Q0_THREADS)
    acc = fr_add(acc, ldcg_fr(partials, s * bpl + b));
  acc = block_sum(acc, warp_sums);
  if (tid == 0) {
    store_fr(out, s, acc);
    counters[s] = 0;
  }
}

// Sums x and y over the block (blockDim.x a multiple of 32, at most 1024)
// side by side: x valid in thread 0, y in thread 1. sums: 64 elements of
// shared memory.
__device__ __forceinline__ void block_sum2(Fr& x, Fr& y, Fr* sums) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    x = fr_add(x, fr_shfl_down(x, d));
    y = fr_add(y, fr_shfl_down(y, d));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sums[warp] = x;
    sums[32 + warp] = y;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    const Fr* mine = sums + 32 * threadIdx.x;
    Fr t = mine[0];
    for (int k = 1; k < (int)(blockDim.x >> 5); ++k) t = fr_add(t, mine[k]);
    if (threadIdx.x == 0) x = t; else y = t;
  }
}

#ifndef TAIL_STAMP  // a stage mark of kernel 6 (scripts/ builds time them)
#define TAIL_STAMP(k)
#endif

// Kernel 6's arrays (as jolt_reduction_tail's): q0s, one q(0) a lane;
// state, 4 u64 transcript state words, then n_rounds; msg, b0 and b2.
struct TailIo {
  const u64* q0s;
  u64* Q;
  u64* es;
  const u64* coeff;
  const u64* l0;
  const u64* l1;
  const u64* inv_l1;
  const u64* const_b0;
  u64* state;
  u64* c_out;
  u64* msg;
};

// Sums a pair over the block into threads 0 and 1: kernel 6's b0 and b2
struct BlockSum2 {
  Fr* sums;  // 64 elements of shared memory
  __device__ __forceinline__ void operator()(Fr& x, Fr& y) const {
    block_sum2(x, y, sums);
  }
};

// One round of kernel 6 on thread t of a block of at least 4 threads
// (lane t joined if `in`): the lane's message terms, sum2 of them (thread
// 0 then holds b0 less the unjoined lanes' constant, thread 1 b2), the
// payload's canonical words, the long absorb and the squeeze, the
// challenge and the lane's update. Threads 0-3 run the serial part as one
// straight line (thread 0 converts b0, the others b2; each forms a
// challenge from its state word; thread 1 stores b2's words, thread 0 the
// rest). Kernel 6 runs it with BlockSum2; device/kernel_report.py compiles
// it with no sum (tail_path_chain): the chain of one lane's round, counted
// from this code.
template <class Sum2>
__device__ __forceinline__ void tail_round(const TailIo& io, int t, bool in,
                                           Sum2 sum2) {
  __shared__ u64 words[9 + 16];  // the round message's payload, a block
  __shared__ Fr c_shared;
  TAIL_STAMP(0)
  Fr q0 = fr_zero(), dq = fr_zero(), dl = fr_zero(), l0 = fr_zero();
  Fr esv = fr_zero(), s0 = fr_zero(), s2 = fr_zero();
  if (in) {
    q0 = load_fr(io.q0s, t);
    l0 = load_fr(io.l0, t);
    esv = load_fr(io.es, t);
    const Fr l0q0 = fr_mul(l0, q0);
    const Fr q1 =
        fr_mul(fr_sub(load_fr(io.Q, t), l0q0), load_fr(io.inv_l1, t));
    dq = fr_sub(q1, q0);
    dl = fr_sub(load_fr(io.l1, t), l0);
    const Fr cf = load_fr(io.coeff, t);
    s0 = fr_mul(cf, fr_mul(esv, l0q0));
    s2 = fr_mul(cf, fr_mul(esv, fr_mul(dl, dq)));
  }
  TAIL_STAMP(1)
  sum2(s0, s2);
  if (t < 4) {  // the transcript on four lanes: lane t holds state word t
    const Fr b = t == 0 ? fr_add(s0, load_fr(io.const_b0, 0)) : s2;
    TAIL_STAMP(2)
    Fr raw_one = fr_zero();
    raw_one.v[0] = 1;
    const Fr cb = fr_mul(b, raw_one);  // canonical
    // payload: "UniPoly\x01", then b0 and b2, 32 bytes big-endian each
    // (limb 3 first)
    if (t < 2) {
      store_fr(io.msg, t, b);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 3 - j;
        words[1 + 4 * t + j] =
            bswap64((u64)cb.v[2 * k] | ((u64)cb.v[2 * k + 1] << 32));
      }
    }
    if (t == 0) words[0] = 0x01796c6f50696e55ull;
    __syncwarp(0xfu);
    TAIL_STAMP(3)
    u64 st = io.state[t];
    const u32 n = (u32)io.state[4];
    transcript_step_x4(st, n, words, 9, words + 9);  // the long absorb
    transcript_step_x4(st, n + 1, words, 0, words + 9);  // the squeeze
    TAIL_STAMP(4)
    io.state[t] = st;
    const u64 st1 = __shfl_sync(0xfu, st, 1);
    // digest bytes 0..15 little-endian (lane 0's word, then lane 1's),
    // masked to 125 bits, times 2^-128: in Montgomery form, the masked
    // value times 2^384 mod r (thread 0's c is the challenge)
    Fr ch = fr_zero();
    ch.v[0] = (u32)st;
    ch.v[1] = (u32)(st >> 32);
    ch.v[2] = (u32)st1;
    ch.v[3] = (u32)(st1 >> 32) & 0x1fffffffu;
    Fr two384;  // 2^384 mod r
    constexpr u32 T384[8] = {0xef8cfeb9u, 0xb075da81u, 0xa5b6cd8cu,
                             0xa7f12accu, 0x7957bf7bu, 0x32c47504u,
                             0x48ffa25eu, 0x03d581d7u};
#pragma unroll
    for (int j = 0; j < 8; ++j) two384.v[j] = T384[j];
    const Fr c = fr_mul(ch, two384);
    if (t == 0) {
      io.state[4] = n + 2;
      c_shared = c;
      store_fr(io.c_out, 0, c);
    }
    TAIL_STAMP(5)
  }
  __syncthreads();
  if (in) {
    const Fr c = c_shared;
    store_fr(io.Q, t, fr_add(q0, fr_mul(dq, c)));
    store_fr(io.es, t, fr_mul(esv, fr_add(l0, fr_mul(dl, c))));
  }
  TAIL_STAMP(6)
}

// One block, a thread a lane (at least 32 threads); lanes t >= joined
// take Q from qinit
__global__ void reduction_tail_kernel(
    const u64* __restrict__ q0s, int64_t joined, int64_t lanes,
    u64* __restrict__ Q, u64* __restrict__ es, const u64* __restrict__ qinit,
    const u64* __restrict__ coeff, const u64* __restrict__ l0p,
    const u64* __restrict__ l1p, const u64* __restrict__ inv_l1p,
    const u64* __restrict__ const_b0, u64* __restrict__ state,
    u64* __restrict__ c_out, u64* __restrict__ msg) {
  __shared__ Fr sums[64];
  const int t = threadIdx.x;
  if (t >= joined && t < lanes) store_fr(Q, t, load_fr(qinit, t));
  tail_round(TailIo{q0s, Q, es, coeff, l0p, l1p, inv_l1p, const_b0, state,
                    c_out, msg},
             t, t < joined, BlockSum2{sums});
}

// Lane u's message terms (s0, s2), as tail_round forms lane t's
__device__ __forceinline__ void tail_terms(const TailIo& io, int64_t u,
                                           Fr& s0, Fr& s2) {
  const Fr q0 = load_fr(io.q0s, u);
  const Fr l0 = load_fr(io.l0, u);
  const Fr esv = load_fr(io.es, u);
  const Fr l0q0 = fr_mul(l0, q0);
  const Fr q1 = fr_mul(fr_sub(load_fr(io.Q, u), l0q0), load_fr(io.inv_l1, u));
  const Fr cf = load_fr(io.coeff, u);
  s0 = fr_mul(cf, fr_mul(esv, l0q0));
  s2 = fr_mul(cf, fr_mul(esv, fr_mul(fr_sub(load_fr(io.l1, u), l0),
                                     fr_sub(q1, q0))));
}

// The block sum of kernel 6's wide form: a thread's lanes t + blockDim,
// t + 2 blockDim, ... add their terms to lane t's first (the sums are exact
// in Fr, so the order does not show in b0 and b2)
struct WideSum2 {
  Fr* sums;
  const TailIo* io;
  int64_t joined;
  __device__ __forceinline__ void operator()(Fr& x, Fr& y) const {
    for (int64_t u = threadIdx.x + blockDim.x; u < joined; u += blockDim.x) {
      Fr s0, s2;
      tail_terms(*io, u, s0, s2);
      x = fr_add(x, s0);
      y = fr_add(y, s2);
    }
    block_sum2(x, y, sums);
  }
};

// Kernel 6 beyond TAIL_BLOCK_LANES lanes: tail_round on lane t of each
// thread, the thread's further lanes summed into its terms (WideSum2) and
// updated after the challenge, which thread 0 left in c_out
__global__ void __launch_bounds__(TAIL_WIDE_THREADS)
    reduction_tail_wide_kernel(
        const u64* __restrict__ q0s, int64_t joined, int64_t lanes,
        u64* __restrict__ Q, u64* __restrict__ es,
        const u64* __restrict__ qinit, const u64* __restrict__ coeff,
        const u64* __restrict__ l0p, const u64* __restrict__ l1p,
        const u64* __restrict__ inv_l1p, const u64* __restrict__ const_b0,
        u64* __restrict__ state, u64* __restrict__ c_out,
        u64* __restrict__ msg) {
  __shared__ Fr sums[64];
  const int t = threadIdx.x;
  for (int64_t u = t; u < lanes; u += blockDim.x)
    if (u >= joined) store_fr(Q, u, load_fr(qinit, u));
  const TailIo io{q0s, Q, es, coeff, l0p, l1p, inv_l1p, const_b0, state,
                  c_out, msg};
  tail_round(io, t, t < joined, WideSum2{sums, &io, joined});
  const Fr c = load_fr(c_out, 0);
  for (int64_t u = t + blockDim.x; u < joined; u += blockDim.x) {
    const Fr q0 = load_fr(q0s, u);
    const Fr l0 = load_fr(l0p, u);
    const Fr q1 = fr_mul(fr_sub(load_fr(Q, u), fr_mul(l0, q0)),
                         load_fr(inv_l1p, u));
    store_fr(Q, u, fr_add(q0, fr_mul(fr_sub(q1, q0), c)));
    store_fr(es, u, fr_mul(load_fr(es, u),
                           fr_add(l0, fr_mul(fr_sub(load_fr(l1p, u), l0),
                                             c))));
  }
}

constexpr int TRANSCRIPT_THREADS = 128;  // four a transcript

// n independent transcript steps, each on four lanes (transcript_step_x4,
// as kernel 6 runs it): a squeeze (np = 0), an absorb (np = 4) or a long
// absorb (any other np) of states[i] at n_rounds[i] with payload words
// payload[i * np ..]
__global__ void __launch_bounds__(TRANSCRIPT_THREADS)
    blake2b_transcript_kernel(const u64* __restrict__ states,
                              const int64_t* __restrict__ n_rounds,
                              const u64* __restrict__ payload, int np,
                              int64_t n, u64* __restrict__ out) {
  __shared__ u64 blocks[TRANSCRIPT_THREADS / 4][16];
  const int64_t i =
      ((int64_t)blockIdx.x * TRANSCRIPT_THREADS + threadIdx.x) >> 2;
  if (i >= n) return;  // a whole group of four
  const int q = threadIdx.x & 3;
  u64 st = states[4 * i + q];
  transcript_step_x4(st, (u32)n_rounds[i], payload + (int64_t)np * i, np,
                     blocks[threadIdx.x >> 2]);
  out[4 * i + q] = st;
}

}  // namespace jolt

// Every array below is (n, 4) u64 Montgomery limbs unless said otherwise;
// each function launches on `stream`, allocates nothing and returns
// cudaGetLastError().

// out = J segments of 2^lg: the lanes s < j_prev bound from buf (segments
// of 2^(lg + 1)) at the challenge c[0], the others copied from init at
// init_off[s] (int64); n_out = J << lg.
extern "C" int jolt_reduction_bind(const void* buf, const void* init,
                                   const void* c, const void* init_off,
                                   void* out, int64_t j_prev, int64_t n_out,
                                   int lg, void* stream) {
  using jolt::u64;
  if (n_out <= 0) return 0;
  const int64_t blocks =
      (n_out + jolt::BIND_THREADS - 1) / jolt::BIND_THREADS;
  jolt::reduction_bind_kernel<<<(unsigned)blocks, jolt::BIND_THREADS, 0,
                                (cudaStream_t)stream>>>(
      (const u64*)buf, (const u64*)init, (const u64*)c,
      (const int64_t*)init_off, (u64*)out, j_prev, n_out, lg);
  return (int)cudaGetLastError();
}

// out[s] = lane s's q(0) (the sum over its lower half of its terms), for
// s < lanes; buf holds the lanes in segments of 2^lg (lg >= 1); bpl = the
// blocks of a lane's half (chunks of Q0_THREADS * Q0_PER_THREAD); partials
// (lanes * bpl rows) is scratch where bpl > 1, and counters (lanes u32) are
// zero, as every launch leaves them; lanep as the kernel's.
extern "C" int jolt_reduction_q0(const void* buf, const void* tab,
                                 const void* lanep, void* partials,
                                 void* counters, void* out, int64_t lanes,
                                 int lg, int64_t bpl, void* stream) {
  using jolt::u64;
  if (lanes <= 0) return 0;
  constexpr int64_t chunk = jolt::Q0_THREADS * jolt::Q0_PER_THREAD;
  if (lg < 1 || bpl != (((int64_t)1 << (lg - 1)) + chunk - 1) / chunk)
    return (int)cudaErrorInvalidValue;
  jolt::reduction_q0_kernel<<<(unsigned)(lanes * bpl), jolt::Q0_THREADS, 0,
                              (cudaStream_t)stream>>>(
      (const u64*)buf, (const u64*)tab, (const int64_t*)lanep,
      (u64*)partials, (unsigned*)counters, (u64*)out, lg, bpl);
  return (int)cudaGetLastError();
}

// One round's message, transcript step and challenge over `lanes` lanes
// (at most TAIL_MAX_LANES; beyond TAIL_BLOCK_LANES on kernel 6's wide
// form), the first `joined` of them joined, from their q(0) (q0s,
// a row a lane); Q and es advance in place, state (5 u64) too; c_out gets
// the challenge, msg (2 elements) b0 and b2.
extern "C" int jolt_reduction_tail(const void* q0s, int64_t joined,
                                   int64_t lanes, void* Q, void* es,
                                   const void* qinit, const void* coeff,
                                   const void* l0, const void* l1,
                                   const void* inv_l1, const void* const_b0,
                                   void* state, void* c_out, void* msg,
                                   void* stream) {
  using jolt::u64;
  if (lanes < 1 || lanes > jolt::TAIL_MAX_LANES || joined > lanes)
    return (int)cudaErrorInvalidValue;
  if (lanes > jolt::TAIL_BLOCK_LANES) {
    jolt::reduction_tail_wide_kernel<<<1, jolt::TAIL_WIDE_THREADS, 0,
                                       (cudaStream_t)stream>>>(
        (const u64*)q0s, joined, lanes, (u64*)Q, (u64*)es,
        (const u64*)qinit, (const u64*)coeff, (const u64*)l0,
        (const u64*)l1, (const u64*)inv_l1, (const u64*)const_b0,
        (u64*)state, (u64*)c_out, (u64*)msg);
    return (int)cudaGetLastError();
  }
  const int threads = (int)((lanes + 31) / 32 * 32);
  jolt::reduction_tail_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
      (const u64*)q0s, joined, lanes, (u64*)Q, (u64*)es, (const u64*)qinit,
      (const u64*)coeff, (const u64*)l0, (const u64*)l1, (const u64*)inv_l1,
      (const u64*)const_b0, (u64*)state, (u64*)c_out, (u64*)msg);
  return (int)cudaGetLastError();
}

// out[i] (4 u64) = the transcript state after one step on states[i] (4
// u64) at n_rounds[i] (int64) with np payload words each, for i < n (four
// threads a transcript).
extern "C" int jolt_blake2b_transcript(const void* states,
                                       const void* n_rounds,
                                       const void* payload, int np, int64_t n,
                                       void* out, void* stream) {
  using jolt::u64;
  if (n <= 0) return 0;
  if (np < 0) return (int)cudaErrorInvalidValue;
  const int64_t per = jolt::TRANSCRIPT_THREADS / 4;
  jolt::blake2b_transcript_kernel<<<(unsigned)((n + per - 1) / per),
                                    jolt::TRANSCRIPT_THREADS, 0,
                                    (cudaStream_t)stream>>>(
      (const u64*)states, (const int64_t*)n_rounds, (const u64*)payload, np,
      n, (u64*)out);
  return (int)cudaGetLastError();
}
