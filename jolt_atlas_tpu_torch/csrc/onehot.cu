// The one-hot read checks of a graph node on the card: one batched sumcheck
// over a Booleanity instance and its AddressReadCheck instances
// (subprotocols/onehot.py), proved round by round with one launch and one
// fetch a round (device/onehot.py drives them; the host keeps the
// transcript).
//
// Replaces no TPU kernel: the reference proves these batches on the host
// (frv_onehot_qev, a GruenInstance, a FusedInstance a read check). They are
// many and small (a proof of the benchmark's nanoGPT has 179 such batches,
// each a Booleanity of 1-16 chunk rows of T = 64 to 16,384 cycles and 1-51
// read checks of 16 entries, Gather's of 128), so what bounds them on this
// card is the number of launches and host round trips, not IMAD throughput
// or bytes: a round's field work is at most D T / 2 x 7 Montgomery products
// (~0.8 M at D 14, T 16,384: 13 us of the IMAD peak), and most rounds have
// far less. The design therefore puts a whole round, every instance of the
// batch, into one launch:
//
// - set-up, two launches: onehot_prepare_kernel turns the staged canonical
//   scalars (the challenges r_b and r_cycle, 1 / r_b, the gammas, the
//   batching coefficients, the read checks' claims) into Montgomery form
//   and builds every eq table the batch uses from the challenges: eq(r_cycle)
//   over the T cycles, E_s = eq(r_b[s:]) for s = logK .. M (the cycle
//   rounds' split-eq weights), A_l = eq(r_b[l + 1 : logK]) (the address
//   rounds' remaining address bits). onehot_buckets_kernel then forms, for
//   each chunk row d and value k, the bucket sums G_d[k] = sum_{j: c_d(j) =
//   k} eq(r_cycle)[j] (each read check's cycle-bound row) and H_d[k] the
//   same of E_logK (the Booleanity's address-round weights: the pair weight
//   eq(r_b[l + 1:], (k_rest, j)) factors as A_l[k_rest] E_logK[j], so one
//   bucket sum serves all logK address rounds).
// - a round, onehot_round_kernel: blocks 0 .. nB - 1 take the Booleanity, a
//   block beyond them the read checks, and the last block to finish (a
//   ticket, as kernel 7's) assembles the batched polynomial.
//   * Booleanity, address round l: with U[c] the bound prefix weight of
//     value c (U times r or 1 - r at each bound bit, applied here from the
//     previous challenge), q(0) and q(2) are sums over (d, k) of gamma_d A_l
//     H_d[k] times U^2 - U, U^2 + U or 4 U^2 - 2 U by the value's current bit
//     (frv_onehot_qev's formulas).
//   * Booleanity, cycle round ci: a thread a (row, pair). Round 0's rows
//     are U[c_d(j)], gathered from the chunk indices; round 1 gathers and
//     binds them at the previous challenge and writes the bound rows; later
//     rounds bind the previous round's rows (two buffers in turn) and write
//     them. Each thread adds gamma_d E(j) (e^2 - e) at e = lo and e = 2 hi -
//     lo; the block sums are the partials.
//   * The read checks: their tables (one a table kind) and G rows (one a
//     chunk row) are bound in place at the previous challenge, each
//     instance's claim is its last polynomial at that challenge, a group of
//     lanes an instance forms p(0) and p(2), then a thread an instance its
//     coefficients (p(1) = claim - p(0), the hint); the block sums them
//     weighted by the batching coefficients. Before the read checks join,
//     their constant polynomials' weighted sum (claim x 2^k) stands in.
//   * The last block: the Booleanity's q(0), q(2) from the partials, its eq
//     scalar es and claim (its last polynomial at the previous challenge),
//     es q(1) = (claim - l0 es q(0)) / l1 (the hint), s(X) = l(X) es q(X),
//     and the batched polynomial's four coefficients, canonical, in `out`.
// - the close: the same kernel at round M binds everything at the last
//   challenge and writes the Booleanity's D row values and the D G rows'
//   values to `out`.
//
// Field sums are exact, so no order of the partition changes a value: the
// plain versions (device/onehot.py) need not follow it. Every output is
// canonical.
#include <cuda_runtime.h>

#include "fq.cuh"

namespace jolt {

constexpr int OH_THREADS = 256;
constexpr int OH_MAX_VARS = 64;    // the most challenges r_b or r_cycle holds
constexpr int OH_MAX_BLOCKS = 4096;  // the prepare kernel's grid at most

// The workspace layout, in rows of 4 u64 (one field element) from the
// workspace's start: device/onehot.py:Layout, the fields in this order.
// mv holds the staged scalars in Montgomery form, in the staged order: r_b
// (M), r_cycle (logT), 1 / r_b (M), gamma (D), the batching coefficients
// (the Booleanity's, then the N read checks'), the read checks' claims (N),
// 1 / 2.
struct OhLay {
  int64_t M, logK, K, logT, T, D, N, S, wide;
  int64_t r2, stage, TB, rcmap, mv, l0, eqC, E, A, GB, H, U, es, sB, Cc,
      rcc, rcp, B, partials, out;
};
constexpr int OH_FIELDS = 29;

struct OhScalars {  // offsets into mv
  int64_t rb, rc, inv, gam, coef, claim0, inv2;
};

__host__ __device__ inline OhScalars oh_scalars(const OhLay& L) {
  OhScalars s;
  s.rb = L.mv;
  s.rc = s.rb + L.M;
  s.inv = s.rc + L.logT;
  s.gam = s.inv + L.M;
  s.coef = s.gam + L.D;
  s.claim0 = s.coef + 1 + L.N;
  s.inv2 = s.claim0 + L.N;
  return s;
}

__device__ __forceinline__ Fr fr_one() {
  Fr r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = FrField::one(j);
  return r;
}

// the canonical value of a Montgomery element: x 1 / R
__device__ __forceinline__ Fr fr_canon(const Fr& x) {
  Fr one_raw = fr_zero();
  one_raw.v[0] = 1;
  return fr_mul(x, one_raw);
}

__device__ __forceinline__ Fr fr_words(u64 a, u64 b, u64 c, u64 d) {
  Fr r;
  const u64 w[4] = {a, b, c, d};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    r.v[2 * j] = (u32)w[j];
    r.v[2 * j + 1] = (u32)(w[j] >> 32);
  }
  return r;
}

__device__ __forceinline__ Fr oh_bind(const Fr& lo, const Fr& hi,
                                      const Fr& r) {
  return fr_add(lo, fr_mul(r, fr_sub(hi, lo)));
}

// chunk index i of the (D, T) rows: bytes, or int32 where K > 256
__device__ __forceinline__ int64_t oh_idx(const void* idx, int64_t wide,
                                          int64_t i) {
  return wide ? (int64_t)(reinterpret_cast<const int32_t*>(idx)[i])
              : (int64_t)(reinterpret_cast<const uint8_t*>(idx)[i]);
}

// U in round rnd <= logK at value c: the all-ones slot 0 at round 0, else
// the previous round's slot times r or 1 - r by c's bit logK - rnd
__device__ __forceinline__ Fr oh_u(const OhLay& L, const u64* ws,
                                   int64_t rnd, int64_t c, const Fr& r,
                                   const Fr& r0) {
  if (rnd == 0) return load_fr(ws, L.U + c);
  const Fr u = load_fr(ws, L.U + ((rnd - 1) & 1) * L.K + c);
  return fr_mul(u, ((c >> (L.logK - rnd)) & 1) ? r : r0);
}

// The staged scalars into Montgomery form (block 0), the eq tables (a
// thread an entry, striding over the grid: eq(r_cycle) T entries, E_s at
// 2T - 2^(M - s + 1), A_l at K - 2^(logK - l)), U's slot 0 and es.
__global__ void __launch_bounds__(OH_THREADS)
    onehot_prepare_kernel(OhLay L, u64* ws) {
  __shared__ Fr rb[OH_MAX_VARS], rb0[OH_MAX_VARS], rc[OH_MAX_VARS],
      rc0[OH_MAX_VARS];
  const int tid = threadIdx.x;
  const Fr r2 = load_fr(ws, L.r2);
  const Fr one = fr_one();
  for (int64_t i = tid; i < L.M; i += OH_THREADS) {
    const Fr x = fr_mul(load_fr(ws, L.stage + i), r2);
    rb[i] = x;
    rb0[i] = fr_sub(one, x);
  }
  for (int64_t i = tid; i < L.logT; i += OH_THREADS) {
    const Fr x = fr_mul(load_fr(ws, L.stage + L.M + i), r2);
    rc[i] = x;
    rc0[i] = fr_sub(one, x);
  }
  __syncthreads();
  if (blockIdx.x == 0) {
    const int64_t ns = 2 * L.M + L.logT + L.D + 2 * L.N + 2;
    for (int64_t i = tid; i < ns; i += OH_THREADS)
      store_fr(ws, L.mv + i, fr_mul(load_fr(ws, L.stage + i), r2));
    for (int64_t i = tid; i < L.M; i += OH_THREADS)
      store_fr(ws, L.l0 + i, rb0[i]);
    for (int64_t k = tid; k < L.K; k += OH_THREADS) store_fr(ws, L.U + k, one);
    if (tid == 0) store_fr(ws, L.es, one);
  }
  const int64_t T = L.T, K = L.K;
  const int64_t n_all = 3 * T - 1 + K - 1;
  for (int64_t e = (int64_t)blockIdx.x * OH_THREADS + tid; e < n_all;
       e += (int64_t)gridDim.x * OH_THREADS) {
    const Fr *c1, *c0;
    int64_t x, nv, dst;
    if (e < T) {
      c1 = rc;
      c0 = rc0;
      nv = L.logT;
      x = e;
      dst = L.eqC + e;
    } else if (e < 3 * T - 1) {
      const int64_t f = e - T;
      int64_t s = L.logK, size = T, off = 0;
      while (f >= off + size) {
        off += size;
        size >>= 1;
        ++s;
      }
      c1 = rb + s;
      c0 = rb0 + s;
      nv = L.M - s;
      x = f - off;
      dst = L.E + f;
    } else {
      const int64_t f = e - (3 * T - 1);
      int64_t l = 0, size = K >> 1, off = 0;
      while (f >= off + size) {
        off += size;
        size >>= 1;
        ++l;
      }
      c1 = rb + l + 1;
      c0 = rb0 + l + 1;
      nv = L.logK - l - 1;
      x = f - off;
      dst = L.A + f;
    }
    Fr p = one;  // eq(c, x), x's top bit taking c[0]
    for (int64_t i = 0; i < nv; ++i)
      p = fr_mul(p, ((x >> (nv - 1 - i)) & 1) ? c1[i] : c0[i]);
    store_fr(ws, dst, p);
  }
}

// Block (k, d): GB[d K + k] = sum of eq(r_cycle)[j] and H[d K + k] = sum
// of E_logK[j] over the cycles j whose chunk d is k
__global__ void __launch_bounds__(OH_THREADS)
    onehot_buckets_kernel(OhLay L, u64* ws, const void* idx) {
  __shared__ Fr warp_sums[32];
  const int64_t k = blockIdx.x, d = blockIdx.y;
  Fr a = fr_zero(), b = fr_zero();
  for (int64_t j = threadIdx.x; j < L.T; j += OH_THREADS)
    if (oh_idx(idx, L.wide, d * L.T + j) == k) {
      a = fr_add(a, load_fr(ws, L.eqC + j));
      b = fr_add(b, load_fr(ws, L.E + j));
    }
  a = block_sum(a, warp_sums);
  b = block_sum(b, warp_sums);
  if (threadIdx.x == 0) {
    store_fr(ws, L.GB + d * L.K + k, a);
    store_fr(ws, L.H + d * L.K + k, b);
  }
}

// the Booleanity's blocks of round rnd: nB (1 in an address round)
__host__ __device__ inline int64_t oh_booleanity_blocks(const OhLay& L,
                                                        int64_t rnd) {
  if (rnd < L.logK) return 1;
  const int64_t ci = rnd - L.logK;
  const int64_t work = ci < L.logT ? L.D * (L.T >> (ci + 1)) : L.D;
  return (work + OH_THREADS - 1) / OH_THREADS;
}

// Round rnd of the batch (rnd = M: the close), the previous challenge r
// (canonical words; unused at round 0). Blocks 0 .. nB - 1: the
// Booleanity; block nB: the read checks; the last to finish: the batched
// polynomial. partials: 4 rows a block.
__global__ void __launch_bounds__(OH_THREADS)
    onehot_round_kernel(OhLay L, u64* ws, const void* idx, int64_t rnd,
                        u64 w0, u64 w1, u64 w2, u64 w3, int64_t nB,
                        unsigned* counter) {
  __shared__ Fr warp_sums[32];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const OhScalars sc = oh_scalars(L);
  const int64_t M = L.M, logK = L.logK, K = L.K, logT = L.logT, T = L.T,
                D = L.D, N = L.N;
  const Fr one = fr_one();
  Fr r = fr_zero(), r0 = one;
  if (rnd > 0) {
    r = fr_mul(fr_words(w0, w1, w2, w3), load_fr(ws, L.r2));
    r0 = fr_sub(one, r);
  }
  u64* part = ws + 4 * L.partials;

  if (blockIdx.x < nB) {
    // ---- the Booleanity
    Fr t0 = fr_zero(), t2 = fr_zero();
    if (rnd < logK) {  // an address round, one block
      const int64_t low = logK - rnd - 1, mask = ((int64_t)1 << low) - 1;
      const int64_t aoff = L.A + K - (K >> rnd);
      for (int64_t e = tid; e < D * K; e += OH_THREADS) {
        const int64_t d = e / K, k = e - d * K;
        const Fr u = oh_u(L, ws, rnd, k, r, r0);
        const Fr g =
            fr_mul(load_fr(ws, aoff + (k & mask)), load_fr(ws, L.H + e));
        const Fr gu = fr_mul(g, u), gu2 = fr_mul(gu, u);
        Fr v0, v2;
        if ((k >> low) & 1) {  // t = 0: 0; t = 2: 4 U^2 - 2 U
          v0 = fr_zero();
          Fr a = fr_add(gu2, gu2);
          a = fr_add(a, a);
          v2 = fr_sub(a, fr_add(gu, gu));
        } else {  // t = 0: U^2 - U; t = 2: U^2 + U
          v0 = fr_sub(gu2, gu);
          v2 = fr_add(gu2, gu);
        }
        const Fr gam = load_fr(ws, sc.gam + d);
        t0 = fr_add(t0, fr_mul(gam, v0));
        t2 = fr_add(t2, fr_mul(gam, v2));
      }
    } else {
      const int64_t ci = rnd - logK, n = T >> ci, rs = T >> 1;
      const int64_t e = (int64_t)blockIdx.x * OH_THREADS + tid;
      const u64* Uf = ws + 4 * (L.U + (logK & 1) * K);  // U after logK binds
      if (ci < logT) {
        const int64_t half = n >> 1;
        if (e < D * half) {
          const int64_t d = e / half, j = e - d * half;
          Fr lo, hi;
          if (ci == 0) {  // the rows U[c_d(j)], gathered
            lo = oh_u(L, ws, rnd, oh_idx(idx, L.wide, d * T + j), r, r0);
            hi = oh_u(L, ws, rnd, oh_idx(idx, L.wide, d * T + j + half), r,
                      r0);
          } else {
            if (ci == 1) {  // gathered and bound: n = T / 2
              const int64_t b = d * T;
              lo = oh_bind(load_fr(Uf, oh_idx(idx, L.wide, b + j)),
                           load_fr(Uf, oh_idx(idx, L.wide, b + j + rs)), r);
              hi = oh_bind(load_fr(Uf, oh_idx(idx, L.wide, b + j + half)),
                           load_fr(Uf, oh_idx(idx, L.wide, b + j + half + rs)),
                           r);
            } else {  // the previous rows (2n), bound
              const u64* P = ws + 4 * (L.B + ((ci - 1) & 1) * D * rs + d * rs);
              lo = oh_bind(load_fr(P, j), load_fr(P, j + n), r);
              hi = oh_bind(load_fr(P, j + half), load_fr(P, j + half + n), r);
            }
            u64* Q = ws + 4 * (L.B + (ci & 1) * D * rs + d * rs);
            store_fr(Q, j, lo);
            store_fr(Q, j + half, hi);
          }
          // E_{logK + ci + 1}, at 2T - n: the pair's split-eq weight
          const Fr gw = fr_mul(load_fr(ws, sc.gam + d),
                               load_fr(ws, L.E + 2 * T - n + j));
          const Fr e2 = fr_sub(fr_add(hi, hi), lo);
          t0 = fr_mul(gw, fr_sub(fr_mul(lo, lo), lo));
          t2 = fr_mul(gw, fr_sub(fr_mul(e2, e2), e2));
        }
      } else if (e < D) {  // the close: each row's value
        Fr v;
        if (ci == 1) {
          v = oh_bind(load_fr(Uf, oh_idx(idx, L.wide, e * T)),
                      load_fr(Uf, oh_idx(idx, L.wide, e * T + 1)), r);
        } else {
          const u64* P = ws + 4 * (L.B + ((ci - 1) & 1) * D * rs + e * rs);
          v = oh_bind(load_fr(P, 0), load_fr(P, 1), r);
        }
        store_fr(ws, L.out + e, fr_canon(v));
      }
    }
    if (rnd < M) {
      t0 = block_sum(t0, warp_sums);
      t2 = block_sum(t2, warp_sums);
      if (tid == 0) {
        store_fr(part, 4 * blockIdx.x, t0);
        store_fr(part, 4 * blockIdx.x + 1, t2);
      }
    }
  } else if (N > 0) {
    // ---- the read checks
    const int64_t jr = M - logK;  // the round they join
    if (rnd < jr) {  // not joined: sum_i coeff_i claim_i 2^(jr - rnd - 1)
      Fr cc;
      if (rnd == 0) {
        Fr a = fr_zero();
        for (int64_t i = tid; i < N; i += OH_THREADS)
          a = fr_add(a, fr_mul(load_fr(ws, sc.coef + 1 + i),
                               load_fr(ws, sc.claim0 + i)));
        cc = block_sum(a, warp_sums);
        if (tid == 0) store_fr(ws, L.Cc, cc);
      } else {
        cc = load_fr(ws, L.Cc);
      }
      if (tid == 0) {
        for (int64_t k = 0; k < jr - rnd - 1; ++k) cc = fr_add(cc, cc);
        store_fr(part, 4 * nB, cc);
        store_fr(part, 4 * nB + 1, fr_zero());
        store_fr(part, 4 * nB + 2, fr_zero());
      }
    } else {
      const int64_t l = rnd - jr, rows = L.S + D;
      if (l >= 1) {  // bind at r: each row from K >> (l - 1) to K >> l
        const int64_t h2 = K >> l;
        for (int64_t e = tid; e < rows * h2; e += OH_THREADS) {
          const int64_t row = e / h2, k = e - row * h2;
          const int64_t b = row < L.S ? L.TB + row * K : L.GB + (row - L.S) * K;
          store_fr(ws, b + k,
                   oh_bind(load_fr(ws, b + k), load_fr(ws, b + k + h2), r));
        }
        for (int64_t i = tid; i < N; i += OH_THREADS) {
          const Fr c0 = load_fr(ws, L.rcp + 3 * i),
                   c1 = load_fr(ws, L.rcp + 3 * i + 1),
                   c2 = load_fr(ws, L.rcp + 3 * i + 2);
          store_fr(ws, L.rcc + i, fr_add(c0, fr_mul(r, fr_add(c1, fr_mul(r, c2)))));
        }
      } else {
        for (int64_t i = tid; i < N; i += OH_THREADS)
          store_fr(ws, L.rcc + i, load_fr(ws, sc.claim0 + i));
      }
      __syncthreads();
      if (l < logK) {
        // p(0) and p(2) of each instance: a group of g lanes (the pairs'
        // power of two, at most a warp) an instance, 256 / g instances a
        // pass, the group's sums by shuffles; kept in rcp's first two rows
        const int64_t half = K >> (l + 1);
        const int g = half >= 32 ? 32 : (int)half;
        const int per = OH_THREADS / g, lane = tid % g;
        const int64_t* map = reinterpret_cast<const int64_t*>(ws);
        for (int64_t base = 0; base < N; base += per) {
          const int64_t i = base + tid / g;
          Fr p0 = fr_zero(), p2 = fr_zero();
          if (i < N) {
            const int64_t tb = L.TB + map[4 * (L.rcmap + i)] * K;
            const int64_t gb = L.GB + map[4 * (L.rcmap + i) + 1] * K;
            for (int64_t k = lane; k < half; k += g) {
              const Fr tl = load_fr(ws, tb + k), th = load_fr(ws, tb + k + half);
              const Fr gl = load_fr(ws, gb + k), gh = load_fr(ws, gb + k + half);
              p0 = fr_add(p0, fr_mul(tl, gl));
              p2 = fr_add(p2, fr_mul(fr_sub(fr_add(th, th), tl),
                                     fr_sub(fr_add(gh, gh), gl)));
            }
          }
          for (int dd = g >> 1; dd > 0; dd >>= 1) {
            p0 = fr_add(p0, fr_shfl_down(p0, dd));
            p2 = fr_add(p2, fr_shfl_down(p2, dd));
          }
          if (lane == 0 && i < N) {
            store_fr(ws, L.rcp + 3 * i, p0);
            store_fr(ws, L.rcp + 3 * i + 1, p2);
          }
        }
        __syncthreads();
        // each instance's coefficients from p(0), p(1) = claim - p(0), p(2)
        const Fr inv2 = load_fr(ws, sc.inv2);
        Fr a0 = fr_zero(), a1 = fr_zero(), a2 = fr_zero();
        for (int64_t i = tid; i < N; i += OH_THREADS) {
          const Fr p0 = load_fr(ws, L.rcp + 3 * i);
          const Fr p2 = load_fr(ws, L.rcp + 3 * i + 1);
          const Fr p1 = fr_sub(load_fr(ws, L.rcc + i), p0);
          const Fr c2 = fr_mul(fr_add(fr_sub(p2, fr_add(p1, p1)), p0), inv2);
          const Fr c1 = fr_sub(fr_sub(p1, p0), c2);
          store_fr(ws, L.rcp + 3 * i + 1, c1);
          store_fr(ws, L.rcp + 3 * i + 2, c2);
          const Fr cf = load_fr(ws, sc.coef + 1 + i);
          a0 = fr_add(a0, fr_mul(cf, p0));
          a1 = fr_add(a1, fr_mul(cf, c1));
          a2 = fr_add(a2, fr_mul(cf, c2));
        }
        a0 = block_sum(a0, warp_sums);
        a1 = block_sum(a1, warp_sums);
        a2 = block_sum(a2, warp_sums);
        if (tid == 0) {
          store_fr(part, 4 * nB, a0);
          store_fr(part, 4 * nB + 1, a1);
          store_fr(part, 4 * nB + 2, a2);
        }
      } else {  // the close: each G row's value
        for (int64_t d = tid; d < D; d += OH_THREADS)
          store_fr(ws, L.out + D + d, fr_canon(load_fr(ws, L.GB + d * K)));
      }
    }
  }

  // ---- the last block: the batched polynomial
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (rnd < M) {
    Fr q0 = fr_zero(), q2 = fr_zero();
    for (int64_t b = tid; b < nB; b += OH_THREADS) {
      q0 = fr_add(q0, ldcg_fr(part, 4 * b));
      q2 = fr_add(q2, ldcg_fr(part, 4 * b + 1));
    }
    q0 = block_sum(q0, warp_sums);
    q2 = block_sum(q2, warp_sums);
    if (tid == 0) {
      Fr es = load_fr(ws, L.es), claim = fr_zero();
      if (rnd > 0) {  // the previous round's line at r, the claim s(r)
        const Fr pl0 = load_fr(ws, L.l0 + rnd - 1),
                 pl1 = load_fr(ws, sc.rb + rnd - 1);
        es = fr_mul(es, fr_add(pl0, fr_mul(r, fr_sub(pl1, pl0))));
        store_fr(ws, L.es, es);
        claim = load_fr(ws, L.sB + 3);
        for (int k = 2; k >= 0; --k)
          claim = fr_add(load_fr(ws, L.sB + k), fr_mul(r, claim));
      }
      const Fr l0 = load_fr(ws, L.l0 + rnd), l1 = load_fr(ws, sc.rb + rnd);
      const Fr e0 = fr_mul(es, q0), e2 = fr_mul(es, q2);
      const Fr e1 =
          fr_mul(fr_sub(claim, fr_mul(l0, e0)), load_fr(ws, sc.inv + rnd));
      const Fr E2 = fr_mul(fr_add(fr_sub(e2, fr_add(e1, e1)), e0),
                           load_fr(ws, sc.inv2));
      const Fr E1 = fr_sub(fr_sub(e1, e0), E2);
      const Fr b = fr_sub(l1, l0);
      Fr s[4];
      s[0] = fr_mul(l0, e0);
      s[1] = fr_add(fr_mul(l0, E1), fr_mul(b, e0));
      s[2] = fr_add(fr_mul(l0, E2), fr_mul(b, E1));
      s[3] = fr_mul(b, E2);
      const Fr cb = load_fr(ws, sc.coef);
      for (int k = 0; k < 4; ++k) {
        store_fr(ws, L.sB + k, s[k]);
        Fr o = fr_mul(cb, s[k]);
        if (N > 0 && k < 3) o = fr_add(o, ldcg_fr(part, 4 * nB + k));
        store_fr(ws, L.out + k, fr_canon(o));
      }
    }
    if (rnd >= 1 && rnd <= logK)  // U after this round's bind
      for (int64_t k = tid; k < K; k += OH_THREADS)
        store_fr(ws, L.U + (rnd & 1) * K + k, oh_u(L, ws, rnd, k, r, r0));
  }
  if (tid == 0) *counter = 0;
}

}  // namespace jolt

namespace {

jolt::OhLay oh_layout(const void* lay) {
  jolt::OhLay L;
  static_assert(sizeof(jolt::OhLay) == jolt::OH_FIELDS * sizeof(int64_t),
                "OhLay: 29 int64 fields");
  const int64_t* f = reinterpret_cast<const int64_t*>(lay);
  int64_t* o = reinterpret_cast<int64_t*>(&L);
  for (int i = 0; i < jolt::OH_FIELDS; ++i) o[i] = f[i];
  return L;
}

bool oh_valid(const jolt::OhLay& L) {
  return L.M >= 2 && L.M <= jolt::OH_MAX_VARS && L.logK >= 1 &&
         L.logT >= 1 && L.logK + L.logT == L.M && L.K == (int64_t)1 << L.logK &&
         L.T == (int64_t)1 << L.logT && L.D >= 1 && L.N >= 0 && L.S >= 0;
}

}  // namespace

// ws: the workspace ((rows, 4) u64, device/onehot.py:Layout), lay: the
// layout's 29 int64 fields (host memory). The set-up's first launch
// (scalars into Montgomery form, the eq tables, U and es). One launch on
// `stream`, no allocation; returns cudaGetLastError().
extern "C" int jolt_onehot_prepare(void* ws, const void* lay, void* stream) {
  const jolt::OhLay L = oh_layout(lay);
  if (!oh_valid(L)) return (int)cudaErrorInvalidValue;
  const int64_t n_all = 3 * L.T - 1 + L.K - 1;
  int64_t blocks = (n_all + jolt::OH_THREADS - 1) / jolt::OH_THREADS;
  if (blocks > jolt::OH_MAX_BLOCKS) blocks = jolt::OH_MAX_BLOCKS;
  jolt::onehot_prepare_kernel<<<(unsigned)blocks, jolt::OH_THREADS, 0,
                                (cudaStream_t)stream>>>(L, (jolt::u64*)ws);
  return (int)cudaGetLastError();
}

// The set-up's second launch: the bucket sums GB and H, a block a (value,
// chunk row). idx: the (D, T) chunk indices, bytes (or int32 where
// lay.wide). One launch on `stream`; returns cudaGetLastError().
extern "C" int jolt_onehot_buckets(void* ws, const void* lay, const void* idx,
                                   void* stream) {
  const jolt::OhLay L = oh_layout(lay);
  if (!oh_valid(L) || L.D > 65535) return (int)cudaErrorInvalidValue;
  jolt::onehot_buckets_kernel<<<dim3((unsigned)L.K, (unsigned)L.D),
                                jolt::OH_THREADS, 0, (cudaStream_t)stream>>>(
      L, (jolt::u64*)ws, idx);
  return (int)cudaGetLastError();
}

// Round rnd (0 .. M; M is the close) at the previous challenge, canonical
// words w0..w3 (least significant first). counter: one u32, 0 before the
// launch and after it. If out_host is given (pinned host memory), the
// round's `out` rows (nout of them) are copied there and the stream is
// synchronised: the round's one fetch. Returns the first CUDA error.
extern "C" int jolt_onehot_round(void* ws, const void* lay, const void* idx,
                                 int64_t rnd, unsigned long long w0,
                                 unsigned long long w1, unsigned long long w2,
                                 unsigned long long w3, void* counter,
                                 void* out_host, int64_t nout, void* stream) {
  const jolt::OhLay L = oh_layout(lay);
  if (!oh_valid(L) || rnd < 0 || rnd > L.M || nout < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t nB = jolt::oh_booleanity_blocks(L, rnd);
  cudaStream_t s = (cudaStream_t)stream;
  jolt::onehot_round_kernel<<<(unsigned)(nB + 1), jolt::OH_THREADS, 0, s>>>(
      L, (jolt::u64*)ws, idx, rnd, w0, w1, w2, w3, nB, (unsigned*)counter);
  int rc = (int)cudaGetLastError();
  if (rc != 0 || out_host == nullptr) return rc;
  rc = (int)cudaMemcpyAsync(out_host, (jolt::u64*)ws + 4 * L.out, nout * 32,
                            cudaMemcpyDeviceToHost, s);
  if (rc != 0) return rc;
  return (int)cudaStreamSynchronize(s);
}
