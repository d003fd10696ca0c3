// BLAKE2b-256 and the Fiat-Shamir transcript step built on it, as device
// functions: the tail kernel of the opening reduction (reduction.cu) absorbs
// each round message and squeezes the round challenge on the card.
//
// Replaces jolt_atlas_tpu/tpu/blake2b.py (compress, bswap32,
// transcript_absorb, transcript_absorb_long, transcript_squeeze). The TPU
// version carried each 64-bit word as a (lo, hi) pair of u32 because the
// TPU has no 64-bit integer lanes; Hopper adds u64 natively (two 32-bit adds
// with carry) and rotates with funnel shifts, so a word is one u64 here.
//
// The transcript (transcripts/blake2b.py) hashes
//   state[32] || 28 zero bytes || n_rounds (4 bytes, big-endian) || payload
// with BLAKE2b-256 and takes the digest as the new state: an absorb carries
// a 32-byte payload, a long absorb any multiple of 8 bytes (the round
// message: "UniPoly\x01" and two 32-byte coefficients, 136 bytes in all,
// two compressions), a squeeze none. Words are little-endian u64 of the
// message bytes, so state word 0 holds state bytes 0..7.
//
// A transcript step is a serial chain of 12 rounds of two mix steps, each
// of four independent mixes; it runs once a round and is bound by its
// latency, not by the card. Four lanes of a warp run one step together, a
// mix each (blake2b_compress_x4), so a warp issues one mix's instructions
// a step where one thread would issue four.
#pragma once

#include <cstdint>

namespace jolt {

typedef unsigned long long u64;
typedef uint32_t u32;

__device__ __forceinline__ u64 b2_iv(int i) {
  constexpr u64 IV[8] = {0x6a09e667f3bcc908ull, 0xbb67ae8584caa73bull,
                         0x3c6ef372fe94f82bull, 0xa54ff53a5f1d36f1ull,
                         0x510e527fade682d1ull, 0x9b05688c2b3e6c1full,
                         0x1f83d9abfb41bd6bull, 0x5be0cd19137e2179ull};
  return IV[i];
}

__device__ __forceinline__ u64 b2_rotr(u64 x, int n) {
  return (x >> n) | (x << (64 - n));
}

__device__ __forceinline__ u32 bswap32(u32 x) {
  return __byte_perm(x, 0, 0x0123);
}

__device__ __forceinline__ u64 bswap64(u64 x) {
  return ((u64)bswap32((u32)x) << 32) | bswap32((u32)(x >> 32));
}

// ---------------------------------------------------------------------------
// One compression spread over four lanes of a warp (q = lane & 3; the
// calling lanes are q = 0..3 of one group and run it together). Lane q
// holds column q of the work vector, a = v[q], b = v[4 + q], c = v[8 + q],
// d = v[12 + q], and runs that column's mix; the diagonal mixes take b, c
// and d from lanes q + 1, q + 2, q + 3 by shuffles and hand them back. The
// four mixes of a step are then one instruction stream, not four after one
// another. h: lane q holds h[q] (hl) and h[4 + q] (hh); m: the block's 16
// words in shared memory, read by each lane's own SIGMA entries (SIGMA's
// rows packed a nibble an entry).
// ---------------------------------------------------------------------------

__device__ __forceinline__ u64 b2_sigma(int r) {
  constexpr u64 S[12] = {
      0xfedcba9876543210ull, 0x357b20c16df984aeull, 0x491763eadf250c8bull,
      0x8f04a562ebcd1397ull, 0xd386cb1efa427509ull, 0x91ef57d438b0a6c2ull,
      0xb8293670a4def15cull, 0xa2684f05931ce7bdull, 0x5a417d2c803b9ef6ull,
      0x0dc3e9bf5167482aull, 0xfedcba9876543210ull, 0x357b20c16df984aeull};
  return S[r];
}

// b2_iv(q) or b2_iv(4 + q) for a lane's own q, without indexing a local
// array
__device__ __forceinline__ u64 b2_iv_lane(int q, int hi) {
  const u64 a = b2_iv(4 * hi), b = b2_iv(4 * hi + 1), c = b2_iv(4 * hi + 2),
            d = b2_iv(4 * hi + 3);
  return q == 0 ? a : q == 1 ? b : q == 2 ? c : d;
}

__device__ __forceinline__ void b2_g(u64& a, u64& b, u64& c, u64& d, u64 x,
                                     u64 y) {
  a = a + b + x;
  d = b2_rotr(d ^ a, 32);
  c = c + d;
  b = b2_rotr(b ^ c, 24);
  a = a + b + y;
  d = b2_rotr(d ^ a, 16);
  c = c + d;
  b = b2_rotr(b ^ c, 63);
}

__device__ __forceinline__ void blake2b_compress_x4(u64& hl, u64& hh,
                                                    const u64* m, u64 t,
                                                    bool last) {
  const int q = threadIdx.x & 3;
  const unsigned g = 0xfu << (threadIdx.x & 28);  // this group's lanes
  u64 a = hl, b = hh, c = b2_iv_lane(q, 0), d = b2_iv_lane(q, 1);
  if (q == 0) d ^= t;
  if (q == 2 && last) d = ~d;
#pragma unroll
  for (int r = 0; r < 12; ++r) {
    const u64 s = b2_sigma(r);
    b2_g(a, b, c, d, m[(s >> (8 * q)) & 15], m[(s >> (8 * q + 4)) & 15]);
    b = __shfl_sync(g, b, q + 1, 4);
    c = __shfl_sync(g, c, q + 2, 4);
    d = __shfl_sync(g, d, q + 3, 4);
    b2_g(a, b, c, d, m[(s >> (32 + 8 * q)) & 15],
         m[(s >> (36 + 8 * q)) & 15]);
    b = __shfl_sync(g, b, q + 3, 4);
    c = __shfl_sync(g, c, q + 2, 4);
    d = __shfl_sync(g, d, q + 1, 4);
  }
  hl ^= a ^ c;
  hh ^= b ^ d;
}

// One transcript step on four lanes (as blake2b_compress_x4): lane q holds
// state word st (word q) and gets the new one; payload: np words (shared or
// global memory); m: a 16-word block buffer in shared memory.
__device__ __forceinline__ void transcript_step_x4(u64& st, u32 n_rounds,
                                                   const u64* payload,
                                                   int np, u64* m) {
  const int q = threadIdx.x & 3;
  const unsigned g = 0xfu << (threadIdx.x & 28);
  const int nwords = 8 + np;
  u64 hl = b2_iv_lane(q, 0) ^ (q == 0 ? 0x01010020ull : 0ull);
  u64 hh = b2_iv_lane(q, 1);
  for (int done = 0; done < nwords; done += 16) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // words k = done + 4 j + q
      const int k = done + 4 * j + q;
      u64 w = 0;
      if (k < 4) {
        w = st;
      } else if (k == 7) {
        w = (u64)bswap32(n_rounds) << 32;
      } else if (k >= 8 && k < nwords) {
        w = payload[k - 8];
      }
      m[4 * j + q] = w;
    }
    __syncwarp(g);
    const bool last = nwords - done <= 16;
    blake2b_compress_x4(hl, hh, m, last ? 8ull * nwords : 8ull * (done + 16),
                        last);
    __syncwarp(g);  // m is written again
  }
  st = hl;
}

}  // namespace jolt
