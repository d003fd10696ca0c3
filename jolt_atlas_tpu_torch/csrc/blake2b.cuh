// BLAKE2b-256 and the Fiat-Shamir transcript steps built on it, as device
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
// One transcript step is a serial chain of 12 x 8 mixing steps; it runs on
// one thread, once a round, and is bound by its latency, not by the card.
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

__device__ __forceinline__ void b2_mix(u64 v[16], int a, int b, int c, int d,
                                       u64 x, u64 y) {
  v[a] = v[a] + v[b] + x;
  v[d] = b2_rotr(v[d] ^ v[a], 32);
  v[c] = v[c] + v[d];
  v[b] = b2_rotr(v[b] ^ v[c], 24);
  v[a] = v[a] + v[b] + y;
  v[d] = b2_rotr(v[d] ^ v[a], 16);
  v[c] = v[c] + v[d];
  v[b] = b2_rotr(v[b] ^ v[c], 63);
}

// One BLAKE2b compression of the block m into h; t is the byte count so
// far (this block included), last sets the final-block flag.
__device__ __forceinline__ void blake2b_compress(u64 h[8], const u64 m[16],
                                                 u64 t, bool last) {
  constexpr unsigned char SIGMA[12][16] = {
      {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
      {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
      {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
      {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
      {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
      {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
      {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
      {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
      {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
      {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
      {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
      {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3}};
  u64 v[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    v[i] = h[i];
    v[i + 8] = b2_iv(i);
  }
  v[12] ^= t;
  if (last) v[14] = ~v[14];
#pragma unroll
  for (int r = 0; r < 12; ++r) {
    const unsigned char* s = SIGMA[r];
    b2_mix(v, 0, 4, 8, 12, m[s[0]], m[s[1]]);
    b2_mix(v, 1, 5, 9, 13, m[s[2]], m[s[3]]);
    b2_mix(v, 2, 6, 10, 14, m[s[4]], m[s[5]]);
    b2_mix(v, 3, 7, 11, 15, m[s[6]], m[s[7]]);
    b2_mix(v, 0, 5, 10, 15, m[s[8]], m[s[9]]);
    b2_mix(v, 1, 6, 11, 12, m[s[10]], m[s[11]]);
    b2_mix(v, 2, 7, 8, 13, m[s[12]], m[s[13]]);
    b2_mix(v, 3, 4, 9, 14, m[s[14]], m[s[15]]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] ^= v[i] ^ v[i + 8];
}

// st = BLAKE2b-256(st || 28 zero bytes || n_rounds big-endian || payload),
// payload being np little-endian u64 words (8 * np bytes)
__device__ __forceinline__ void transcript_absorb_long(u64 st[4],
                                                       u32 n_rounds,
                                                       const u64* payload,
                                                       int np) {
  u64 h[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = b2_iv(i);
  h[0] ^= 0x01010020ull;  // keyless, 32-byte digest
  const int nwords = 8 + np;
  int done = 0;  // message words compressed so far
  u64 m[16];
  for (;;) {
    const bool last = nwords - done <= 16;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int k = done + j;
      u64 w = 0;
      if (k < 4) {
        w = st[k];
      } else if (k == 7) {
        w = (u64)bswap32(n_rounds) << 32;  // bytes 60..63
      } else if (k >= 8 && k < nwords) {
        w = payload[k - 8];
      }
      m[j] = w;
    }
    if (last) {
      blake2b_compress(h, m, 8ull * nwords, true);
      break;
    }
    done += 16;
    blake2b_compress(h, m, 8ull * done, false);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) st[i] = h[i];
}

// an absorb of one 32-byte payload (four words): one compression
__device__ __forceinline__ void transcript_absorb(u64 st[4], u32 n_rounds,
                                                  const u64 payload[4]) {
  transcript_absorb_long(st, n_rounds, payload, 4);
}

// a squeeze: the 64-byte prefix alone; st becomes the 32-byte digest
__device__ __forceinline__ void transcript_squeeze(u64 st[4], u32 n_rounds) {
  transcript_absorb_long(st, n_rounds, nullptr, 0);
}

}  // namespace jolt
