// Kernel 9: the exact integer matrix product of the quantized forward.
//
// Replaces the XLA program jolt_atlas_tpu/jaxexec.py exact_matmul_rescale
// (:34) with _digits_rescale_saturate (:71), and the int64 jnp.einsum of
// its general Einsum branch (:163-167). For each batch b, row m and column
// n:
//
//   s = sum_{k < K} a[b, m, k] b[b, k, n]            (i32 operands)
//   out[b, m, n] = sat_i32(floor(s / 2^shift))
//
// held exactly (|s| < 2^74 for K <= 4096) or, with `wrap`, s taken mod
// 2^64 as a signed int64 first, as XLA's s64 einsum wraps.
//
// The reference runs this on the MXU as 16 products of 8-bit limbs; so
// does this kernel, on Hopper's int8 tensor cores (wgmma). The
// little-endian bytes of an i32 are its limbs: bytes 0-2 unsigned (u8),
// byte 3 the signed top limb (s8), x = sum_i X_i 2^(8i). The 16 limb
// products fall into 7 digit sums D_t = sum_{i + j = t} A_i B_j (s = sum_t
// D_t 2^(8t)), each an int32 accumulator: |D_t| <= 2 (255^2 + 255 * 128) K
// < 2^31 for K <= 8192 (D_3, the largest, has two u8 x u8 and two u8 x s8
// terms).
//
// Bound: at 1024 x 768 x 3072 the 16 limb products are 77.3 G int8
// operations, 0.0391 ms at 1,979 TOP/s (H100 SXM, dense), against 25.2 MB
// of operands and output (4 (MK + KN + MN) bytes, 7.5 us at 3.35 TB/s):
// operations. At 16 x 1024 x 4096 (a GPT-2 MLP product at seq 16) the
// 17.1 MB of bytes bound it, 5.1 us.
//
// Design. The 7 digits take 7 int32 accumulators an output, so the
// register file caps a block's tile: 64 x 64, two compute warpgroups of
// m64n32k32 (a's 64 rows by 32 of b's columns, 112 accumulators a
// thread), or for M <= 16, 16 x 64, one of m64n16k32 with b's 64 columns
// as its rows (the output transposed in the accumulators). A persistent
// grid, a block an SM, walks the tiles, so that one tile's epilogue
// overlaps the next one's copies.
//   - A copy warpgroup moves 64-deep slices of a's rows and b's columns,
//     as int32, into a ring of three raw stages (cp.async, completing on
//     an mbarrier a stage): 16 bytes along k where the operand is
//     K-contiguous, along its rows where it is M- or N-contiguous (as b is
//     in the forward's products), 4 bytes otherwise, zero past the edges.
//     It hands most of its registers to the compute warpgroups
//     (setmaxnreg).
//   - The compute warpgroups split each slice's words with 8 byte
//     permutes a group of 4 into four limb planes in wgmma's K-major
//     no-swizzle core matrices (three limb stages), and multiply them: a
//     k32 step is 16 wgmma, u8 or s8 by limb, P's limbs in registers
//     (ldmatrix), Q's read by descriptor. The next slice's split runs in
//     four parts between the four batches of the current slice's wgmma
//     (a's limbs 0-3), so that it overlaps the tensor cores.
//   - The epilogue forms s = L + X 2^32 (L = D_0 .. D_3, X = D_4 .. D_6 in
//     int64) as two words once, floor-shifts, saturates and stores one
//     int32.
// Where the tiles do not fill the card (torchexec.exact_plan) the depth is
// split into tiles of its own: each writes its 7 digit sums to an int32
// workspace and exact_matmul_finish sums them in int64 per output. The
// wrapping mode always splits at most every 8,192 of depth, so that every
// digit sum stays exact in int32 for any K. Operands are read through
// their strides (any layout; a batch stride of 0 broadcasts), so the
// wrapper never copies a transposed operand.
//
// What bounds it (NVIDIA H100, scripts/exact_kernel_bench.py --phases):
// the copy warpgroup issues copies most of the run, and the compute
// warpgroups spend their time in the wgmma issue with the split between
// (PERF.md): moving the int32 operands into shared memory, not the tensor
// cores. The 64 x 64 tile reads each operand N / 64 or M / 64 times from
// L2. TMA copies, and clusters sharing an operand's slices, are the next
// steps.
#include <cuda_runtime.h>
#include <stdint.h>

namespace jolt {

constexpr int EXACT_DIGITS = 7;
constexpr int EXACT_MAX_CHUNK = 8192;  // depth a tile: int32 digit sums

// floor(s / 2^k) for either sign, with no right shift of a negative value
// (whose rounding C++ leaves to the implementation): for s < 0 it is
// ~(~s >> k), and ~s = -s - 1 >= 0 never overflows
template <typename T>
__device__ __forceinline__ T floor_shift(T s, int k) {
  return s >= 0 ? (s >> k) : ~((~s) >> k);
}

// the output of one position from its 7 digit sums: s = L + X 2^32 with
// L = D_0 + D_1 2^8 + D_2 2^16 + D_3 2^24 and X = D_4 + D_5 2^8 + D_6 2^16,
// formed in wrapping uint64 (exact as int64 when every |D_t| < 2^31, as
// for K <= 8192: |L| < 2^56, |X| < 2^48), then as a two-word integer hi
// 2^64 + lo; floor(s / 2^shift), saturated to i32. With `wrap` only lo
// matters, s mod 2^64 as a signed int64, whatever the digits' size.
__device__ __forceinline__ int32_t exact_out(const int64_t* d, int shift,
                                             int wrap) {
  const uint64_t L = (uint64_t)d[0] + ((uint64_t)d[1] << 8) +
                     ((uint64_t)d[2] << 16) + ((uint64_t)d[3] << 24);
  const uint64_t X = (uint64_t)d[4] + ((uint64_t)d[5] << 8) +
                     ((uint64_t)d[6] << 16);
  const uint64_t add = X << 32;
  const uint64_t lo = L + add;
  int64_t q;
  if (wrap) {
    q = floor_shift((int64_t)lo, shift);
  } else {
    const int64_t hi = floor_shift((int64_t)L, 63) +
                       floor_shift((int64_t)X, 32) + (lo < add);
    // floor(s / 2^shift) = (hi 2^64 + lo) >> shift, two words
    const uint64_t qlo = shift ? (lo >> shift) | ((uint64_t)hi << (64 - shift))
                               : lo;
    const int64_t qhi = floor_shift(hi, shift);
    if (qhi != floor_shift((int64_t)qlo, 63))  // beyond int64
      return qhi < 0 ? INT32_MIN : INT32_MAX;
    q = (int64_t)qlo;
  }
  return q > INT32_MAX ? INT32_MAX : (q < INT32_MIN ? INT32_MIN : (int32_t)q);
}

// the limb-l bytes of four words: limb l of v[0..3] in bytes 0..3
__device__ __forceinline__ void limb_words(const int32_t v[4],
                                           uint32_t w[4]) {
  const uint32_t t0 = __byte_perm(v[0], v[1], 0x5140);
  const uint32_t t1 = __byte_perm(v[0], v[1], 0x7362);
  const uint32_t t2 = __byte_perm(v[2], v[3], 0x5140);
  const uint32_t t3 = __byte_perm(v[2], v[3], 0x7362);
  w[0] = __byte_perm(t0, t2, 0x5410);
  w[1] = __byte_perm(t0, t2, 0x7632);
  w[2] = __byte_perm(t1, t3, 0x5410);
  w[3] = __byte_perm(t1, t3, 0x7632);
}

// wgmma's shared-memory matrix descriptor, no swizzle, K-major: the
// operand is 8 x 16-byte core matrices (8 rows of 16 bytes, 128 bytes
// contiguous); LBO the bytes between core matrices along K, SBO between
// 8-row groups
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void gmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void gmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void gmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// the shared-memory stores of the generic proxy made visible to wgmma's
// reads (the async proxy)
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d += P Q over one m64nNk32 product of 8-bit limbs (P: 64 rows, a
// warpgroup's fragments in registers; Q: N rows, K-major in shared memory
// through a descriptor); a limb is signed (SP, SQ) where it is an
// operand's top limb
#define JOLT_GMMA_TYPES(SP, SQ, CALL)                                      \
  if (SP && SQ) CALL("s8", "s8");                                          \
  else if (SP) CALL("s8", "u8");                                           \
  else if (SQ) CALL("u8", "s8");                                           \
  else CALL("u8", "u8")

template <bool SP, bool SQ>
__device__ __forceinline__ void gmma_r32(int32_t* d, const uint32_t* a,
                                         uint64_t dq) {
#define JOLT_GMMA32R(TP, TQ)                                               \
  asm volatile(                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n32k32.s32." TP "." TQ " "          \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
      "%15}, {%16, %17, %18, %19}, %20, p;\n}\n"                           \
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),        \
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),        \
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),   \
        "+r"(d[15])                                                        \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(dq))
  JOLT_GMMA_TYPES(SP, SQ, JOLT_GMMA32R);
#undef JOLT_GMMA32R
}

template <bool SP, bool SQ>
__device__ __forceinline__ void gmma_r16(int32_t* d, const uint32_t* a,
                                         uint64_t dq) {
#define JOLT_GMMA16R(TP, TQ)                                               \
  asm volatile(                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n16k32.s32." TP "." TQ " "          \
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p;\n}\n" \
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),        \
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7])                                 \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(dq))
  JOLT_GMMA_TYPES(SP, SQ, JOLT_GMMA16R);
#undef JOLT_GMMA16R
}

template <int QN, bool SP, bool SQ>
__device__ __forceinline__ void gmma_r(int32_t* d, const uint32_t* a,
                                       uint64_t dq) {
  if (QN == 32) gmma_r32<SP, SQ>(d, a, dq);
  else gmma_r16<SP, SQ>(d, a, dq);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// How an operand's slices are copied: 16 bytes along k (K_MAJOR: k
// contiguous), 16 bytes along its rows (ROW_MAJOR: m of a or n of b
// contiguous), or 4 bytes at a time (ANY), each aligned as it needs
enum ExactMode { ANY = 0, K_MAJOR = 1, ROW_MAJOR = 2 };
// an operand (rows: m of a, n of b) read through its strides
struct ExactOperand {
  const int32_t* p;  // this tile's batch
  int64_t rows, s_row, s_k;
  int mode;
};

// A block's tile. Each compute warpgroup computes 64 P rows x QN Q rows
// of the output with m64nQNk32: P is a (rows m) and Q is b (columns n),
// or with TRANS P is b and Q is a, for M <= 16 (the output transposed in
// the accumulators). The block's last warpgroup copies the slices.
// Shared memory holds a's BM rows, then b's BN columns: as int32 words in
// the raw stages, as rows of BK limb bytes in four limb planes of core
// matrices in the limb stages.
template <int BM_, int BN_, int WGS, int QN_, bool TRANS_>
struct ExactTile {
  static constexpr int BM = BM_, BN = BN_, BK = 64, QN = QN_;
  static constexpr bool TRANS = TRANS_;
  static constexpr int COMPUTE = WGS * 128;   // threads that split and MMA
  static constexpr int THREADS = COMPUTE + 128;  // and the copy warpgroup
  // registers a thread: with two compute warpgroups the launch gives 168
  // (three warps share each quarter of the register file), and the copy
  // warpgroup hands most of its share to the compute warpgroups. A
  // request for all of a quarter's 16,384 is never granted (it hangs), so
  // 64 + 2 x 216 < 512; less for the copy warpgroup spills there.
  static constexpr bool MOVE_REGS = WGS == 2;
  static constexpr int COPY_REGS = 64, COMPUTE_REGS = 216;
  static_assert(COPY_REGS + 2 * COMPUTE_REGS < 512, "a quarter's 16,384");
  static constexpr int ROWS = BM + BN;
  static constexpr int SBO = 8 * BK;            // bytes an 8-row group
  static constexpr int PLANE = ROWS * BK;       // bytes a limb plane
  static constexpr int STAGE = 4 * PLANE;       // a slice's limb planes
  static constexpr int LIMB_STAGES = 3;
  // the int32 slices, a's then b's: an operand of R rows as R rows of BK
  // words (K_MAJOR, ANY) or BK rows of R words (ROW_MAJOR), each row with
  // 4 words of padding (a quarter warp's 16-byte reads of 8 rows fall in
  // distinct banks)
  static constexpr int RAW_A = 4 * (BM * (BK + 4) > BK * (BM + 4)
                                        ? BM * (BK + 4) : BK * (BM + 4));
  static constexpr int RAW_B = 4 * (BN * (BK + 4) > BK * (BN + 4)
                                        ? BN * (BK + 4) : BK * (BN + 4));
  static constexpr int RAW = RAW_A + RAW_B;
  static constexpr int RAW_STAGES = 3;
  static constexpr int BARS = 128;  // the raw stages' mbarriers, aligned
  static constexpr int SMEM = BARS + RAW_STAGES * RAW + LIMB_STAGES * STAGE;
  static constexpr int KG = BK / 4;             // 4-deep groups a row
  static constexpr int GROUPS = ROWS * KG;
  static constexpr int A_GROUPS = BM * KG;      // a's groups come first
  static constexpr int ACC = QN / 2;            // accumulators a digit
  static_assert(GROUPS % COMPUTE == 0 && A_GROUPS % 128 == 0 &&
                KG == 16 && 8 * RAW_STAGES <= BARS,
                "whole groups a thread, 4 of k a warp's 32");
  static_assert(TRANS ? (BM == QN && BN == 64 * WGS)
                      : (BM == 64 && BN == QN * WGS), "warpgroup tiles");
};

// Group g of a slice: a run of 32 groups is 8 rows x 4 groups of k, one
// 128-byte core matrix of each limb plane (conflict-free stores)
template <class T>
__device__ __forceinline__ void group_at(int g, int& row, int& kg) {
  const int lane = g & 31, w = g >> 5;
  row = (w / (T::KG / 4)) * 8 + (lane & 7);
  kg = (w % (T::KG / 4)) * 4 + (lane >> 3);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}
// 4 bytes, or 4 zero bytes where !ok (nothing is read)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0));
}
// the mbarrier's pending arrival, once this thread's copies have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// One group of 4 int32 (row r, k .. k + 3; zero past the edges) copied
// to dst in shared memory (a K_MAJOR or ANY raw stage): one 16-byte copy
// where it can be
__device__ __forceinline__ void copy_group(uint32_t dst,
                                           const ExactOperand& x, int64_t r,
                                           int64_t k, int64_t kend) {
  const bool in = r < x.rows;
  if (in && x.mode == K_MAJOR && k + 3 < kend) {
    cp_async16(dst, x.p + r * x.s_row + k);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = in && k + j < kend;
      cp_async4(dst + 4 * j, ok ? x.p + r * x.s_row + (k + j) * x.s_k : x.p,
                ok);
    }
  }
}

// Copy thread ct's share of one operand's slice (R rows from r0, k0 ..
// kend) into its raw region at dst. K_MAJOR and ANY: groups of 4 k of
// one row (ct + 128 e; a thread's groups share one k offset and step 8
// rows); ROW_MAJOR: groups of 4 rows at one k (a warp's 32 on 64
// consecutive rows at 2 k; a thread's step 128 / (R / 4) k).
template <class T, int R>
__device__ __forceinline__ void copy_operand(int ct, uint32_t dst,
                                             const ExactOperand& x,
                                             int64_t r0, int64_t k0,
                                             int64_t kend) {
  if (x.mode == ROW_MAJOR) {
    constexpr int G = R / 4, STEP = 128 / G;
    static_assert(128 % G == 0 && T::BK % STEP == 0, "row groups");
    const int row = 4 * (ct % G);
    const int64_t r = r0 + row;
    const bool full = r + 3 < x.rows;
#pragma unroll 2
    for (int k = ct / G; k < T::BK; k += STEP) {
      const uint32_t at = dst + (k * (R + 4) + row) * 4;
      const int64_t kk = k0 + k;
      if (full && kk < kend) {
        cp_async16(at, x.p + r + kk * x.s_k);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = r + j < x.rows && kk < kend;
          cp_async4(at + 4 * j, ok ? x.p + r + j + kk * x.s_k : x.p, ok);
        }
      }
    }
    return;
  }
  int row, kg;
  group_at<T>(ct, row, kg);
  if (x.mode == K_MAJOR && k0 + T::BK <= kend) {
    int64_t r = r0 + row;
    const int32_t* src = x.p + r * x.s_row + k0 + 4 * kg;
    uint32_t at = dst + (row * (T::BK + 4) + 4 * kg) * 4;
#pragma unroll 2
    for (int e = 0; e < R * T::KG / 128; ++e) {
      if (r < x.rows) cp_async16(at, src);
      else copy_group(at, x, x.rows, 0, 0);  // zeros
      r += 8;
      src += 8 * x.s_row;
      at += 8 * (T::BK + 4) * 4;
    }
    return;
  }
#pragma unroll 1
  for (int e = 0; e < R * T::KG / 128; ++e) {
    group_at<T>(ct + 128 * e, row, kg);
    copy_group(dst + (row * (T::BK + 4) + 4 * kg) * 4, x, r0 + row,
               k0 + 4 * kg, kend);
  }
}

// Part C of 4 of this thread's share (groups threadIdx.x + COMPUTE e) of
// slice q, split from its raw stage (of those at raw) into the four limb
// planes of its limb stage (of those at limb) in wgmma's core matrices:
// every group's words are read before any limb is stored
template <class T, int C>
__device__ __forceinline__ void split_part(int q, uint8_t* limb,
                                           const uint8_t* raw, int mode_a,
                                           int mode_b) {
  constexpr int E = T::GROUPS / T::COMPUTE, E0 = E * C / 4,
                E1 = E * (C + 1) / 4;
  const int t = threadIdx.x;
  uint8_t* stage = limb + (q % T::LIMB_STAGES) * T::STAGE;
  raw += (q % T::RAW_STAGES) * T::RAW;
  int32_t v[E1 - E0 + 1][4];
#pragma unroll
  for (int e = E0; e < E1; ++e) {
    int row, kg;
    group_at<T>(t + e * T::COMPUTE, row, kg);
    const bool is_a = e * T::COMPUTE < T::A_GROUPS;  // a warp's groups: one
    const int r = is_a ? row : row - T::BM;          // operand
    const int R = is_a ? T::BM : T::BN;
    const int32_t* x = reinterpret_cast<const int32_t*>(
        raw + (is_a ? 0 : T::RAW_A));
    if ((is_a ? mode_a : mode_b) == ROW_MAJOR) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[e - E0][j] = x[(4 * kg + j) * (R + 4) + r];
    } else {
      const int4 w4 = *reinterpret_cast<const int4*>(x + r * (T::BK + 4) +
                                                     4 * kg);
      v[e - E0][0] = w4.x;
      v[e - E0][1] = w4.y;
      v[e - E0][2] = w4.z;
      v[e - E0][3] = w4.w;
    }
  }
#pragma unroll
  for (int e = E0; e < E1; ++e) {
    int row, kg;
    group_at<T>(t + e * T::COMPUTE, row, kg);
    uint32_t w[4];
    limb_words(v[e - E0], w);
    const int off = (row >> 3) * T::SBO + (kg >> 2) * 128 + (row & 7) * 16 +
                    (kg & 3) * 4;
#pragma unroll
    for (int l = 0; l < 4; ++l)
      *reinterpret_cast<uint32_t*>(stage + l * T::PLANE + off) = w[l];
  }
}

// P's limb fragments of one slice for this warp (ldmatrix from the core
// matrices: a warp's 16 rows at k32 are four 8 x 16-byte matrices, in
// mma.sync's A fragment order); P's rows start at p_row
template <class T>
__device__ __forceinline__ void load_frags(uint32_t pf[][4][4],
                                           uint32_t stage, int p_row) {
  const int warp = (threadIdx.x & 127) >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < T::BK / 32; ++kk)
#pragma unroll
    for (int l = 0; l < 4; ++l)
      ldmatrix_x4(pf[kk][l], stage + l * T::PLANE +
                                 ((p_row >> 3) + 2 * warp + ((lane >> 3) & 1))
                                     * T::SBO +
                                 (2 * kk + (lane >> 4)) * 128 +
                                 (lane & 7) * 16);
}

// The four limb products of a's limb i with b's limbs j = 0..3 over one
// slice for this warpgroup (acc[t]: digit t's accumulators), Q read from
// shared memory through descriptors from q_row
template <class T, int I>
__device__ __forceinline__ void gmma_limb(int32_t acc[][T::ACC],
                                          const uint32_t pf[][4][4],
                                          uint32_t stage, int q_row) {
#pragma unroll
  for (int kk = 0; kk < T::BK / 32; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // a's limb I and b's limb j, in either role
      const int lp = T::TRANS ? j : I, lq = T::TRANS ? I : j;
      const uint64_t dq = gmma_desc(stage + lq * T::PLANE +
                                    (q_row >> 3) * T::SBO + kk * 256,
                                    128, T::SBO);
      if (lp == 3 && lq == 3) gmma_r<T::QN, true, true>(acc[6], pf[kk][lp], dq);
      else if (lp == 3) gmma_r<T::QN, true, false>(acc[I + j], pf[kk][lp], dq);
      else if (lq == 3) gmma_r<T::QN, false, true>(acc[I + j], pf[kk][lp], dq);
      else gmma_r<T::QN, false, false>(acc[I + j], pf[kk][lp], dq);
    }
  }
}

// The launch's output tiles, walked by every block from blockIdx.x in
// steps of gridDim.x (a persistent grid): tile t is column block t % gx,
// row block t / gx % gy, and batch x split z = t / (gx gy).
struct ExactTiles {
  int64_t gx, gy, total, M, K, N, kchunk;
  int splits;
  __device__ __forceinline__ void at(int64_t t, int64_t& z, int64_t& m0,
                                     int64_t& n0, int64_t& kbeg,
                                     int64_t& kend, int bm, int bn) const {
    z = t / (gx * gy);
    n0 = (t % gx) * bn;
    m0 = (t / gx % gy) * bm;
    kbeg = (z % splits) * kchunk;
    kend = kbeg + kchunk < K ? kbeg + kchunk : K;
  }
};

// Phase counters, in a build with -DJOLT_EXACT_PHASES only
// (scripts/exact_kernel_bench.py --phases, which reads them from the
// device symbol jolt_exact_phase_cycles): each warp's clock64 cycles by
// phase, summed over the launch's warps. The copy warpgroup's: 0 its tile
// loop, 1 waiting for a free raw stage, 2 issuing copies, 3 its last
// waits; the compute warpgroups': 8 waiting for a slice's words, 9
// issuing wgmma with the next slice's split between its batches, 10 the
// SLICE barrier, 11 waiting for the wgmma, 12 fragment loads and the
// loop, 13 the epilogue.
#ifdef JOLT_EXACT_PHASES
__device__ unsigned long long jolt_exact_phase_cycles[16];
#define PHASE(i)                                 \
  {                                              \
    const long long now = clock64();             \
    phase[(i) % 8] += now - last;                \
    last = now;                                  \
  }
#define PHASES_ADD(o)                                                     \
  if ((threadIdx.x & 31) == 0)                                            \
    for (int i = 0; i < 8; ++i)                                           \
      atomicAdd(&jolt_exact_phase_cycles[(o) + i],                        \
                (unsigned long long)phase[i]);
#else
#define PHASE(i)
#define PHASES_ADD(o)
#endif

template <class T>
__device__ __forceinline__ void exact_tiles(
    const int32_t* __restrict__ a, const int32_t* __restrict__ b,
    int32_t* __restrict__ out, int32_t* __restrict__ ws, ExactTiles g,
    int64_t sab, int64_t sam, int64_t sak, int64_t sbb, int64_t sbk,
    int64_t sbn, int mode_a, int mode_b, int shift, int wrap) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
  // raw_full[r] (an mbarrier): stage r's copies landed. Named barriers:
  // RAW_FREE + r, stage r split (the compute threads arrive, the copy warp
  // waits); SLICE, a limb stage complete (the compute threads)
  const uint32_t raw_full = base;
  const uint32_t raw_base = base + T::BARS;
  uint8_t* raw = smem + T::BARS;
  uint8_t* limb = raw + T::RAW_STAGES * T::RAW;
  const uint32_t limb_base = raw_base + T::RAW_STAGES * T::RAW;
  constexpr int RAW_FREE = 1, SLICE = 1 + T::RAW_STAGES;
  const int64_t M = g.M, N = g.N;
#ifdef JOLT_EXACT_PHASES
  long long phase[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  long long last = clock64();
#endif
  if (threadIdx.x == 0)
    for (int r = 0; r < T::RAW_STAGES; ++r) mbar_init(raw_full + 8 * r, 128);
  __syncthreads();

  if (threadIdx.x >= T::COMPUTE) {
    // the copy warpgroup: slice q of the block goes to raw stage q %
    // RAW_STAGES once the compute threads have split slice q - RAW_STAGES
    // there
    if (T::MOVE_REGS) setmaxnreg_dec<T::COPY_REGS>();
    const int ct = threadIdx.x - T::COMPUTE;
    int q = 0;
#pragma unroll 1
    for (int64_t t = blockIdx.x; t < g.total; t += gridDim.x) {
      int64_t z, m0, n0, kbeg, kend;
      g.at(t, z, m0, n0, kbeg, kend, T::BM, T::BN);
      const int64_t batch = z / g.splits;
      const ExactOperand A{a + batch * sab, M, sam, sak, mode_a};
      const ExactOperand B{b + batch * sbb, N, sbn, sbk, mode_b};
#pragma unroll 1
      for (int64_t k0 = kbeg; k0 < kend; k0 += T::BK, ++q) {
        const int r = q % T::RAW_STAGES;
        PHASE(0);
        if (q >= T::RAW_STAGES) bar_sync(RAW_FREE + r, T::THREADS);
        PHASE(1);
        const uint32_t dst = raw_base + r * T::RAW;
        copy_operand<T, T::BM>(ct, dst, A, m0, k0, kend);
        copy_operand<T, T::BN>(ct, dst + T::RAW_A, B, n0, k0, kend);
        cp_async_arrive(raw_full + 8 * r);
        PHASE(2);
      }
    }
    // the compute threads' last arrivals
    for (int r = q < T::RAW_STAGES ? 0 : q - T::RAW_STAGES; r < q; ++r)
      bar_sync(RAW_FREE + r % T::RAW_STAGES, T::THREADS);
    PHASE(3);
    PHASES_ADD(0);
    return;
  }

  // the compute threads: the block's slices q = 0, 1, ... (its tiles in
  // turn); slice q + 1 is split from raw stage (q + 1) % RAW_STAGES into
  // limb stage (q + 1) % 3 in four parts between the four batches of slice
  // q's wgmma (a's limbs 0-3), so that the split overlaps the tensor
  // cores. Limb stage (q + 1) % 3 was last read by slice q - 2's wgmma,
  // which every warpgroup waited for before the SLICE barrier of slice q -
  // 1.
  if (T::MOVE_REGS) setmaxnreg_inc<T::COMPUTE_REGS>();
  const int wg = threadIdx.x >> 7, t128 = threadIdx.x & 127;
  const int p_row = T::TRANS ? T::BM + wg * 64 : 0;
  const int q_row = T::TRANS ? 0 : T::BM + wg * T::QN;
  const int warp = t128 >> 5, lane = t128 & 31, gq = lane >> 2, qq = lane & 3;
  int nq = 0;  // the block's slices
  for (int64_t t = blockIdx.x; t < g.total; t += gridDim.x) {
    int64_t z, m0, n0, kbeg, kend;
    g.at(t, z, m0, n0, kbeg, kend, T::BM, T::BN);
    nq += kend > kbeg ? (int)((kend - kbeg + T::BK - 1) / T::BK) : 0;
  }
  // a slice split: its raw stage is free, its limb stage complete once
  // the SLICE barrier passes
  const auto split_done = [&](int qn) {
    bar_arrive(RAW_FREE + qn % T::RAW_STAGES, T::THREADS);
    proxy_fence();
  };
  if (nq > 0) {
    mbar_wait(raw_full, 0);
    split_part<T, 0>(0, limb, raw, mode_a, mode_b);
    split_part<T, 1>(0, limb, raw, mode_a, mode_b);
    split_part<T, 2>(0, limb, raw, mode_a, mode_b);
    split_part<T, 3>(0, limb, raw, mode_a, mode_b);
    split_done(0);
  }
  bar_sync(SLICE, T::COMPUTE);
  int q = 0;
#pragma unroll 1
  for (int64_t t = blockIdx.x; t < g.total; t += gridDim.x) {
    int64_t z, m0, n0, kbeg, kend;
    g.at(t, z, m0, n0, kbeg, kend, T::BM, T::BN);
    int32_t acc[EXACT_DIGITS][T::ACC];
#pragma unroll
    for (int d = 0; d < EXACT_DIGITS; ++d)
#pragma unroll
      for (int c = 0; c < T::ACC; ++c) acc[d][c] = 0;
#pragma unroll 1
    for (int64_t k0 = kbeg; k0 < kend; k0 += T::BK, ++q) {
      const uint32_t st = limb_base + (q % T::LIMB_STAGES) * T::STAGE;
      uint32_t pf[T::BK / 32][4][4];
      load_frags<T>(pf, st, p_row);
      gmma_fence();
      PHASE(12);
      if (q + 1 < nq) {  // one path each, so no wgmma waits on a branch
        mbar_wait(raw_full + 8 * ((q + 1) % T::RAW_STAGES),
                  ((q + 1) / T::RAW_STAGES) & 1);
        PHASE(8);
        gmma_limb<T, 0>(acc, pf, st, q_row);
        split_part<T, 0>(q + 1, limb, raw, mode_a, mode_b);
        gmma_limb<T, 1>(acc, pf, st, q_row);
        split_part<T, 1>(q + 1, limb, raw, mode_a, mode_b);
        gmma_limb<T, 2>(acc, pf, st, q_row);
        split_part<T, 2>(q + 1, limb, raw, mode_a, mode_b);
        gmma_limb<T, 3>(acc, pf, st, q_row);
        split_part<T, 3>(q + 1, limb, raw, mode_a, mode_b);
        gmma_commit();
        split_done(q + 1);
      } else {
        gmma_limb<T, 0>(acc, pf, st, q_row);
        gmma_limb<T, 1>(acc, pf, st, q_row);
        gmma_limb<T, 2>(acc, pf, st, q_row);
        gmma_limb<T, 3>(acc, pf, st, q_row);
        gmma_commit();
      }
      PHASE(9);
      bar_sync(SLICE, T::COMPUTE);
      PHASE(10);
      gmma_wait<0>();  // slice q's: its fragment registers are free
      PHASE(11);
    }
    PHASE(12);
    // the accumulators: register 4 nt + c of a thread holds P row 16 warp
    // + g + 8 (c >> 1), Q row 8 nt + 2 q + (c & 1)
#pragma unroll
    for (int c = 0; c < T::ACC; ++c) {
      const int pr = p_row + 16 * warp + gq + 8 * ((c >> 1) & 1);
      const int qr = q_row + 8 * (c >> 2) + 2 * qq + (c & 1);
      const int64_t m = m0 + (T::TRANS ? qr : pr);
      const int64_t n = n0 + (T::TRANS ? pr : qr) - T::BM;
      if (m >= M || n >= N) continue;
      if (g.splits > 1) {
        int32_t* w = ws + z * EXACT_DIGITS * M * N + m * N + n;
#pragma unroll
        for (int d = 0; d < EXACT_DIGITS; ++d) w[d * M * N] = acc[d][c];
      } else {
        int64_t dg[EXACT_DIGITS];
#pragma unroll
        for (int d = 0; d < EXACT_DIGITS; ++d) dg[d] = acc[d][c];
        out[(z * M + m) * N + n] = exact_out(dg, shift, wrap);
      }
    }
    PHASE(13);
  }
  PHASES_ADD(8);
}

#define JOLT_EXACT_ARGS                                                    \
  const int32_t *__restrict__ a, const int32_t *__restrict__ b,            \
      int32_t *__restrict__ out, int32_t *__restrict__ ws, ExactTiles g,   \
      int64_t sab, int64_t sam, int64_t sak, int64_t sbb, int64_t sbk,     \
      int64_t sbn, int mode_a, int mode_b, int shift, int wrap
#define JOLT_EXACT_PASS                                                    \
  a, b, out, ws, g, sab, sam, sak, sbb, sbk, sbn, mode_a, mode_b, shift,  \
      wrap

// the two tiles (torchexec.EXACT_TILES): 64 x 64, two compute warpgroups
// of 64 x 32; for M <= 16, 16 x 64, one of b's 64 columns x a's 16 rows
using ExactWide = ExactTile<64, 64, 2, 32, false>;
using ExactNarrow = ExactTile<16, 64, 1, 16, true>;

__global__ void __launch_bounds__(ExactWide::THREADS, 1)
exact_matmul_wide(JOLT_EXACT_ARGS) {
  exact_tiles<ExactWide>(JOLT_EXACT_PASS);
}

__global__ void __launch_bounds__(ExactNarrow::THREADS, 1)
exact_matmul_narrow(JOLT_EXACT_ARGS) {
  exact_tiles<ExactNarrow>(JOLT_EXACT_PASS);
}

// The split depth's second launch: sums each output's digit sums over the
// splits in int64 (ws[(batch splits + split) 7 + t][m][n]) and stores it.
__global__ void __launch_bounds__(256)
exact_matmul_finish(const int32_t* __restrict__ ws, int32_t* __restrict__ out,
                    int64_t batch, int64_t MN, int splits, int shift,
                    int wrap) {
  const int64_t i = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= batch * MN) return;
  const int64_t bt = i / MN, r = i % MN;
  int64_t d[EXACT_DIGITS];
#pragma unroll
  for (int t = 0; t < EXACT_DIGITS; ++t) d[t] = 0;
  for (int s = 0; s < splits; ++s) {
    const int32_t* w = ws + (bt * splits + s) * EXACT_DIGITS * MN + r;
#pragma unroll
    for (int t = 0; t < EXACT_DIGITS; ++t) d[t] += w[t * MN];
  }
  out[i] = exact_out(d, shift, wrap);
}

}  // namespace jolt

// out (batch, M, N) int32, contiguous; a and b read through their element
// strides. tile 0: 64 x 64, tile 1: 16 x 128; the depth in `splits` chunks
// of `kchunk` (a multiple of 32, at most 8,192); with splits > 1, ws holds
// batch splits 7 M N int32 (torchexec.exact_plan). K <= 4096 unless wrap;
// 0 <= shift <= 63.
extern "C" int jolt_exact_matmul(const void* a, const void* b, void* out,
                                 void* ws, int64_t batch, int64_t M,
                                 int64_t K, int64_t N, int64_t sab,
                                 int64_t sam, int64_t sak, int64_t sbb,
                                 int64_t sbk, int64_t sbn, int shift,
                                 int wrap, int tile, int splits,
                                 int64_t kchunk, void* stream) {
  const int64_t BM = tile ? jolt::ExactNarrow::BM : jolt::ExactWide::BM;
  const int64_t BN = tile ? jolt::ExactNarrow::BN : jolt::ExactWide::BN;
  if (batch < 0 || M < 0 || N < 0 || K < 0 || shift < 0 || shift > 63 ||
      (!wrap && K > 4096) || tile < 0 || tile > 1 || splits < 1 ||
      kchunk < 32 || kchunk % 32 || kchunk > jolt::EXACT_MAX_CHUNK ||
      (int64_t)splits * kchunk < K ||
      (K > 0 && (int64_t)(splits - 1) * kchunk >= K) ||
      (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || M == 0 || N == 0) return 0;
  // 16-byte copies along k or along the rows where that is contiguous and
  // every copy aligned
  const auto mode = [](const void* p, int64_t s_k, int64_t s_row,
                       int64_t s_batch) {
    if ((uintptr_t)p % 16 || s_batch % 4) return (int)jolt::ANY;
    if (s_k == 1 && s_row % 4 == 0) return (int)jolt::K_MAJOR;
    if (s_row == 1 && s_k % 4 == 0) return (int)jolt::ROW_MAJOR;
    return (int)jolt::ANY;
  };
  const int va = mode(a, sak, sam, sab), vb = mode(b, sbk, sbn, sbb);
  jolt::ExactTiles g{(N + BN - 1) / BN, (M + BM - 1) / BM, 0, M, K, N,
                     kchunk, splits};
  g.total = g.gx * g.gy * batch * splits;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // a persistent grid: a block an SM (its shared memory), each walking the
  // tiles
  const unsigned grid = (unsigned)(g.total < sms ? g.total : sms);
  const cudaStream_t st = (cudaStream_t)stream;
  const int32_t *pa = (const int32_t*)a, *pb = (const int32_t*)b;
  int32_t *po = (int32_t*)out, *pw = (int32_t*)ws;
  if (tile) {
    e = cudaFuncSetAttribute(jolt::exact_matmul_narrow,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             jolt::ExactNarrow::SMEM);
    if (e != cudaSuccess) return (int)e;
    jolt::exact_matmul_narrow<<<grid, jolt::ExactNarrow::THREADS,
                                jolt::ExactNarrow::SMEM, st>>>(
        pa, pb, po, pw, g, sab, sam, sak, sbb, sbk, sbn, va, vb, shift,
        wrap);
  } else {
    e = cudaFuncSetAttribute(jolt::exact_matmul_wide,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             jolt::ExactWide::SMEM);
    if (e != cudaSuccess) return (int)e;
    jolt::exact_matmul_wide<<<grid, jolt::ExactWide::THREADS,
                              jolt::ExactWide::SMEM, st>>>(
        pa, pb, po, pw, g, sab, sam, sak, sbb, sbk, sbn, va, vb, shift,
        wrap);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const int64_t total = batch * M * N;
  jolt::exact_matmul_finish<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      pw, po, batch, M * N, splits, shift, wrap);
  return (int)cudaGetLastError();
}
