// Kernel 1: batched BN254 G1 complete projective point add.
//
// Replaces the Pallas kernel jolt_atlas_tpu/tpu/pallas_curve.py:_add_kernel
// (pallas_call over (16, 8, 128) blocks of 16-bit limb planes). On Hopper a
// lane of the TPU block becomes one thread holding its two points in
// registers as 8 x u32 Montgomery limbs (csrc/fq.cuh); there is no
// 1024-lane granule and no padding. Bound by integer multiply throughput
// against 9 x 32 bytes of memory traffic per add: the design keeps the
// whole add in registers and reads and writes each coordinate once with
// 16-byte loads and stores. The add (fq.cuh pp_add_dev) takes its last six
// products as three sums of two, each reduced once (mont_mul_sum2): 2,760
// IMAD an add where 12 Montgomery products are 3,168. Tensor cores and TMA
// do not serve this work (256-bit modular multiplies, one pass over the
// data).
#include <cuda_runtime.h>

#include "fq.cuh"

namespace jolt {

// 256 threads a block: on an H100 at 2^17 lanes 0.045 ms against 0.055 at
// 128 or 64 (scripts/msm_kernels_bench.py --shapes; __launch_bounds__(256,
// 2), (512, 1) and (128, 4) no faster)
constexpr int PP_ADD_THREADS = 256;

// lane i of the batch: one complete add, in registers
__device__ __forceinline__ void pp_add_lane(
    const u64* __restrict__ x1, const u64* __restrict__ y1,
    const u64* __restrict__ z1, const u64* __restrict__ x2,
    const u64* __restrict__ y2, const u64* __restrict__ z2,
    u64* __restrict__ x3, u64* __restrict__ y3, u64* __restrict__ z3,
    int64_t i) {
  const Point R = pp_add_dev(load_point(x1, y1, z1, i),
                             load_point(x2, y2, z2, i));
  store_point(x3, y3, z3, i, R);
}

__global__ void __launch_bounds__(PP_ADD_THREADS)
    pp_add_kernel(const u64* __restrict__ x1, const u64* __restrict__ y1,
                  const u64* __restrict__ z1, const u64* __restrict__ x2,
                  const u64* __restrict__ y2, const u64* __restrict__ z2,
                  u64* __restrict__ x3, u64* __restrict__ y3,
                  u64* __restrict__ z3, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * PP_ADD_THREADS + threadIdx.x;
  if (i < n) pp_add_lane(x1, y1, z1, x2, y2, z2, x3, y3, z3, i);
}

}  // namespace jolt

// (X3, Y3, Z3)[i] = (X1, Y1, Z1)[i] + (X2, Y2, Z2)[i] for i < n; every
// array is (n, 4) u64 Montgomery limbs. Launches on `stream`, allocates
// nothing, and returns cudaGetLastError().
extern "C" int jolt_pp_add(const void* x1, const void* y1, const void* z1,
                           const void* x2, const void* y2, const void* z2,
                           void* x3, void* y3, void* z3, int64_t n,
                           void* stream) {
  using jolt::u64;
  if (n <= 0) return 0;
  const int64_t blocks =
      (n + jolt::PP_ADD_THREADS - 1) / jolt::PP_ADD_THREADS;
  jolt::pp_add_kernel<<<(unsigned)blocks, jolt::PP_ADD_THREADS, 0,
                        (cudaStream_t)stream>>>(
      (const u64*)x1, (const u64*)y1, (const u64*)z1, (const u64*)x2,
      (const u64*)y2, (const u64*)z2, (u64*)x3, (u64*)y3, (u64*)z3, n);
  return (int)cudaGetLastError();
}
