// Kernel 1: batched BN254 G1 complete projective point add.
//
// Replaces the Pallas kernel jolt_atlas_tpu/tpu/pallas_curve.py:_add_kernel
// (pallas_call over (16, 8, 128) blocks of 16-bit limb planes). On Hopper a
// lane of the TPU block becomes one thread holding its two points in
// registers as 4 x u64 Montgomery limbs; there is no 1024-lane granule and
// no padding. Bound by integer multiply throughput: 12 Montgomery products
// of 4 x 4 64-bit words each, against 9 x 32 bytes of memory traffic per
// add, so the design keeps the whole add in registers and reads and
// writes each coordinate once with 16-byte loads and stores.
#include <cuda_runtime.h>

#include "fq.cuh"

namespace jolt {

__global__ void pp_add_kernel(const u64* __restrict__ x1,
                              const u64* __restrict__ y1,
                              const u64* __restrict__ z1,
                              const u64* __restrict__ x2,
                              const u64* __restrict__ y2,
                              const u64* __restrict__ z2,
                              u64* __restrict__ x3, u64* __restrict__ y3,
                              u64* __restrict__ z3, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Point P, Q;
  P.x = load_fq(x1, i);
  P.y = load_fq(y1, i);
  P.z = load_fq(z1, i);
  Q.x = load_fq(x2, i);
  Q.y = load_fq(y2, i);
  Q.z = load_fq(z2, i);
  const Point R = pp_add_dev(P, Q);
  store_fq(x3, i, R.x);
  store_fq(y3, i, R.y);
  store_fq(z3, i, R.z);
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
  const int threads = 128;
  const int64_t blocks = (n + threads - 1) / threads;
  jolt::pp_add_kernel<<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(
      (const u64*)x1, (const u64*)y1, (const u64*)z1, (const u64*)x2,
      (const u64*)y2, (const u64*)z2, (u64*)x3, (u64*)y3, (u64*)z3, n);
  return (int)cudaGetLastError();
}
