// Kernel 2: Pippenger bucket accumulation over a (rows, L) grid of point
// indices.
//
// Replaces the accumulation loop of jolt_atlas_tpu/tpu/msm.py:_accum_body
// (a lax.fori_loop that, per grid row, gathers one base per lane and runs
// one launch-sized Pallas complete add, tpu/pallas_curve.py:_add_kernel).
// Here one thread owns one lane (= one bucket, so there are no conflicts),
// walks its column of the grid, gathers each base (-1 = empty slot: the
// identity, skipped), keeps the running bucket sum in registers and writes
// it once. Bound by integer multiply throughput like kernel 1; the grid is
// read coalesced (neighbouring lanes are neighbouring int32s of a row) and
// the base gathers are random 32-byte reads that the L2 mostly serves.
#include <cuda_runtime.h>

#include "fq.cuh"

namespace jolt {

__global__ void bucket_accumulate_kernel(const u64* __restrict__ bx,
                                         const u64* __restrict__ by,
                                         const u64* __restrict__ bz,
                                         const int32_t* __restrict__ grid,
                                         int64_t rows, int64_t L,
                                         u64* __restrict__ ox,
                                         u64* __restrict__ oy,
                                         u64* __restrict__ oz) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  Point acc = pp_identity();
  for (int64_t r = 0; r < rows; ++r) {
    const int32_t idx = grid[r * L + lane];
    if (idx < 0) continue;
    Point B;
    B.x = load_fq(bx, idx);
    B.y = load_fq(by, idx);
    B.z = load_fq(bz, idx);
    acc = pp_add_dev(acc, B);
  }
  store_fq(ox, lane, acc.x);
  store_fq(oy, lane, acc.y);
  store_fq(oz, lane, acc.z);
}

}  // namespace jolt

// acc[l] = sum over rows r with grid[r, l] >= 0 of base[grid[r, l]], added
// in row order starting from the identity. Bases and outputs are (N, 4) /
// (L, 4) u64 Montgomery limbs; grid is (rows, L) int32. Launches on
// `stream`, allocates nothing, and returns cudaGetLastError().
extern "C" int jolt_bucket_accumulate(const void* bx, const void* by,
                                      const void* bz, const void* grid,
                                      int64_t rows, int64_t L, void* ox,
                                      void* oy, void* oz, void* stream) {
  using jolt::u64;
  if (L <= 0) return 0;
  const int threads = 128;
  const int64_t blocks = (L + threads - 1) / threads;
  jolt::bucket_accumulate_kernel<<<(unsigned)blocks, threads, 0,
                                   (cudaStream_t)stream>>>(
      (const u64*)bx, (const u64*)by, (const u64*)bz, (const int32_t*)grid,
      rows, L, (u64*)ox, (u64*)oy, (u64*)oz);
  return (int)cudaGetLastError();
}
