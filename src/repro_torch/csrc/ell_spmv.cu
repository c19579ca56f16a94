// Single-vector ELL SpMV, for Hopper:
//
//   y[i] = sum_k vals[i, k] * x[cols[i, k]]
//
// Replaces the TPU kernel src/repro/kernels/spmv.py (ell_spmv_pallas /
// _spmv_kernel).  It serves the level slabs of the library path's
// triangular solves (ops.trisolve_panels with a 1-D right-hand side) and
// the masked and numpy-slab solves: R is any row count (a slab of a
// DeviceSchedule is a row range of its panel, passed by pointer offset,
// never copied) and K any width, not only a power of two.
//
// Layout: a group of G = min(32, pow2(K)) threads owns one row and sums it
// as ell_row.cuh does, so y equals the same lane of ell_spmv_fleet bit for
// bit, and the same column of ell_spmv_multi.
//
// What bounds it on an H100: bytes.  Each (row, slot) moves 8 bytes of
// panel (int32 col + f32 val) for 2 flops, far below the card's
// operations-per-byte balance.  Slabs of a few dozen rows are bound by the
// launch instead: one launch per level is the design here, and its cost
// is measured, not hidden.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_row.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) ell_spmv_kernel(
    const int* __restrict__ cols, const float* __restrict__ vals,
    const float* __restrict__ x, float* __restrict__ y, int R, int K,
    int G) {
  const int rows_per_block = kThreads / G;
  const int g = threadIdx.x % G;
  const int i = blockIdx.x * rows_per_block + threadIdx.x / G;
  float acc[1] = {0.0f};
  if (i < R) {
    const int64_t base = static_cast<int64_t>(i) * K;
    ell::row_partial<1>(cols + base, vals + base, x, 1, K, g, G, 1, acc);
  }
  const float sum = ell::group_sum(acc[0], G);
  if (i < R && g == 0) y[i] = sum;
}

}  // namespace

// Returns a cudaError_t; 0 on a successful launch.  cols/vals: [R, K]
// contiguous, x: [n], y: [R].
extern "C" int ell_spmv_launch(const int* cols, const float* vals,
                               const float* x, float* y, int R, int K,
                               void* stream) {
  if (R == 0) return 0;
  const int G = ell::group_width(K);
  const int rows_per_block = kThreads / G;
  const int blocks = (R + rows_per_block - 1) / rows_per_block;
  ell_spmv_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      cols, vals, x, y, R, K, G);
  return static_cast<int>(cudaGetLastError());
}
