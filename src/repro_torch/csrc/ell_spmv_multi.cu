// Multi-vector ELL SpMV, for Hopper:
//
//   Y[i, b] = sum_k vals[i, k] * x[cols[i, k], b]
//
// Replaces the TPU kernel src/repro/kernels/spmv.py (ell_spmv_multi_pallas
// / _spmv_multi_kernel), which read each (rows, K) index/value tile once for
// all B columns.  It serves the level slabs of the library path's
// triangular solves with a block of right-hand sides (ops.trisolve_panels
// with x of shape (n, B)).
//
// Layout: x is [n, B] row-major, so the gather x[cols[i, k], :] is B
// contiguous floats.  A group of G = min(32, pow2(K)) threads owns one row,
// as in ell_spmv.cu; each thread reads its (col, val) pairs once and keeps
// kCols column sums in registers (B > kCols runs the row once per chunk of
// kCols columns).  Every (row, column) is summed in ell_row.cuh's order, so
// column b equals ell_spmv(cols, vals, x[:, b]) bit for bit: a batched PCG
// column takes the iterates of its single-rhs solve.
//
// What bounds it on an H100: bytes.  The panel (8 bytes a slot) is read
// once for all B columns and each gathered row of x is one 4·B-byte
// segment, so the least time is the panel bytes plus x and Y over
// 3.35 TB/s.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_row.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 8;

__global__ void __launch_bounds__(kThreads) ell_spmv_multi_kernel(
    const int* __restrict__ cols, const float* __restrict__ vals,
    const float* __restrict__ x, float* __restrict__ y, int R, int K, int B,
    int G) {
  const int rows_per_block = kThreads / G;
  const int g = threadIdx.x % G;
  const int i = blockIdx.x * rows_per_block + threadIdx.x / G;
  const int64_t base = static_cast<int64_t>(i) * K;
  for (int c0 = 0; c0 < B; c0 += kCols) {
    const int nb = B - c0 < kCols ? B - c0 : kCols;
    float acc[kCols];
#pragma unroll
    for (int b = 0; b < kCols; ++b) acc[b] = 0.0f;
    if (i < R)
      ell::row_partial<kCols>(cols + base, vals + base, x + c0, B, K, g, G,
                              nb, acc);
#pragma unroll
    for (int b = 0; b < kCols; ++b) {
      const float sum = ell::group_sum(acc[b], G);
      if (i < R && g == 0 && b < nb)
        y[static_cast<int64_t>(i) * B + c0 + b] = sum;
    }
  }
}

}  // namespace

// Returns a cudaError_t; 0 on a successful launch.  cols/vals: [R, K]
// contiguous, x: [n, B] row-major, y: [R, B] row-major.
extern "C" int ell_spmv_multi_launch(const int* cols, const float* vals,
                                     const float* x, float* y, int R, int K,
                                     int B, void* stream) {
  if (R == 0 || B == 0) return 0;
  const int G = ell::group_width(K);
  const int rows_per_block = kThreads / G;
  const int blocks = (R + rows_per_block - 1) / rows_per_block;
  ell_spmv_multi_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      cols, vals, x, y, R, K, B, G);
  return static_cast<int>(cudaGetLastError());
}
