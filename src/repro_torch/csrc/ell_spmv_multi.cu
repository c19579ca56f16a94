// Multi-vector ELL SpMV, for Hopper:
//
//   Y[i, b] = sum_k vals[i, k] * x[cols[i, k], b]
//
// Replaces the TPU kernel src/repro/kernels/spmv.py (ell_spmv_multi_pallas
// / _spmv_multi_kernel), which read each (rows, K) index/value tile once for
// all B columns.  It serves the full-row composition that ell_sweep_multi
// below is held against (ops.trisolve_panels_full with x of shape
// (n, B)).
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
//
// ell_sweep_multi: the same TPU kernel's redesign for the library path's
// level slabs, the block form of ell_sweep (ell_spmv.cu): one triangular
// solve with x [n, B] row-major (ops.trisolve_panels with a block of
// right-hand sides), in place, commit fused in: for each row i = row_ids[r] of level lv and each
// column b,
//
//   y[i, b] = y[i, b] - sum_{k < row_len[r]} vals[r, k] * y[cols[r, k], b]
//
// Each live (col, val) pair is read once for up to kCols columns (B >
// kCols runs the row once per chunk of kCols columns; a chunk reads only
// rows of lower levels, so the row's own earlier chunks do not feed it).
// G = group_width(level_k) threads per row, as in ell_sweep, so column b
// equals ell_sweep of that column bit for bit and equals the full-row
// kernel followed by y[rows] -= Y bit for bit, by ell_sweep's argument.
// Bound: bytes (the live slots once for all columns, the gathered 4·B-byte
// rows of y, row_ids, row_len and the level's rows of y in and out), and
// at most levels the launch.  The design reads live slots only, narrows
// the group to the level's longest row, and runs the level loop in the C
// entry point (one call per triangular solve, no Python per level).
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

__global__ void __launch_bounds__(kThreads) ell_sweep_multi_kernel(
    const int* __restrict__ cols, const float* __restrict__ vals,
    const int* __restrict__ row_len, const int* __restrict__ row_ids,
    float* y, int lo, int count, int K, int B, int G) {
  const int rows_per_block = kThreads / G;
  const int g = threadIdx.x % G;
  const int r = blockIdx.x * rows_per_block + threadIdx.x / G;
  const int64_t slot = static_cast<int64_t>(lo) + r;
  const int i = r < count ? row_ids[slot] : 0;
  const int len = r < count ? row_len[slot] : 0;
  float* yi = y + static_cast<int64_t>(i) * B;
  for (int c0 = 0; c0 < B; c0 += kCols) {
    const int nb = B - c0 < kCols ? B - c0 : kCols;
    float acc[kCols];
#pragma unroll
    for (int b = 0; b < kCols; ++b) acc[b] = 0.0f;
    if (r < count)
      ell::row_partial<kCols>(cols + slot * K, vals + slot * K, y + c0, B,
                              len, g, G, nb, acc);
#pragma unroll
    for (int b = 0; b < kCols; ++b) {
      const float sum = ell::group_sum(acc[b], G);
      if (r < count && g == 0 && b < nb)
        yi[c0 + b] = __fsub_rn(yi[c0 + b], sum);
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

// One triangular solve, in place on y [n, B] row-major: cols/vals [R, K]
// contiguous, row_len/row_ids [R] int32, plan a host array [n_plan, 3]
// int32 of (slab offset, row count, longest live row) per level, in solve
// order.  Returns the number of launches, or minus the cudaError_t of the
// first launch that failed.
extern "C" int ell_sweep_multi_launch(const int* cols, const float* vals,
                                      const int* row_len, const int* row_ids,
                                      float* y, const int* plan, int n_plan,
                                      int K, int B, void* stream) {
  if (B <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int launched = 0;
  for (int p = 0; p < n_plan; ++p) {
    const int lo = plan[3 * p], count = plan[3 * p + 1];
    if (count <= 0) continue;
    const int G = ell::group_width(plan[3 * p + 2]);
    const int rows_per_block = kThreads / G;
    const int blocks = (count + rows_per_block - 1) / rows_per_block;
    ell_sweep_multi_kernel<<<blocks, kThreads, 0, s>>>(
        cols, vals, row_len, row_ids, y, lo, count, K, B, G);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return -static_cast<int>(err);
    ++launched;
  }
  return launched;
}
