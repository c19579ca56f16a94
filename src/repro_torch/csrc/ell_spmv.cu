// Single-vector ELL SpMV, for Hopper:
//
//   y[i] = sum_k vals[i, k] * x[cols[i, k]]
//
// Replaces the TPU kernel src/repro/kernels/spmv.py (ell_spmv_pallas /
// _spmv_kernel).  It serves the masked and numpy-slab solves and the
// full-row composition that ell_sweep below is held against
// (ops.trisolve_panels_full): R is any row count (a slab of a
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
//
// ell_sweep: one triangular solve of the library path (ops.trisolve_panels
// with a 1-D right-hand side), the same TPU kernel's redesign for the
// level slabs of a DeviceSchedule.  Launch lv of the solve updates level
// lv's rows in place, with the commit fused in:
//
//   y[i] = y[i] - sum_{k < row_len[r]} vals[r, k] * y[cols[r, k]],
//   i = row_ids[r],  r in row_ptr[lv] .. row_ptr[lv + 1]
//
// Rows of one level read only rows of lower levels, so in place is safe
// within a launch (the y values a launch gathers were written by earlier
// launches, so the read-only cache never holds a stale one).
//
// Same bits as the full-row kernel.  A row reads its row_len live slots
// only, with G = group_width(level_k) threads, level_k the level's
// longest live row; the full-row kernel reads all K slots with
// G = group_width(K).  Their sums are equal bit for bit for finite y:
//   * slots past row_len hold 0.0 (col 0), and a fused multiply-add of
//     0.0 adds exactly nothing to a partial sum other than -0;
//   * the partial sums start at +0, and a sum becomes -0 only where a
//     negative product is below half the least subnormal and rounds to
//     zero: the claim excludes that underflow;
//   * with level_k > 32 both widths are 32, so both kernels give thread g
//     the same live slots in the same order;
//   * with level_k <= 32, G >= level_k >= row_len, so each thread holds at
//     most one live slot; the wider full-row group's extra threads hold
//     +0, and its extra butterfly rounds (offsets >= G) add +0 to each
//     thread's value before the rounds that both kernels share.
// The commit is one __fsub_rn, as torch's y[rows] -= Y.
//
// What bounds it on an H100: bytes, and at most levels the launch.  The
// bytes are the live slots (8 B each), the y sectors they gather, and
// row_ids, row_len and y read and written per row, over 3.35 TB/s: at the
// 64^3 cell's largest forward level (24,322 rows, 32,630 live slots) a
// few MB, where the full-row kernel read the whole padded slab
// (K = 593 slots a row).  The design reads live slots only and narrows the thread group to
// the level's longest row.  Most levels hold a few hundred rows and are
// bound by the launch: the level loop runs in the C entry point
// (ell_sweep_launch), one call per triangular solve, so a launch costs
// the host only the CUDA runtime's own launch time, with no Python, no
// tensor check and no device read per level.
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

__global__ void __launch_bounds__(kThreads) ell_sweep_kernel(
    const int* __restrict__ cols, const float* __restrict__ vals,
    const int* __restrict__ row_len, const int* __restrict__ row_ids,
    float* y, int lo, int count, int K, int G) {
  const int rows_per_block = kThreads / G;
  const int g = threadIdx.x % G;
  const int r = blockIdx.x * rows_per_block + threadIdx.x / G;
  float acc[1] = {0.0f};
  int i = 0;
  if (r < count) {
    const int64_t slot = static_cast<int64_t>(lo) + r;
    i = row_ids[slot];
    ell::row_partial<1>(cols + slot * K, vals + slot * K, y, 1, row_len[slot],
                        g, G, 1, acc);
  }
  const float sum = ell::group_sum(acc[0], G);
  if (r < count && g == 0) y[i] = __fsub_rn(y[i], sum);
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

// One triangular solve, in place on y [n]: cols/vals [R, K] contiguous
// (the level-sorted panel), row_len/row_ids [R] int32, plan a host array
// [n_plan, 3] int32 of (slab offset, row count, longest live row) per
// level, in solve order.  One launch per level with rows, G =
// group_width(longest live row).  Returns the number of launches, or
// minus the cudaError_t of the first launch that failed.
extern "C" int ell_sweep_launch(const int* cols, const float* vals,
                                const int* row_len, const int* row_ids,
                                float* y, const int* plan, int n_plan, int K,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int launched = 0;
  for (int p = 0; p < n_plan; ++p) {
    const int lo = plan[3 * p], count = plan[3 * p + 1];
    if (count <= 0) continue;
    const int G = ell::group_width(plan[3 * p + 2]);
    const int rows_per_block = kThreads / G;
    const int blocks = (count + rows_per_block - 1) / rows_per_block;
    ell_sweep_kernel<<<blocks, kThreads, 0, s>>>(cols, vals, row_len, row_ids,
                                                 y, lo, count, K, G);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return -static_cast<int>(err);
    ++launched;
  }
  return launched;
}
