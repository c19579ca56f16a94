// Lane-batched ELL SpMV over a stacked fleet of panels, for Hopper, and
// the level sweep of the fleet's triangular solves built on it.
//
// ell_spmv_fleet: the full-row product
//
//   Y[l, i] = sum_k vals[f, i, k] * x[l, cols[f, i, k]],   f = fidx[l]
//
// Replaces the TPU kernel src/repro/kernels/spmv.py (ell_spmv_fleet_pallas
// / _spmv_fleet_kernel).  The TPU kernel took per-lane panels [L, R, K]
// that the caller gathered from the fleet stack on every apply; this one
// reads the stack [F, R, K] in place through fidx, so an apply copies no
// panels at all.
//
// Layout: a group of G = min(32, pow2(K)) threads owns one (lane, row) and
// sums it as ell_row.cuh does (strided partial sums, fixed xor butterfly).
// The sum order depends on K alone, so a lane's output does not depend on
// how many lanes share the launch or on the grid: results are deterministic
// run to run and lane-independent bit for bit.  Blocks are numbered
// lane-fastest (blockIdx.x = lane), so the lanes of one row tile run back
// to back and a panel tile shared by several lanes (same fidx) is read from
// HBM once and from L2 after that.
//
// What bounds it on an H100: bytes.  Each (row, slot) moves 8 bytes of
// panel (int32 col + f32 val) for 2 flops, far below the card's
// operations-per-byte balance, so the least time is the panel bytes (each
// distinct panel once) plus x and Y, over 3.35 TB/s.
//
// ell_sweep_fleet: one level lv of a lane-batched unit-triangular solve,
// in place, with the commit fused in:
//
//   y[l, i] = y[l, i] - sum_{k < len[f, i]} vals[f, i, k] * y[l, cols[f, i, k]]
//
// for the rows i = rows[f, start[f, lv] .. start[f, lv + 1]) of level lv
// of factor f = fidx[l] (each factor's rows sorted stably by level, with
// each level's start offset).  Rows of other levels are neither read as
// outputs nor written; in place is safe because a level's rows read only
// rows of lower levels.  Each row reads its live slots only (rows are
// left-packed, len = in-degree), so a row of 10 nonzeros in a 1024-slot
// panel reads 10 slots, where the full-row kernel read the whole padded
// panel on every level and the caller kept that level's rows with a
// where().  The sum keeps the full-row kernel's order (G = group_width(K)
// threads per row, strided slots, the fixed butterfly) and the commit is
// one __fsub_rn, so a committed row equals the full-row kernel followed
// by y - Y bit for bit: the skipped slots hold 0.0 and add exactly
// nothing for finite y.  Grid (L, ceil(max_rows / rows per block)), with
// max_rows the bucket's largest row count at this level, kept on the host
// at admission: a launch needs no host read.  Bound: bytes, the live
// slots (8 B each) plus the y sectors they gather plus y in and out.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_row.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) ell_spmv_fleet_kernel(
    const int* __restrict__ cols, const float* __restrict__ vals,
    const int* __restrict__ fidx, const float* __restrict__ x,
    float* __restrict__ y, int R, int K, int n, int G, int tiles) {
  const int lane = blockIdx.x;
  const int rows_per_block = kThreads / G;
  const int g = threadIdx.x % G;
  const int r_local = threadIdx.x / G;
  const int64_t f = fidx[lane];
  const float* xl = x + static_cast<int64_t>(lane) * n;
  for (int tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const int i = tile * rows_per_block + r_local;
    float acc[1] = {0.0f};
    if (i < R) {
      const int64_t base = (f * R + i) * static_cast<int64_t>(K);
      ell::row_partial<1>(cols + base, vals + base, xl, 1, K, g, G, 1, acc);
    }
    const float sum = ell::group_sum(acc[0], G);
    if (i < R && g == 0) y[static_cast<int64_t>(lane) * R + i] = sum;
  }
}

__global__ void __launch_bounds__(kThreads) ell_sweep_fleet_kernel(
    const int* __restrict__ cols, const float* __restrict__ vals,
    const int* __restrict__ lens, const int* __restrict__ rows,
    const int* __restrict__ starts, const int* __restrict__ fidx, float* y,
    int R, int K, int n_starts, int lv, int G, int tiles) {
  const int lane = blockIdx.x;
  const int rows_per_block = kThreads / G;
  const int g = threadIdx.x % G;
  const int r_local = threadIdx.x / G;
  const int64_t f = fidx[lane];
  const int lo = starts[f * n_starts + lv];
  const int count = starts[f * n_starts + lv + 1] - lo;
  const int* level_rows = rows + f * R + lo;
  float* yl = y + static_cast<int64_t>(lane) * R;
  for (int tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    if (tile * rows_per_block >= count) return;   // uniform over the block
    const int r = tile * rows_per_block + r_local;
    float acc[1] = {0.0f};
    int i = 0;
    if (r < count) {
      i = level_rows[r];
      const int64_t base = (f * R + i) * static_cast<int64_t>(K);
      ell::row_partial<1>(cols + base, vals + base, yl, 1, lens[f * R + i],
                          g, G, 1, acc);
    }
    const float sum = ell::group_sum(acc[0], G);
    if (r < count && g == 0) yl[i] = __fsub_rn(yl[i], sum);
  }
}

}  // namespace

// Returns a cudaError_t; 0 on a successful launch.  cols/vals: [F, R, K]
// contiguous, fidx: [L] int32, x: [L, n], y: [L, R].
extern "C" int ell_spmv_fleet_launch(const int* cols, const float* vals,
                                     const int* fidx, const float* x,
                                     float* y, int L, int R, int K, int n,
                                     void* stream) {
  if (L == 0 || R == 0) return 0;
  const int G = ell::group_width(K);
  const int rows_per_block = kThreads / G;
  const int tiles = (R + rows_per_block - 1) / rows_per_block;
  dim3 grid(L, tiles < 65535 ? tiles : 65535);
  ell_spmv_fleet_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      cols, vals, fidx, x, y, R, K, n, G, tiles);
  return static_cast<int>(cudaGetLastError());
}

// Returns a cudaError_t; 0 on a successful launch.  Level lv of the sweep,
// in place on y [L, R]: cols/vals [F, R, K], lens/rows [F, R] int32,
// starts [F, n_starts] int32 (level lv's rows of factor f are
// rows[f, starts[f, lv] .. starts[f, lv + 1])), fidx [L] int32; max_rows
// bounds every lane's row count at lv (0: nothing to launch).
extern "C" int ell_sweep_fleet_launch(const int* cols, const float* vals,
                                      const int* lens, const int* rows,
                                      const int* starts, const int* fidx,
                                      float* y, int L, int R, int K,
                                      int n_starts, int lv, int max_rows,
                                      void* stream) {
  if (L == 0 || max_rows <= 0) return 0;
  const int G = ell::group_width(K);
  const int rows_per_block = kThreads / G;
  const int tiles = (max_rows + rows_per_block - 1) / rows_per_block;
  dim3 grid(L, tiles < 65535 ? tiles : 65535);
  ell_sweep_fleet_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      cols, vals, lens, rows, starts, fidx, y, R, K, n_starts, lv, G, tiles);
  return static_cast<int>(cudaGetLastError());
}
