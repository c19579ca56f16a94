// Lane-batched ELL SpMV over a stacked fleet of panels, for Hopper:
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
