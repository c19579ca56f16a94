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
// solve with y [n, B] row-major (ops.trisolve_panels with a block of
// right-hand sides), in place, commit fused in, in one launch: the
// persistent walk of ell_walk.cuh.  For each row i = row_ids[r] of each
// plan entry, in order, and each column b,
//
//   y[i, b] = y[i, b] - sum_{k < row_len[r]} vals[r, k] * y[cols[r, k], b]
//
// Coherence and deadlock freedom are ell_sweep's (ell_spmv.cu, and the
// note of ell_walk.cuh): y is written by the launch and read only by
// plain loads after the item's wait on the previous entry's done counter
// (relaxed poll, fence.acq_rel.gpu, __syncthreads), published by
// __syncthreads and red.release.gpu; items (pieces of an entry, runs of
// small entries) are taken by a ticket in plan order.
//
// A block of columns.  Each live (col, val) pair is read once for NB
// columns (NB = 8 for B >= 5, 4 for B = 3-4, 2, 1; B > 8 runs the row
// once per chunk of 8, and a chunk reads only rows of earlier entries, so
// the row's own earlier chunks do not feed it).  Where B is a multiple of
// NB and y is aligned for it (B = 8: a row of y is one 32 B sector), a
// slot gathers the chunk's NB values of a column as one or two 16 B
// loads; otherwise (B = 11, B = 3) one scalar load a column.  The group
// reduces the NB accumulators together by ell::group_reduce, the
// reduce-scatter of the fleet sweep (9 shuffles for 8 columns at G = 32,
// not 40), and one thread commits each column's sum.  Long rows are read
// in pipelined batches of 8 slots a thread, the first read before the
// wait (ell::row_sum_read).
//
// Same bits.  Each column keeps its own accumulator, summed in ell_sweep's
// order (its slots g, g + G, ... by fused multiply-adds from +0, G =
// group_width(level_k)), and the reduce-scatter forms only partial sums
// that group_sum forms (own + partner), so column b equals ell_sweep of
// that column bit for bit and, by ell_sweep's argument, equals the
// full-row kernel followed by y[rows] -= Y (the one exception again a
// negative product that underflows to -0).
//
// What bounds it on an H100: the chain of levels, as ell_sweep: the bytes
// (the live slots once for all columns, the gathered 4·B-byte rows of y,
// row_ids, row_len and the level's rows of y in and out, over 3.35 TB/s)
// are microseconds a solve, while the levels run one after another, each
// behind a counter hand-off and a gather of y from L2.  One 32 B gather a
// slot and the reduce-scatter keep a level's own work at 8 columns close
// to one column's, so the block solve costs about what a single one does.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_row.cuh"
#include "ell_walk.cuh"

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

// One triangular solve, in place on y [n, B] row-major: the arguments of
// ell_sweep_launch (ell_spmv.cu) and the column count B.  One launch, or
// none when there are no items or columns.  Returns the number of
// launches, or minus the cudaError_t of what failed.
extern "C" int ell_sweep_multi_launch(const int* cols, const float* vals,
                                      const int* row_len, const int* row_ids,
                                      const int* items, const int* entries,
                                      int* ws, float* y, int n_items,
                                      int n_entries, int ws_words, int K,
                                      int B, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t a = reinterpret_cast<uintptr_t>(y);
#define WALK(NB, VEC)                                                      \
  ell::walk<NB, VEC>(cols, vals, row_len, row_ids, items, entries, ws, \
                     y, n_items, n_entries, ws_words, K, B, s)
  if (B >= 5) return B % 8 == 0 && a % 16 == 0 ? WALK(8, true) : WALK(8, false);
  if (B >= 3) return B % 4 == 0 && a % 16 == 0 ? WALK(4, true) : WALK(4, false);
  if (B == 2) return a % 8 == 0 ? WALK(2, true) : WALK(2, false);
  return WALK(1, false);
#undef WALK
}
