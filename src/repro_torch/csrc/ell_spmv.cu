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
// launch instead (the compositions that use it launch it once a level).
//
// ell_sweep: one triangular solve of the library path (ops.trisolve_panels
// with a 1-D right-hand side), the same TPU kernel's redesign for the
// level slabs of a DeviceSchedule: one launch per triangular solve, a
// persistent walk over the plan's levels (ell_walk.cuh, shared with
// ell_sweep_multi), the commit fused in:
//
//   y[i] = y[i] - sum_{k < row_len[r]} vals[r, k] * y[cols[r, k]],
//   i = row_ids[r],  r in the slab rows of each plan entry, in order
//
// Coherence.  Rows of one level read only rows of earlier levels, and
// those are written by this same launch, so no y load may go through the
// read-only cache or be reordered before the wait: y is a plain float*
// (never const __restrict__, never __ldg), and an item gathers y only
// after its block's thread 0 has seen the previous plan entry's done
// counter reach that entry's rows (ld.relaxed.gpu, then fence.acq_rel.gpu)
// and __syncthreads() (a run's later entries: after the block's own
// __syncthreads() that follows the entry before); a writer's rows are
// published by __syncthreads() and then red.release.gpu on its entry's
// counter.  The row ids, lengths,
// columns and values never change and keep __ldg; they and the row's own
// y are read before the wait, so only the gathers of earlier rows follow
// the hand-off.
//
// Deadlock freedom.  Blocks take items (a piece of at most 256 / G rows
// of one plan entry, or a run of up to 64 consecutive entries whose rows
// each fit one block) by an atomic ticket in plan order, never by
// blockIdx.  An item waits only on items with smaller tickets, all taken
// by running blocks that wait on nothing later, so every wait ends
// whatever the residency (a partial grid, another stream's kernel, ranks
// sharing the card).
//
// Same bits as the full-row kernel.  A row reads its row_len live slots
// only, with G = group_width(level_k) threads, level_k the level's
// longest live row; the full-row kernel reads all K slots with
// G = group_width(K).  Their sums are equal bit for bit for finite y, and
// so are those of any G from group_width(row_len) to 32:
//   * slots past row_len hold 0.0 (col 0), and a fused multiply-add of 0.0
//     adds exactly nothing to a partial sum other than -0;
//   * the partial sums start at +0, and a sum becomes -0 only where a
//     negative product is below half the least subnormal and rounds to
//     zero: that underflow is the one exception, which the claim excludes;
//   * with level_k > 32 both widths are 32, so both kernels give thread g
//     the same live slots in the same order;
//   * with level_k <= 32, G >= level_k >= row_len, so each thread holds at
//     most one live slot; the wider group's extra threads hold +0, and its
//     extra butterfly rounds (offsets >= G) add +0 to each thread's value
//     before the rounds that both kernels share.
// The commit is one __fsub_rn, as torch's y[rows] -= Y.  The sum is
// ell_row.cuh's row_sum (long rows in pipelined batches) and group_reduce,
// which for one vector is group_sum's butterfly: a row equals
// ell_sweep_fleet's lane and each column of ell_sweep_multi bit for bit.
//
// What bounds it on an H100: the chain of levels.  The bytes (live slots,
// 8 B each, row_ids, row_len and y in and out, over 3.35 TB/s) are about
// 7.6 us a solve at the 64^3 cell, but the plan's 623 levels run one after
// another, each behind one hand-off of the done counter (a release that
// waits for the writers' stores, a poll that sees it, the acquire) and
// one gather of y from L2: about 1.35 us a level on a path of one-slot
// rows.  The design pays that chain once a level inside one launch, where
// the per-level launches it replaces paid a kernel's ramp and a launch gap
// on top: the grid is the card's resident blocks, so items of the next
// levels are claimed and their read-only data loaded (a long row's first
// 1 + 8 slots a thread) while earlier levels finish; and the solve's last
// levels, a row or two each, go in runs whose hand-offs are a block's
// __syncthreads().
#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_row.cuh"
#include "ell_walk.cuh"

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

// One triangular solve, in place on y [n]: cols/vals [R, K] contiguous
// (the level-sorted panel), row_len/row_ids [R] int32, entries
// [n_entries, 4] int32 (slab offset, rows, longest live row, 0: the plan's
// levels with rows, in order), items [n_items, 4] int32 (first slab row,
// rows, entry, longest live row: an entry's rows cut into pieces of at
// most 256 / G rows; or first entry's offset, entries, first entry, -1:
// a run of up to 64 consecutive entries whose rows each fit one block), in
// plan order, ws [ws_words] int32 of scratch (at least (n_entries + 1) *
// 32 words; zeroed here on the stream).  One launch, or none when there
// are no items.  Returns the number of launches, or minus the cudaError_t
// of what failed.
extern "C" int ell_sweep_launch(const int* cols, const float* vals,
                                const int* row_len, const int* row_ids,
                                const int* items, const int* entries,
                                int* ws, float* y, int n_items, int n_entries,
                                int ws_words, int K, void* stream) {
  return ell::walk<1, false>(cols, vals, row_len, row_ids, items, entries,
                             ws, y, n_items, n_entries, ws_words, K, 1,
                             static_cast<cudaStream_t>(stream));
}
