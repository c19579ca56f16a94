// The level walk: one launch per triangular solve over the level slabs of a
// level-sorted panel (the library path's DeviceSchedule), shared by
// ell_sweep (ell_spmv.cu, one right-hand side) and ell_sweep_multi
// (ell_spmv_multi.cu, a block of them).  For each plan entry in order (a
// level with rows: slab offset, row count, longest live row) and each of
// its rows r, i = row_ids[r], and each column b of y [n, B] row-major:
//
//   y[i, b] = y[i, b] - sum_{k < row_len[r]} vals[r, k] * y[cols[r, k], b]
//
// Work items, in plan order (kernels/spmv.py sweep_walk).  A piece is
// at most kWalkThreads / G rows of one entry (G = group_width(level_k),
// one block's rows): (first slab row, rows, entry, level_k).  A run is 2
// to kWalkRun consecutive entries whose rows each fit one block (most of
// a solve's last levels hold a row or two): (first entry's offset,
// entries, first entry, -1); one block sweeps them in turn, with
// __syncthreads() between them, so their hand-offs stay inside the block.
// The grid is as many blocks as the SMs hold at once (worked out once); a
// block claims items by an atomic ticket, never by blockIdx, and sweeps
// each: it reads the rows' ids, lengths and first slots and the first
// batch of a long row's further slots (read-only, __ldg) and its rows' own
// y values (written by no other item), waits until the entry before the
// item's first is all committed, gathers y and sums, commits, and
// publishes its rows (a run: its last entry's).  A run first asks L2 for
// its entries' rows (prefetch.global.L2), so each later entry's reads
// come from L2.
//
// Deadlock freedom.  Tickets follow plan order, and an item whose first
// entry is e waits only on the items of entry e - 1, whose tickets are all
// smaller (a run's later entries wait on nothing outside its block).
// A ticket is taken only by a running block, which sweeps its items in
// ticket order and never waits on a larger ticket.  So the unfinished item
// with the smallest ticket waits on nothing unfinished, and its block
// runs: every wait ends, whatever the residency (a partial grid, another
// stream's kernel on the card, several processes sharing it).
//
// Coherence within one launch.  y is written by this launch, so it is
// never read through the read-only path: no __ldg, no ld.global.nc, no
// const __restrict__ on y; every y load is a plain coherent load.  The
// writer's rows are committed by all its threads, then __syncthreads(),
// then thread 0 adds the item's rows to the entry's done counter with
// red.release.gpu (cumulative: it orders every store the barrier ordered
// before it).  The waiter's thread 0 polls that counter with
// ld.relaxed.gpu until it holds the entry's rows, then fence.acq_rel.gpu
// (an acquire pattern), then __syncthreads(), and only then does any
// thread gather y.  Release and acquire chain: entry e - 1's items each
// acquired entry e - 2's counter before releasing their own, so entry e
// sees every earlier entry's rows; inside a run, __syncthreads() makes an
// entry's commits visible to the block's next entry.  Waiting on the
// previous entry (not on lv - 1) is right for any plan: entries are levels
// with rows, and the host drops entries without rows before numbering
// them.  No other item waits on a run's inner entries, so only its last
// one is published.
//
// Workspace.  ws holds the ticket at word 0 and entry e's done counter at
// word (e + 1) * kWalkStride (one 128 B line each, so waiters on different
// entries poll different lines); the C entry zeroes it on the call's
// stream before the launch, and the wrapper allocates it per call, so two
// calls on one schedule from two streams share nothing.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_row.cuh"

namespace ell {

constexpr int kWalkThreads = 256;
constexpr int kWalkStride = 32;   // int32 words between two counters
constexpr int kWalkRun = 64;      // entries one run item holds at most

// Slots a thread of a long row reads together, at every column count: a
// row of up to 9 G slots is one round trip once its item may gather
// (twice row_sum's batch at 4 or 8 columns, which measured faster there).
constexpr int kWalkBatch = 8;

// Blocks an SM must hold (the register cap): 4 at one column (its 64
// registers; fewer resident blocks measured slower), 3 at two, 2 at 4 or
// 8 (left alone the compiler took 146 registers at 8 and one block an SM).
// The scalar 8-column and the 2-column kernels (B = 2, or B >= 5 not a
// multiple of 8: off the measured paths) spill a few bytes under it.
template <int NB>
__host__ __device__ constexpr int walk_blocks() {
  return NB == 1 ? 4 : NB == 2 ? 3 : 2;
}

__device__ __forceinline__ int ld_relaxed_gpu(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void fence_acq_rel_gpu() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

__device__ __forceinline__ void red_release_gpu(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// Columns cb .. cb + nb of y's row c, coherent: one NB-float vector (VEC:
// B a multiple of NB and y aligned for it) or nb scalars, 0 past nb.
template <int NB, bool VEC>
struct ColumnGather {
  const float* y;
  int64_t B;
  int cb, nb;

  __device__ __forceinline__ void operator()(float (&xv)[NB], int c) const {
    const float* p = y + static_cast<int64_t>(c) * B + cb;
    if constexpr (VEC) {
      load_lanes<NB, false>(xv, p);
    } else {
#pragma unroll
      for (int b = 0; b < NB; ++b) xv[b] = b < nb ? p[b] : 0.0f;
    }
  }
};

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" :: "l"(p));
}

// The rows of a run's entries (lo, count, level_k) into L2: their ids and
// lengths, and each row's slots up to its entry's longest row (the first
// and last word of each 32-word chunk, so a chunk's lines are all asked
// for).  Prefetches only: no register waits on them.
__device__ __forceinline__ void prefetch_run(const int4* run, int n_run,
                                             const int* cols,
                                             const float* vals,
                                             const int* row_len,
                                             const int* row_ids, int K) {
  for (int q = 0; q < n_run; ++q) {
    const int4 en = run[q];
    const int chunks = (en.z + 31) >> 5;
    for (int idx = threadIdx.x; idx < en.y * chunks; idx += blockDim.x) {
      const int r = idx / chunks, l = idx - r * chunks;
      const int64_t slot = static_cast<int64_t>(en.x) + r;
      const int64_t a = slot * K + 32 * l;
      const int64_t b = a + 31 < slot * K + en.z - 1 ? a + 31
                                                     : slot * K + en.z - 1;
      prefetch_l2(cols + a); prefetch_l2(cols + b);
      prefetch_l2(vals + a); prefetch_l2(vals + b);
      if (l == 0) { prefetch_l2(row_ids + slot); prefetch_l2(row_len + slot); }
    }
  }
}

// One entry's rows lo .. lo + count (longest live row level_k) swept by
// the block: read everything that needs no earlier row (the row id,
// length, first slot, the first batch of further slots up to level_k, the
// row's own y), then, if wait, wait on the done counter before it
// (thread 0), then gather, sum, reduce and commit, ending with
// __syncthreads().
template <int NB, bool VEC>
__device__ __forceinline__ void sweep_entry(
    const int* __restrict__ cols, const float* __restrict__ vals,
    const int* __restrict__ row_len, const int* __restrict__ row_ids,
    float* y, int K, int B, int lo, int count, int level_k,
    const int* wait, int need) {
  constexpr int U = kWalkBatch;
  const int lane_id = threadIdx.x & 31;
  const int nb0 = B < NB ? B : NB;
  const int G = group_width(level_k);
  const int r = static_cast<int>(threadIdx.x) >> (__ffs(G) - 1);
  const int g = threadIdx.x & (G - 1);
  const Held hs = held_sums<NB>(g, G);
  const bool live = r < count;
  int64_t base = 0, at = 0;
  int len = 0, c0 = 0;
  float v0 = 0.0f, own[NB];
  SlotBatch<U> batch;
#pragma unroll
  for (int j = 0; j < NB; ++j) own[j] = 0.0f;
  if (live) {
    const int64_t slot = static_cast<int64_t>(lo) + r;
    at = static_cast<int64_t>(__ldg(row_ids + slot)) * B;
    len = __ldg(row_len + slot);
    base = slot * K;
    if (g < K) {
      v0 = __ldg(vals + base + g);
      c0 = __ldg(cols + base + g);
    }
    // bounded by the level's longest row, not the row's own length, so
    // these reads need not wait for the length
    if (g + G < level_k)
      batch.read(cols + base, vals + base, g + G, G, level_k);
    if (hs.writer) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
        if (j < hs.count && hs.first + j < nb0) own[j] = y[at + hs.first + j];
    }
  }
  if (wait != nullptr && threadIdx.x == 0) {
    while (ld_relaxed_gpu(wait) < need) {
    }
    fence_acq_rel_gpu();
  }
  __syncthreads();
  for (int cb = 0; cb < B; cb += NB) {
    const int nb = B - cb < NB ? B - cb : NB;
    float acc[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[b] = 0.0f;
    if (live) {
      // a later chunk reads the row's slots again from its start
      if (cb > 0 && g + G < len)
        batch.read(cols + base, vals + base, g + G, G, len);
      row_sum_read<NB, U>(acc, cols + base, vals + base, len, g, G, v0, c0,
                          batch, ColumnGather<NB, VEC>{y, B, cb, nb});
    }
    group_reduce<NB>(acc, lane_id, G);
    if (live && hs.writer) {
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int b = hs.first + j;
        if (j < hs.count && b < nb) {
          const int64_t q = at + cb + b;
          y[q] = __fsub_rn(cb == 0 ? own[j] : y[q], acc[j]);
        }
      }
    }
  }
  __syncthreads();
}

// The walk for B columns, NB at a time (a row runs once per chunk of NB
// columns; a chunk reads only rows of earlier entries, so the row's own
// earlier chunks do not feed it).  items[t] = (first slab row, rows,
// entry, level_k), or for a run of whole entries (first entry's lo,
// entries in the run, first entry, -1); entries[e] = (slab offset, rows,
// level_k, 0).
template <int NB, bool VEC>
__global__ void __launch_bounds__(kWalkThreads, walk_blocks<NB>()) walk_kernel(
    const int* __restrict__ cols, const float* __restrict__ vals,
    const int* __restrict__ row_len, const int* __restrict__ row_ids,
    const int4* __restrict__ items, const int4* __restrict__ entries,
    int* ws, float* y, int n_items, int K, int B) {
  __shared__ int s_ticket;
  __shared__ int4 s_run[kWalkRun];
  int* const done = ws + kWalkStride;
  for (;;) {
    if (threadIdx.x == 0) s_ticket = atomicAdd(ws, 1);
    __syncthreads();
    const int t = s_ticket;
    if (t >= n_items) return;                  // uniform over the block
    const int4 it = __ldg(items + t);
    const int e0 = it.z;
    const int n_run = it.w < 0 ? it.y : 1;
    if (it.w < 0) {
      // a run: its entries into shared memory, their rows into L2
      for (int q = threadIdx.x; q < n_run; q += blockDim.x)
        s_run[q] = __ldg(entries + e0 + q);
      __syncthreads();
      prefetch_run(s_run, n_run, cols, vals, row_len, row_ids, K);
    }
    const int* wait = nullptr;
    int need = 0;
    if (e0 > 0) {
      wait = done + (e0 - 1) * kWalkStride;
      need = __ldg(entries + e0 - 1).y;
    }
    int last = 0;
    for (int q = 0; q < n_run; ++q) {
      const int4 en = it.w < 0 ? s_run[q] : make_int4(it.x, it.y, it.w, 0);
      sweep_entry<NB, VEC>(cols, vals, row_len, row_ids, y, K, B, en.x,
                           en.y, en.z, q == 0 ? wait : nullptr, need);
      last = en.y;
    }
    if (threadIdx.x == 0) red_release_gpu(done + (e0 + n_run - 1) * kWalkStride,
                                          it.w < 0 ? last : it.y);
  }
}

// Resident blocks of the card the calling thread is on: occupancy times
// SMs, worked out once per instantiation and device.
template <int NB, bool VEC>
int walk_grid() {
  static const int per_sm = [] {
    int b = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &b, walk_kernel<NB, VEC>, kWalkThreads, 0) != cudaSuccess)
      b = 1;
    return b > 0 ? b : 1;
  }();
  static int sms[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) dev = 0;
  if (sms[dev] == 0) {
    int c = 0;
    cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev);
    sms[dev] = c > 0 ? c : 1;
  }
  return per_sm * sms[dev];
}

// One triangular solve: zero the workspace, launch the walk.  Returns 1
// (the launch), 0 when there is nothing to sweep, or minus a cudaError_t.
template <int NB, bool VEC>
int walk(const int* cols, const float* vals, const int* row_len,
         const int* row_ids, const int* items, const int* entries,
         int* ws, float* y, int n_items, int n_entries, int ws_words, int K,
         int B, cudaStream_t stream) {
  if (n_items <= 0 || B <= 0) return 0;
  if (n_entries <= 0 || ws_words < (n_entries + 1) * kWalkStride)
    return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(
      ws, 0, sizeof(int) * static_cast<size_t>(n_entries + 1) * kWalkStride,
      stream);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int resident = walk_grid<NB, VEC>();
  const int grid = resident < n_items ? resident : n_items;
  walk_kernel<NB, VEC><<<grid, kWalkThreads, 0, stream>>>(
      cols, vals, row_len, row_ids, reinterpret_cast<const int4*>(items),
      reinterpret_cast<const int4*>(entries), ws, y, n_items, K, B);
  err = cudaGetLastError();
  if (err != cudaSuccess) return -static_cast<int>(err);
  return 1;
}

}  // namespace ell
