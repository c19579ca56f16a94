// Lane-batched ELL SpMV over a stacked fleet of panels, for Hopper, and
// the level sweep of the fleet's triangular solves.
//
// ell_spmv_fleet: the full-row product, over each row's live slots
//
//   Y[l, i] = sum_{k < len[f, i]} vals[f, i, k] * x[l, cols[f, i, k]],
//   f = fidx[l]
//
// with len[f, i] = K when no lengths are given.  Replaces the TPU kernel
// src/repro/kernels/spmv.py (ell_spmv_fleet_pallas / _spmv_fleet_kernel),
// which took per-lane panels [L, R, K] that the caller gathered from the
// fleet stack on every apply; this one reads the stack [F, R, K] in place
// through fidx.  It is the whole apply of the "spmv" preconditioner
// families (amg, spai): one launch per PCG iteration.
//
// Sum order (the bits).  A group of G = group_width(K) threads owns one
// (lane, row): thread g sums the slots g, g+G, ... in ascending order by
// __fmaf_rn, then the group reduces by the fixed xor butterfly of
// ell_row.cuh, so a lane's output does not depend on the other lanes of
// the launch, on the grid or on the staging below.
//   * Live slots only.  Rows are left-packed: slots past len hold 0.0 (col
//     0).  Reading k < len with G still group_width(K) gives the bits of
//     reading all K slots, for finite x: each thread's strided slots are
//     the same, and a fused multiply-add of 0.0 adds exactly nothing to a
//     partial sum other than -0; the partial sums start at +0, and a sum
//     becomes -0 only where a negative product is below half the least
//     subnormal and rounds to zero, which the claim excludes (the same
//     argument as csrc/ell_spmv.cu's sweep).
//   * Several lanes at once.  The lanes of one factor (up to NB = 8 per
//     pass) share each staged (col, val) pair, one accumulator a lane.
//     With G = 32 the group reduces them by a reduce-scatter of the same
//     butterfly: at offsets 16, 8, 4 a thread keeps half of its lanes and
//     sends the other half, adding its own value to its partner's exactly
//     as group_sum does (own + partner), so every partial sum is one that
//     group_sum forms (it leaves identical values in both threads of a
//     pair, addition being commutative), then offsets 2, 1 finish one lane
//     per thread: 9 shuffles for 8 lanes instead of 40.  With G < 32
//     (K <= 16) each lane takes group_sum itself.
//   * Short rows.  A row of len <= 8 (or <= 16) live slots may be summed
//     by a group of 8 (16) threads: thread g holds slot g alone either
//     way, and the 32-thread butterfly's first rounds add the +0 of its
//     other threads before the rounds the narrow group shares (the same
//     -0 exclusion).  The narrow group's butterfly is the same
//     reduce-scatter from its own width.
//
// What bounds it on an H100: bytes.  Each live (row, slot) moves 8 bytes
// of panel (int32 col + f32 val) for 2 flops a lane, far below the card's
// operations-per-byte balance, so the least time is the live slots of
// each distinct panel read once, plus the x sectors they gather in each
// lane and Y written, over 3.35 TB/s.  What the design does about each
// cost that a plain grid of (lane, row tile) blocks over all K slots pays:
//   1. Padding.  The fleet keeps each row's live length (len = the index
//      of its last nonzero value + 1); a row reads [0, len), not [0, K).
//      spai's power-law panel is 5.8% live.
//   2. Re-reads by every lane.  A block walks a set of rows for all lanes:
//      it groups the launch's lanes by factor from fidx on the device (no
//      host read), then reads each row's live slots once per pass of up
//      to NB lanes of one factor (once in all for the usual 1-handle
//      solve or bucket of <= 8 lanes), where a (lane, tile) grid
//      reads each tile once per lane, from L2 after the first.
//   3. Bytes in flight.  Each warp streams its rows' live spans through a
//      ring of kStages shared-memory stages by cp.async (16 B, L2 only):
//      while it sums stage t it has the next kStages - 1 items in flight.
//      A span that does not start or end on 16 B (a K = 1,086 row starts
//      8 B aligned) is copied as the 16 B chunks that cover it; a
//      covering chunk holds at least one byte of the span, so it never
//      leaves the tensor's allocation, and the consumer starts at the
//      span's offset in the first chunk.  A short row would leave most of
//      a warp idle and one gather in flight a row: where the next rows of
//      a warp's stream all hold <= 8 (or <= 16) live slots, one item
//      takes 4 (or 2) of them, a group of 8 (16) threads a row, with the
//      same bits (above).
//   4. The gathers of x.  When a pass's 2 to 8 lanes of x fit in shared
//      memory (nb * n * 4 <= kXSmemBytes: 8 lanes at n = 4,096 take
//      128 KB) each block stages them there once a pass, interleaved, by
//      16 B loads made while its warps' first items are in flight (one
//      lane reads its 16 KB through L1 as fast); otherwise (the 64^3 main panel, n = 262,144) a first small kernel
//      interleaves the lanes of x ([n][8] for 8 lanes), so one 32 B sector
//      holds a column's value for every lane and a slot's 8 gathers cost
//      one sector through L1, not 8.  Either way the grid is as many
//      blocks as the SMs hold at once, each walking its warps' rows, so x
//      is staged and the lanes grouped once a block.
//   5. The wrapper's host work: kernels/spmv.py resolves this entry point
//      once and caches it.
//
// ell_sweep_fleet: one lane-batched unit-triangular solve, level by
// level, in place, with the commit fused in:
//
//   y[l, i] = y[l, i] - sum_{k < len[f, i]} vals[f, i, k] * y[l, cols[f, i, k]]
//
// for the rows i = rows[f, start[f, lv] .. start[f, lv + 1]) of each level
// lv of factor f = fidx[l] (each factor's rows sorted stably by level, with
// each level's start offset).  Rows of other levels are neither read as
// outputs nor written; in place is safe because a level's rows read only
// rows of lower levels, written by earlier launches (so the read-only
// cache never holds a stale one).  Replaces, with ell_spmv_fleet, the TPU
// kernel above: the reference sweeps every level with the full-row kernel
// and keeps that level's rows with a where().
//
// Same bits as the full-row kernel followed by y - Y.  A row reads its len
// live slots only, with G = group_width(level_k) threads, level_k the
// level's longest live row over the bucket (the host plan's third column);
// the full-row kernel reads all K slots with G = group_width(K).  Their
// sums are equal bit for bit, lane by lane, for finite y:
//   * slots past len hold 0.0 (col 0), and a fused multiply-add of 0.0
//     adds exactly nothing to a partial sum other than -0;
//   * the partial sums start at +0, and a sum becomes -0 only where a
//     negative product is below half the least subnormal and rounds to
//     zero: that underflow is the one exception, which the claim excludes;
//   * with level_k > 32 both widths are 32, so both kernels give thread g
//     the same live slots in the same order;
//   * with level_k <= 32, G >= level_k >= len, so each thread holds at
//     most one live slot; the wider full-row group's extra threads hold
//     +0, and its extra butterfly rounds (offsets >= G) add +0 to each
//     thread's value before the rounds that both kernels share.
// Lanes share a row's read (below) but not its sums: each keeps its own
// accumulator, summed in the order above, and the group reduces them by
// ell::group_reduce (ell_row.cuh), the reduce-scatter of the full-row
// kernel (halve: own + partner, as group_sum), as many halving steps as
// the group has offsets, then the plain butterfly; the gather and the
// pipelined long rows are ell_row.cuh's row_sum, which the library
// path's level walk (ell_walk.cuh) shares.  The commit is one __fsub_rn,
// as torch's y - Y.
//
// What bounds it on an H100: bytes at the largest levels (the live slots,
// 8 B each, read once, the y sectors they gather, each row's list entry,
// length and y in and out: at the 64^3 cell's largest forward level,
// 24,322 rows and 32,630 live slots, about 1.2 us for 8 lanes), and the
// launch and the chain of dependent reads at the others: of that
// factor's 1,246 levels, 914 hold at most 64 rows and 1,118 a row of more
// than 32 live slots.  What the design does about each cost:
//   1. The host.  The level loop runs in the C entry point from a host
//      plan of (level, row count bound, level_k) that admission builds
//      (core/solver.py FactorFleet), so a triangular solve is one ctypes
//      call: no Python, no tensor check and no device read per level.
//      The lanes are grouped by factor once per solve, by a first small
//      launch, into a table of passes that a level kernel reads in one
//      16 B load.
//   2. Idle threads.  The group width follows the level's longest live
//      row, not the panel's K: the largest forward level (level_k 5) runs
//      8 threads a row, 32 rows a block of 256 threads, where groups of
//      32 (K = 1,024) left 31 of each 32 threads idle, 8 rows a block.
//   3. Re-reads by every lane.  A block serves a pass of up to 8 lanes of
//      one factor and reads each live (col, val) once for all of them.
//   4. The gathers of y.  y may be interleaved ([R][ld] storage, lane l at
//      offset l).  Where a row then holds exactly a pass's width of lanes
//      (an 8-lane solve, a served bucket of 8 slots), every pass gathers a
//      column's whole row as two 16 B loads from one 32 B sector, where
//      lane-major y costs 8 sectors a slot, and writes its own factor's
//      lanes: the lanes of two factors interleaved in fidx still load
//      vectors.
//   5. Dependent reads.  A row's length, its first slot and the y it will
//      commit to are read at once; a level with rows longer than 32 slots
//      (LONG) reads a thread's further slots in batches of 4 (8 for 1-2
//      lanes), each batch's gathers in flight with the next batch's
//      (col, val) reads; a level without keeps the registers those would
//      take, for more blocks an SM.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_row.cuh"

namespace {

constexpr int kSweepThreads = 256;       // the sweep's block

// ---- the full-row product -------------------------------------------
constexpr int kSpmvThreads = 512;        // 16 warps a block
constexpr int kWarps = kSpmvThreads / 32;
constexpr int kChunk = 128;              // slots a stage (a multiple of 32)
constexpr int kStages = 4;               // ring depth per warp
constexpr int kStageWords = kChunk + 8;  // + the covering chunks' slack
constexpr int kRowWords = 32;            // a short row's part of a stage
constexpr int kMeta = 5;                 // int4s a stage: header + 4 rows
constexpr int kMaxLanes = 1024;          // lanes one launch takes
constexpr int kXSmemBytes = 136 * 1024;  // x staged when it fits in this
constexpr int kRingBytes = kWarps * kStages * 2 * kStageWords * 4;
constexpr int kMetaBytes = kWarps * kStages * kMeta * 16;
constexpr unsigned kFull = 0xffffffffu;

using ell::group_reduce;
using ell::halve;
using ell::load_lanes;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy the 4-byte words [src, src + n) into the stage dst as the 16 B
// chunks that cover them; returns the words' offset in dst (0..3).
__device__ __forceinline__ int stage_span(float* dst, const void* src, int n,
                                          int lane) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(src);
  const uintptr_t a = p & ~static_cast<uintptr_t>(15);
  if (n <= 0) return 0;
  const int chunks = static_cast<int>(
      (((p + 4 * static_cast<uintptr_t>(n) + 15) & ~static_cast<uintptr_t>(15))
       - a) / 16);
  for (int q = lane; q < chunks; q += 32)
    cp_async16(dst + 4 * q, reinterpret_cast<const char*>(a) + 16 * q);
  return static_cast<int>((p - a) / 4);
}

// The butterfly of a group of Gp >= NB threads (Gp a power of two <= 32,
// groups aligned in the warp) over NB accumulators at once: log2 NB
// halving steps from offset Gp / 2, then the remaining offsets on one
// value.  Thread g of the group returns the full sum of accumulator
// (g >> (log2 Gp - log2 NB)) & (NB - 1): bitwise group_sum of it.
template <int NB>
__device__ __forceinline__ float group_sum_scatter(float* a, int lane_id,
                                                   int Gp) {
  int off = Gp >> 1;
  if constexpr (NB >= 8) { halve<8>(a, off, lane_id & off); off >>= 1; }
  if constexpr (NB >= 4) { halve<4>(a, off, lane_id & off); off >>= 1; }
  if constexpr (NB >= 2) { halve<2>(a, off, lane_id & off); off >>= 1; }
  float s = a[0];
  for (; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_xor_sync(kFull, s, off));
  return s;
}

// Where a pass reads x.  Staged (XS): the pass's lanes in shared memory
// interleaved [n][NB] (NB = 8: a column's two 16 B halves swapped on bit 2
// of c, spreading a quarter-warp's first vector reads over all banks).
// Otherwise x in device memory laid out [n][ld] (lanes interleaved, so one
// 32 B sector holds 8 lanes' values of a column; for one lane, x itself
// with ld = 1): the pass's lanes at offsets lanes[b] (shared memory), or,
// when they are NB consecutive lanes from a multiple of NB (vec), one or
// two vectors at lane0.
template <int NB>
struct XRead {
  const float* base;
  const int* lanes;
  int ld, lane0, nl;
  bool vec;
};

// NB accumulators += v * (x of each lane of the pass at column c).
template <int NB, bool XS>
__device__ __forceinline__ void fma_lanes(float (&acc)[NB], float v, int c,
                                          const XRead<NB>& xr) {
  float xv[NB];
  if constexpr (XS) {
    if constexpr (NB == 8) {
      const int swz = (c >> 2) & 1;
      const float4* q = reinterpret_cast<const float4*>(xr.base) + 2 * c;
      const float4 lo = q[swz], hi = q[1 - swz];
      xv[0] = lo.x; xv[1] = lo.y; xv[2] = lo.z; xv[3] = lo.w;
      xv[4] = hi.x; xv[5] = hi.y; xv[6] = hi.z; xv[7] = hi.w;
    } else {
      load_lanes<NB, false>(xv, xr.base + NB * c);
    }
  } else {
    const float* p = xr.base + static_cast<int64_t>(c) * xr.ld;
    if (xr.vec) {
      load_lanes<NB, true>(xv, p + xr.lane0);
    } else {
#pragma unroll
      for (int b = 0; b < NB; ++b)
        if (b < xr.nl) xv[b] = __ldg(p + xr.lanes[b]);
    }
  }
#pragma unroll
  for (int b = 0; b < NB; ++b)
    if (b < xr.nl) acc[b] = __fmaf_rn(v, xv[b], acc[b]);
}

// Column c's NB lane values into the staged x (the layout above).
template <int NB>
__device__ __forceinline__ void store_column(float* xs, int c,
                                             const float (&v)[NB]) {
  if constexpr (NB == 8) {
    const int swz = (c >> 2) & 1;
    float4* q = reinterpret_cast<float4*>(xs) + 2 * c;
    q[swz] = make_float4(v[0], v[1], v[2], v[3]);
    q[1 - swz] = make_float4(v[4], v[5], v[6], v[7]);
  } else if constexpr (NB == 4) {
    reinterpret_cast<float4*>(xs)[c] = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (NB == 2) {
    reinterpret_cast<float2*>(xs)[c] = make_float2(v[0], v[1]);
  } else {
    xs[c] = v[0];
  }
}

// The block stages the pass's nl lanes of x [L, n] into xs (lanes past nl
// as 0): 16 B loads of 4 columns of every lane at once where each lane's
// row starts on 16 B, then the columns transposed into place.
template <int NB>
__device__ __forceinline__ void stage_x(float* xs, const float* x,
                                        const int* lanes, int nl, int n,
                                        bool aligned) {
  if (aligned) {
#pragma unroll 2
    for (int q = threadIdx.x; q < n / 4; q += kSpmvThreads) {
      float4 v[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b)
        v[b] = b < nl ? __ldg(reinterpret_cast<const float4*>(
                            x + static_cast<int64_t>(lanes[b]) * n) + q)
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float col[4][NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        col[0][b] = v[b].x; col[1][b] = v[b].y;
        col[2][b] = v[b].z; col[3][b] = v[b].w;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) store_column<NB>(xs, 4 * q + j, col[j]);
    }
  } else {
    for (int c = threadIdx.x; c < n; c += kSpmvThreads) {
      float col[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b)
        col[b] = b < nl ? x[static_cast<int64_t>(lanes[b]) * n + c] : 0.0f;
      store_column<NB>(xs, c, col);
    }
  }
}

// The warp's stream of work: "units" (a row when G = 32, a run of 32 / G
// consecutive rows when G < 32), unit u = gw, gw + NW, ... for global warp
// gw of NW.  With G = 32 an item is one chunk of kChunk slots of a row
// (an empty row is one empty chunk, so its zero is written), or, where the
// next rows of the stream are short, 4 rows of <= 8 live slots summed by
// groups of 8 threads or 2 rows of <= 16 by groups of 16: each row's live
// slots then fit its group, a thread holds at most one, and the narrow
// group's butterfly gives the 32-thread group's bits (the wider group's
// other threads hold +0: csrc/ell_spmv.cu's argument for its sweep).
// Each item is staged into one ring slot; its meta: a header (rows,
// group width) and per row (row, slots, col offset, val offset | last
// chunk of its row << 8), a short row's span at kRowWords * r.
template <int NB, bool XS, typename Stage>
__device__ __forceinline__ void warp_rows(
    const int* __restrict__ cols, const float* __restrict__ vals,
    const int* __restrict__ lens, float* __restrict__ y, int64_t f, int R,
    int K, int G, const XRead<NB>& xr, float* ring, int4* meta, int lane_id,
    int gw, int NW, Stage stage) {
  const int RW = 32 / G;                      // rows a unit
  const int U = G == 32 ? R : (R + RW - 1) / RW;
  const int64_t panel = f * R;
  const int nl = xr.nl;

  // producer: the next item to stage.  lwin holds the lengths of the
  // rows of units pw0 .. pw0 + 31, one a thread.
  int pj = 0, pc = 0, pchunks = 0, plen = 0, pw0 = 0, lwin = 0;
  auto row_len = [&](int i) {
    if (i >= R) return 0;
    const int len = lens ? __ldg(lens + panel + i) : K;
    return len < 0 ? 0 : (len > K ? K : len);
  };
  auto unit = [&](int j) { return gw + j * NW; };
  auto enter_unit = [&]() {
    if (G == 32) {
      if (pj - pw0 >= 32) {
        pw0 += 32;
        lwin = row_len(unit(pw0 + lane_id));
      }
      plen = __shfl_sync(kFull, lwin, pj - pw0);
      pchunks = plen > 0 ? (plen + kChunk - 1) / kChunk : 1;
    } else {
      pchunks = 1;
    }
  };
  if (G == 32) lwin = row_len(unit(lane_id));
  if (unit(0) < U) enter_unit();
  int n_items = 0;                            // items staged so far
  auto stage_next = [&](int slot) {
    if (unit(pj) < U) {
      float* sc = ring + 2 * slot * kStageWords;
      float* sv = sc + kStageWords;
      int4* ms = meta + slot * kMeta;
      int rows = 1, Gp = G;
      if (G == 32 && pc == 0) {               // a row starts: short rows?
        const int k0 = pj - pw0;
        const int l1 = __shfl_sync(kFull, lwin, min(k0 + 1, 31));
        const int l2 = __shfl_sync(kFull, lwin, min(k0 + 2, 31));
        const int l3 = __shfl_sync(kFull, lwin, min(k0 + 3, 31));
        if (k0 + 3 < 32 && unit(pj + 3) < U
            && max(max(plen, l1), max(l2, l3)) <= 8) {
          rows = 4;
          Gp = 8;
        } else if (k0 + 1 < 32 && unit(pj + 1) < U && max(plen, l1) <= 16) {
          rows = 2;
          Gp = 16;
        }
        if (rows > 1) {
          const int lr[4] = {plen, l1, l2, l3};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if (r < rows) {
              const int i = unit(pj + r);
              const int64_t src = (panel + i) * static_cast<int64_t>(K);
              const int hc = stage_span(sc + kRowWords * r, cols + src, lr[r],
                                        lane_id);
              const int hv = stage_span(sv + kRowWords * r, vals + src, lr[r],
                                        lane_id);
              if (lane_id == 0) ms[1 + r] = make_int4(i, lr[r], hc, hv);
            }
          }
          if (lane_id == 0) ms[0] = make_int4(rows, Gp, 0, 0);
          ++n_items;
          pj += rows;
          if (unit(pj) < U) enter_unit();
          cp_async_commit();
          return;
        }
      }
      int first, ns, k0;
      if (G == 32) {
        first = unit(pj);
        k0 = pc * kChunk;
        ns = min(kChunk, plen - k0);
      } else {
        first = unit(pj) * RW;
        k0 = 0;
        ns = min(RW, R - first) * K;
      }
      const int64_t src = (panel + first) * static_cast<int64_t>(K) + k0;
      const int hc = stage_span(sc, cols + src, ns, lane_id);
      const int hv = stage_span(sv, vals + src, ns, lane_id);
      const bool last = pc + 1 == pchunks;
      if (lane_id == 0) {
        ms[0] = make_int4(1, Gp, 0, 0);
        ms[1] = make_int4(first, ns, hc, hv | last << 8);
      }
      ++n_items;
      if (last) {
        ++pj;
        pc = 0;
        if (unit(pj) < U) enter_unit();
      } else {
        ++pc;
      }
    }
    cp_async_commit();                        // one group an item, or empty
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) stage_next(s);
  stage();                    // the block's x, while the first items land
  const int* s_lanes = xr.lanes;
  float acc[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = 0.0f;
  constexpr int h = NB == 8 ? 3 : NB == 4 ? 2 : NB == 2 ? 1 : 0;
  for (int t = 0; t < n_items; ++t) {
    stage_next((t + kStages - 1) % kStages);
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const int slot = t % kStages;
    const int4* ms = meta + slot * kMeta;
    const int4 hd = ms[0];
    const int* sc = reinterpret_cast<const int*>(ring + 2 * slot * kStageWords);
    const float* sv = ring + (2 * slot + 1) * kStageWords;
    if (G == 32 && hd.y == 32) {              // a chunk of one row
      const int4 m = ms[1];
      sc += m.z;
      sv += m.w & 0xff;
      for (int k = lane_id; k < m.y; k += 32)
        fma_lanes<NB, XS>(acc, sv[k], sc[k], xr);
      if (m.w >> 8) {                         // the row's last chunk
        const float s = group_sum_scatter<NB>(acc, lane_id, 32);
        const int b = lane_id >> (5 - h);
        if ((lane_id & ((32 >> h) - 1)) == 0 && b < nl)
          y[static_cast<int64_t>(s_lanes[b]) * R + m.x] = s;
#pragma unroll
        for (int b2 = 0; b2 < NB; ++b2) acc[b2] = 0.0f;
      }
    } else if (G == 32) {                     // short rows, a group each
      const int Gp = hd.y, lg = __ffs(Gp) - 1;
      const int r = lane_id >> lg, g = lane_id & (Gp - 1);
      const int4 m = r < hd.x ? ms[1 + r] : make_int4(0, 0, 0, 0);
      if (g < m.y)
        fma_lanes<NB, XS>(acc, sv[kRowWords * r + m.w + g],
                          sc[kRowWords * r + m.z + g], xr);
      const float s = group_sum_scatter<NB>(acc, lane_id, Gp);
      const int b = (g >> (lg - h)) & (NB - 1);
      if (r < hd.x && (g & ((Gp >> h) - 1)) == 0 && b < nl)
        y[static_cast<int64_t>(s_lanes[b]) * R + m.x] = s;
#pragma unroll
      for (int b2 = 0; b2 < NB; ++b2) acc[b2] = 0.0f;
    } else {                                  // K <= 16: runs of rows
      const int4 m = ms[1];
      const int r_local = lane_id / G, g = lane_id % G;
      const int i = m.x + r_local;
      const int len = row_len(i);
      sc += m.z + r_local * K;
      sv += (m.w & 0xff) + r_local * K;
      for (int k = g; k < len; k += G) fma_lanes<NB, XS>(acc, sv[k], sc[k], xr);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float s = ell::group_sum(acc[b], G);
        if (g == 0 && i < R && b < nl)
          y[static_cast<int64_t>(s_lanes[b]) * R + i] = s;
        acc[b] = 0.0f;
      }
    }
    __syncwarp();                             // the slot is free again
  }
  cp_async_wait<0>();
}

// x [L, n] to xt [n][ld], lanes interleaved (ld >= L; lanes L .. ld - 1
// hold 0).
__global__ void __launch_bounds__(256) interleave_lanes_kernel(
    const float* __restrict__ x, float* __restrict__ xt, int L, int n,
    int ld) {
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < n;
       c += gridDim.x * blockDim.x) {
    float* row = xt + static_cast<int64_t>(c) * ld;
    for (int l = 0; l < ld; l += 4) {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = l + j < L ? x[static_cast<int64_t>(l + j) * n + c] : 0.0f;
      if (ld % 4 == 0) {
        *reinterpret_cast<float4*>(row + l) = make_float4(v[0], v[1], v[2],
                                                          v[3]);
      } else {
        for (int j = 0; j < 4 && l + j < ld; ++j) row[l + j] = v[j];
      }
    }
  }
}

// Staged x takes most of an SM's shared memory (one block an SM), so its
// kernels may use 128 registers a thread; the L1 kernels hold two blocks
// an SM at 64.
template <int NB, bool XS>
__global__ void __launch_bounds__(kSpmvThreads, XS ? 1 : 2)
    ell_spmv_fleet_kernel(
    const int* __restrict__ cols, const float* __restrict__ vals,
    const int* __restrict__ lens, const int* __restrict__ fidx,
    const float* __restrict__ x, const float* __restrict__ xt,
    float* __restrict__ y, int L, int R, int K, int n, int ld, int G) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x / 32, lane_id = threadIdx.x % 32;
  float* ring = smem + warp * kStages * 2 * kStageWords;
  int4* meta = reinterpret_cast<int4*>(smem + kRingBytes / 4)
               + warp * kStages * kMeta;
  int* s_fidx = reinterpret_cast<int*>(smem + (kRingBytes + kMetaBytes) / 4);
  int* s_lead = s_fidx + L;
  int* s_order = s_lead + L;
  float* xs = smem + (kRingBytes + kMetaBytes) / 4 + ((3 * L + 3) & ~3);

  // group the lanes by factor: lead[l] = the first lane of l's factor;
  // order = the lanes sorted stably by lead
  for (int l = threadIdx.x; l < L; l += kSpmvThreads) s_fidx[l] = fidx[l];
  __syncthreads();
  for (int l = threadIdx.x; l < L; l += kSpmvThreads) {
    int lead = l;
    for (int m = 0; m < l; ++m)
      if (s_fidx[m] == s_fidx[l]) { lead = m; break; }
    s_lead[l] = lead;
  }
  __syncthreads();
  for (int l = threadIdx.x; l < L; l += kSpmvThreads) {
    const int lead = s_lead[l];
    int pos = 0;
    for (int m = 0; m < L; ++m) {
      const int lm = s_lead[m];
      pos += lm < lead || (lm == lead && m < l);
    }
    s_order[pos] = l;
  }
  __syncthreads();

  const int gw = blockIdx.x * kWarps + warp, NW = gridDim.x * kWarps;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0
                       && (n & 3) == 0;
  for (int p = 0; p < L;) {                   // one pass a run of <= NB lanes
    const int lead = s_lead[s_order[p]];
    XRead<NB> xr;
    xr.lanes = s_order + p;
    xr.lane0 = s_order[p];
    xr.nl = 1;
    while (xr.nl < NB && p + xr.nl < L && s_lead[s_order[p + xr.nl]] == lead)
      ++xr.nl;
    bool consecutive = xr.lane0 % NB == 0 && xr.nl == NB;
    for (int b = 1; b < xr.nl; ++b)
      consecutive = consecutive && s_order[p + b] == xr.lane0 + b;
    xr.vec = consecutive;
    xr.base = XS ? xs : xt;
    xr.ld = ld;
    if constexpr (XS) {
      // the first items of every warp are in flight before the block
      // stages x: all warps are done with the last pass's x first
      warp_rows<NB, XS>(cols, vals, lens, y, s_fidx[lead], R, K, G, xr, ring,
                        meta, lane_id, gw, NW, [&]() {
                          __syncthreads();
                          stage_x<NB>(xs, x, xr.lanes, xr.nl, n, aligned);
                          __syncthreads();
                        });
    } else {
      warp_rows<NB, XS>(cols, vals, lens, y, s_fidx[lead], R, K, G, xr, ring,
                        meta, lane_id, gw, NW, []() {});
    }
    p += xr.nl;
  }
}

// Lanes a pass takes for L lanes: the next power of two, at most 8.
inline int lanes_a_pass(int L) { return L > 4 ? 8 : L > 2 ? 4 : L; }

template <int NB, bool XS>
int launch_spmv(const int* cols, const float* vals, const int* lens,
                const int* fidx, const float* x, float* xt, float* y, int L,
                int R, int K, int n, cudaStream_t stream) {
  auto kernel = ell_spmv_fleet_kernel<NB, XS>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // per device: the SM count, and the kernel's shared-memory opt-in
  static int sms[64] = {0};
  static bool opted[64] = {false};
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kRingBytes + kMetaBytes + 4 * 3 * kMaxLanes + kXSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[dev] = true;
  }
  int ld;
  const float* xread = xt;
  if (XS) {
    ld = NB;                                  // interleaved [n][NB]
  } else if (L == 1) {
    ld = 1;
    xread = x;                                // one lane: x is [n][1]
  } else {
    ld = L <= 8 ? NB : (L + 7) & ~7;
    if (xt == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const int blocks = min((n + 255) / 256, sms[dev] * 8);
    interleave_lanes_kernel<<<blocks, 256, 0, stream>>>(x, xt, L, n, ld);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t smem = kRingBytes + kMetaBytes + 4 * ((3 * L + 3) & ~3)
                      + (XS ? static_cast<size_t>(NB) * ((n + 3) & ~3) * 4
                            : 0);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kSpmvThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int G = ell::group_width(K);
  const int units = G == 32 ? R : (R + 32 / G - 1) / (32 / G);
  const int want = (units + kWarps - 1) / kWarps;
  const int blocks = want < sms[dev] * per_sm ? want : sms[dev] * per_sm;
  kernel<<<blocks, kSpmvThreads, smem, stream>>>(cols, vals, lens, fidx, x,
                                                  xread, y, L, R, K, n, ld, G);
  return static_cast<int>(cudaGetLastError());
}

template <int NB>
int launch_nb(const int* cols, const float* vals, const int* lens,
              const int* fidx, const float* x, float* xt, float* y, int L,
              int R, int K, int n, int gather, cudaStream_t stream) {
  // one lane gathers through L1 at least as fast as from a staged copy
  // (its x is a 16 KB row at n = 4,096): stage only passes of >= 2 lanes
  const bool fits =
      static_cast<int64_t>(NB) * ((n + 3) & ~3) * 4 <= kXSmemBytes;
  const bool stage = NB >= 2 && fits;
  if (gather == 1 && !fits) return static_cast<int>(cudaErrorInvalidValue);
  if (gather == 1 || (gather < 0 && stage))
    return launch_spmv<NB, true>(cols, vals, lens, fidx, x, xt, y, L, R, K,
                                 n, stream);
  return launch_spmv<NB, false>(cols, vals, lens, fidx, x, xt, y, L, R, K, n,
                                stream);
}

// ---- the level sweep --------------------------------------------------

// Group the sweep's lanes by factor, once per triangular solve, into
// groups (5 * L int32): at int4 p < L, pass p's (factor, first position
// in the order, lanes, 0), lanes 0 past the last pass; from 4 * L, the
// lanes sorted stably by the first lane of their factor.  A pass is a run
// of up to NB lanes of one factor.
__global__ void __launch_bounds__(kMaxLanes) group_lanes_kernel(
    const int* __restrict__ fidx, int* __restrict__ groups, int L, int NB) {
  __shared__ int s_fidx[kMaxLanes], s_lead[kMaxLanes], s_order[kMaxLanes];
  __shared__ int4 s_pass[kMaxLanes];
  __shared__ int s_passes;
  for (int l = threadIdx.x; l < L; l += blockDim.x) s_fidx[l] = fidx[l];
  __syncthreads();
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    int lead = l;
    for (int m = 0; m < l; ++m)
      if (s_fidx[m] == s_fidx[l]) { lead = m; break; }
    s_lead[l] = lead;
  }
  __syncthreads();
  int* order = groups + 4 * L;
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    const int lead = s_lead[l];
    int pos = 0;
    for (int m = 0; m < L; ++m) {
      const int lm = s_lead[m];
      pos += lm < lead || (lm == lead && m < l);
    }
    s_order[pos] = l;
    order[pos] = l;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int passes = 0;
    for (int q = 0; q < L;) {
      const int lead = s_lead[s_order[q]];
      int nl = 1;
      while (nl < NB && q + nl < L && s_lead[s_order[q + nl]] == lead) ++nl;
      s_pass[passes++] = make_int4(s_fidx[lead], q, nl, 0);
      q += nl;
    }
    s_passes = passes;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < L; p += blockDim.x)
    reinterpret_cast<int4*>(groups)[p] =
        p < s_passes ? s_pass[p] : make_int4(0, 0, 0, 0);
}

// Where a pass reads and writes y: accumulator b is lane b of an
// interleaved y whose rows hold NB lanes (VEC: one or two 16 B loads of a
// 32 B sector a slot), or the pass's lane order[q0 + b] (held in lanes[b]
// for the gathers), one load each; it is written where bit b of member is
// set.
template <int NB, bool VEC>
struct PassLanes {
  int lanes[VEC ? 1 : NB];
  const int* order;
  int q0, nl, sl, si;
  unsigned member;

  // accumulator b's entry of row i: b fixed at compile time (gathers)
  __device__ __forceinline__ int64_t at(int b, int64_t i) const {
    const int lane = VEC ? b : lanes[VEC ? 0 : b];
    return lane * static_cast<int64_t>(sl) + i * si;
  }
  // the same for a b known only at run time (the writers')
  __device__ __forceinline__ int64_t at_dyn(int b, int64_t i) const {
    const int lane = VEC ? b : order[q0 + b];
    return lane * static_cast<int64_t>(sl) + i * si;
  }
};

// xv[b] = accumulator b's lane of y at column c.
template <int NB, bool VEC>
__device__ __forceinline__ void gather(float (&xv)[NB], int c,
                                       const float* y,
                                       const PassLanes<NB, VEC>& pl) {
  if constexpr (VEC) {
    load_lanes<NB, true>(xv, y + static_cast<int64_t>(c) * pl.si);
  } else {
#pragma unroll
    for (int b = 0; b < NB; ++b)
      xv[b] = b < pl.nl ? __ldg(y + pl.at(b, c)) : 0.0f;
  }
}

// One pass over the block's rows of level lv of factor f: G threads a row,
// thread g summing its slots g, g + G, ... below the row's length in
// ascending order for every accumulator at once, then group_reduce, then
// the commit y - sum by the writers.
template <int NB, bool VEC, bool LONG>
__device__ __forceinline__ void sweep_pass(
    const int* __restrict__ cols, const float* __restrict__ vals,
    const int* __restrict__ lens, const int* __restrict__ rows, float* y,
    const PassLanes<NB, VEC>& pl, int64_t f, int lo, int count, int r,
    int R, int K, int G, int g, int lane_id, int first, int held,
    bool writer) {
  float acc[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = 0.0f;
  float own0 = 0.0f;                // the first written sum's y, read early
  int i = 0;
  if (r < count) {
    i = __ldg(rows + f * R + lo + r);
    const int64_t base = (f * R + i) * static_cast<int64_t>(K);
    // the row's length, its first slot and the own value are read at
    // once, not one after another
    const int len = __ldg(lens + f * R + i);
    float v0 = 0.0f;
    int c0 = 0;
    if (g < K) {
      v0 = __ldg(vals + base + g);
      c0 = __ldg(cols + base + g);
    }
    if (writer && (pl.member >> first & 1u)) own0 = y[pl.at_dyn(first, i)];
    ell::row_sum<NB, LONG>(acc, cols + base, vals + base, len, g, G, v0, c0,
                           [&](float (&xv)[NB], int c) {
                             gather<NB, VEC>(xv, c, y, pl);
                           });
  }
  group_reduce<NB>(acc, lane_id, G);
  if (r < count && writer) {
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int b = first + j;
      if (j < held && (pl.member >> b & 1u)) {
        const int64_t at = pl.at_dyn(b, i);
        y[at] = __fsub_rn(j == 0 ? own0 : y[at], acc[j]);
      }
    }
  }
}

// One level lv of the sweep for NB lanes a pass.  Block (x, y) takes the
// rows x * (kSweepThreads / G) .. of level lv, G threads a row, in the
// passes y, y + gridDim.y, ... of the lanes' grouping.  y holds lane l's
// row i at y[l * sl + i * si]: lane-major (sl = R, si = 1) or interleaved
// (sl = 1, si = ld >= L; one 32 B sector then holds a column's value for
// 8 lanes).  Each (col, val) pair is read once for the pass's lanes.
// Where an interleaved row holds exactly NB lanes (si == NB: a served
// bucket of 8 slots, an 8-rhs solve), a pass sums all NB of them from
// one 32 B sector a slot and writes only its own factor's: the others'
// sums use this factor's row and are dropped.
template <int NB, bool LONG>
__global__ void __launch_bounds__(kSweepThreads) ell_sweep_fleet_kernel(
    const int* __restrict__ cols, const float* __restrict__ vals,
    const int* __restrict__ lens, const int* __restrict__ rows,
    const int* __restrict__ starts, const int* __restrict__ fidx,
    const int* __restrict__ groups, float* y, int L, int R, int K,
    int n_starts, int lv, int G, int sl, int si) {
  const int* order = groups + 4 * L;
  const int rows_per_block = kSweepThreads / G;
  const int g = threadIdx.x & (G - 1);
  const int lane_id = threadIdx.x & 31;
  const int r = blockIdx.x * rows_per_block + static_cast<int>(threadIdx.x) / G;
  // the accumulators whose full sums this thread holds after group_reduce,
  // and whether it writes them (one writer per sum): G and NB fix them
  const ell::Held hs = ell::held_sums<NB>(g, G);
  const int held = hs.count, first = hs.first;
  const bool writer = hs.writer;
  // vector gathers: an interleaved row of exactly NB lanes, read whole
  const bool vec = NB >= 2 && sl == 1 && si == NB
      && reinterpret_cast<uintptr_t>(y) % (NB >= 4 ? 16 : 8) == 0;
  for (int p = blockIdx.y; p < L; p += gridDim.y) {
    const int4 ps = reinterpret_cast<const int4*>(groups)[p];
    if (ps.z == 0) break;                        // past the last pass
    const int64_t f = ps.x;
    const int q0 = ps.y, nl = ps.z;
    const int lo = __ldg(starts + f * n_starts + lv);
    const int count = __ldg(starts + f * n_starts + lv + 1) - lo;
    if (static_cast<int>(blockIdx.x) * rows_per_block >= count)
      continue;                                   // uniform over the block
    if (vec) {
      // every lane of the row is summed; the factor's lanes are written
      PassLanes<NB, true> pl;
      pl.member = 0;
#pragma unroll
      for (int b = 0; b < NB; ++b)
        pl.member |= static_cast<unsigned>(__ldg(fidx + b) == f) << b;
      pl.order = order; pl.q0 = q0;
      pl.nl = nl; pl.sl = sl; pl.si = si;
      sweep_pass<NB, true, LONG>(cols, vals, lens, rows, y, pl, f, lo, count,
                                 r, R, K, G, g, lane_id, first, held,
                                 writer);
    } else {
      PassLanes<NB, false> pl;
#pragma unroll
      for (int b = 0; b < NB; ++b) pl.lanes[b] = order[q0 + (b < nl ? b : 0)];
      pl.order = order; pl.q0 = q0;
      pl.nl = nl; pl.sl = sl; pl.si = si;
      pl.member = (1u << nl) - 1;
      sweep_pass<NB, false, LONG>(cols, vals, lens, rows, y, pl, f, lo,
                                  count, r, R, K, G, g, lane_id, first, held,
                                  writer);
    }
  }
}

template <int NB>
int sweep_levels(const int* cols, const float* vals, const int* lens,
                 const int* rows, const int* starts, const int* fidx,
                 int* groups, float* y, const int* plan, int n_plan, int L,
                 int R, int K, int n_starts, int sl, int si,
                 cudaStream_t stream) {
  bool any = false;
  for (int e = 0; e < n_plan; ++e) any = any || plan[3 * e + 1] > 0;
  if (!any) return 0;
  group_lanes_kernel<<<1, L < 32 ? 32 : (L + 31) & ~31, 0, stream>>>(
      fidx, groups, L, NB);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return -static_cast<int>(err);
  // one y block more than the fewest passes, so the passes of a launch
  // whose lanes hold two factors (a served bucket) run side by side;
  // blocks past the passes leave at once
  const int fewest = (L + NB - 1) / NB;
  const int grid_y = fewest + 1 < L ? fewest + 1 : L;
  int launched = 1;                        // the grouping launch
  for (int e = 0; e < n_plan; ++e) {
    const int lv = plan[3 * e], max_rows = plan[3 * e + 1];
    if (max_rows <= 0) continue;
    const int level_k = plan[3 * e + 2];
    const int G = ell::group_width(level_k);
    const int rows_per_block = kSweepThreads / G;
    const int tiles = (max_rows + rows_per_block - 1) / rows_per_block;
    const dim3 grid(tiles, grid_y);
    if (level_k > 32)
      ell_sweep_fleet_kernel<NB, true><<<grid, kSweepThreads, 0, stream>>>(
          cols, vals, lens, rows, starts, fidx, groups, y, L, R, K, n_starts,
          lv, G, sl, si);
    else
      ell_sweep_fleet_kernel<NB, false><<<grid, kSweepThreads, 0, stream>>>(
          cols, vals, lens, rows, starts, fidx, groups, y, L, R, K, n_starts,
          lv, G, sl, si);
    err = cudaGetLastError();
    if (err != cudaSuccess) return -static_cast<int>(err);
    ++launched;
  }
  return launched;
}

}  // namespace

// Returns a cudaError_t; 0 on a successful launch.  cols/vals: [F, R, K]
// contiguous, lens: [F, R] int32 live slots per row (slots past a row's
// length hold 0.0 and are not read; each length <= K) or null for K,
// fidx: [L] int32 with L <= 1024, x: [L, n], y: [L, R].  gather: -1 stages
// x in shared memory when a pass takes >= 2 lanes and they fit (nb *
// round4(n) * 4 bytes <= 136 KB, nb the lanes a pass takes), 0 gathers
// through L1, 1 stages it (an error when it does not fit).  Gathering through L1 with L > 1 first
// interleaves the lanes of x into xt: ld * n floats, ld = nb for L <= 8,
// else L rounded up to a multiple of 8 (null where no such gather runs).
extern "C" int ell_spmv_fleet_launch(const int* cols, const float* vals,
                                     const int* lens, const int* fidx,
                                     const float* x, float* xt, float* y,
                                     int L, int R, int K, int n, int gather,
                                     void* stream) {
  if (L == 0 || R == 0) return 0;
  if (L < 0 || L > kMaxLanes) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lanes_a_pass(L)) {
    case 8:
      return launch_nb<8>(cols, vals, lens, fidx, x, xt, y, L, R, K, n,
                          gather, s);
    case 4:
      return launch_nb<4>(cols, vals, lens, fidx, x, xt, y, L, R, K, n,
                          gather, s);
    case 2:
      return launch_nb<2>(cols, vals, lens, fidx, x, xt, y, L, R, K, n,
                          gather, s);
    default:
      return launch_nb<1>(cols, vals, lens, fidx, x, xt, y, L, R, K, n,
                          gather, s);
  }
}

// One lane-batched triangular solve, in place on y [L, R] (lane l's row
// i at y[l * sl + i * si]): cols/vals [F, R, K], lens/rows [F, R] int32,
// starts [F, n_starts] int32 (level lv's rows of factor f are
// rows[f, starts[f, lv] .. starts[f, lv + 1])), fidx [L] int32 with
// L <= 1024, groups 5 * L int32 of scratch (16 B aligned), plan a host array
// [n_plan, 3] int32 of (level, row count bound, longest live row) per
// level, in solve order, each bounding every lane's factor.  One launch
// per level with rows, G = group_width(longest live row), after one
// launch that groups the lanes by factor.  Returns the number of
// launches, the grouping launch included (0 when no level has rows), or
// minus the cudaError_t of the first launch that failed.
extern "C" int ell_sweep_fleet_launch(const int* cols, const float* vals,
                                      const int* lens, const int* rows,
                                      const int* starts, const int* fidx,
                                      int* groups, float* y, const int* plan,
                                      int n_plan, int L, int R, int K,
                                      int n_starts, int sl, int si,
                                      void* stream) {
  if (L == 0) return 0;
  if (L < 0 || L > kMaxLanes)
    return -static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lanes_a_pass(L)) {
    case 8:
      return sweep_levels<8>(cols, vals, lens, rows, starts, fidx, groups, y,
                             plan, n_plan, L, R, K, n_starts, sl, si, s);
    case 4:
      return sweep_levels<4>(cols, vals, lens, rows, starts, fidx, groups, y,
                             plan, n_plan, L, R, K, n_starts, sl, si, s);
    case 2:
      return sweep_levels<2>(cols, vals, lens, rows, starts, fidx, groups, y,
                             plan, n_plan, L, R, K, n_starts, sl, si, s);
    default:
      return sweep_levels<1>(cols, vals, lens, rows, starts, fidx, groups, y,
                             plan, n_plan, L, R, K, n_starts, sl, si, s);
  }
}
