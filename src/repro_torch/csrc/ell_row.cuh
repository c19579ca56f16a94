// The row reduction shared by every ELL SpMV kernel of the port
// (ell_spmv_fleet.cu, ell_spmv.cu, ell_spmv_multi.cu, and the level walk of
// ell_walk.cuh).
//
// A group of G = min(32, pow2(K)) consecutive threads owns one row: thread g
// sums the slots k = g, g+G, g+2G, ... in order, each step one fused
// multiply-add (as XLA:CPU computes the reference's row sums, and as the
// plain versions do), then the group reduces by a fixed xor butterfly of
// plain adds (the build's --fmad=false contracts nothing else).
// The order of the sum depends on K alone, so every kernel that uses these
// functions gives the same bits for the same row and vector: a single
// vector equals its lane of the fleet kernel and its column of the
// multi-vector kernel.
//
// Several vectors at once (the level sweeps: a fleet's lanes, a block's
// columns) keep one accumulator each, summed in that order, and reduce
// them together by group_reduce, a reduce-scatter of the same butterfly
// whose every partial sum is one group_sum forms.
#pragma once
#include <stdint.h>

namespace ell {

constexpr unsigned kFullMask = 0xffffffffu;

// Width of the thread group that owns one row of a K-slot panel.
__host__ __device__ inline int group_width(int K) {
  int G = 1;
  while (G < K && G < 32) G <<= 1;
  return G;
}

// Thread g's partial sums of one row for NB vectors at once: acc[b] +=
// vals[k] * x[cols[k] * ldx + b] over k = g, g+G, ... < K, for b < nb.
// Each (col, val) pair is read once for all nb vectors.  x goes through
// the read-only cache: no kernel that calls this writes x.
template <int NB>
__device__ __forceinline__ void row_partial(const int* __restrict__ cols,
                                            const float* __restrict__ vals,
                                            const float* __restrict__ x,
                                            int64_t ldx, int K, int g, int G,
                                            int nb, float (&acc)[NB]) {
  for (int k = g; k < K; k += G) {
    const float v = vals[k];
    const float* xr = x + static_cast<int64_t>(cols[k]) * ldx;
#pragma unroll
    for (int b = 0; b < NB; ++b)
      if (b < nb) acc[b] = __fmaf_rn(v, __ldg(xr + b), acc[b]);
  }
}

// Sum of acc over the G threads of a group (G a power of two <= 32, groups
// aligned within the warp); every thread of the group gets the sum.
__device__ __forceinline__ float group_sum(float acc, int G) {
  for (int off = G >> 1; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(kFullMask, acc, off, G));
  return acc;
}

// NB consecutive floats at p (16 B aligned for NB >= 4, 8 B for 2): one or
// two 16 B loads, through the read-only cache (LDG) or coherent (a plain
// load, for data the same launch writes).
template <int NB, bool LDG>
__device__ __forceinline__ void load_lanes(float (&xv)[NB], const float* p) {
  if constexpr (NB >= 4) {
#pragma unroll
    for (int h = 0; h < NB / 4; ++h) {
      const float4* q = reinterpret_cast<const float4*>(p) + h;
      const float4 v = LDG ? __ldg(q) : *q;
      xv[4 * h] = v.x; xv[4 * h + 1] = v.y; xv[4 * h + 2] = v.z;
      xv[4 * h + 3] = v.w;
    }
  } else if constexpr (NB == 2) {
    const float2* q = reinterpret_cast<const float2*>(p);
    const float2 v = LDG ? __ldg(q) : *q;
    xv[0] = v.x; xv[1] = v.y;
  } else {
    xv[0] = LDG ? __ldg(p) : *p;
  }
}

// One halving step of the reduce-scatter over N accumulators at xor
// offset off: the thread keeps the upper or lower half (by its off bit),
// sends the other, and adds its own value to its partner's, as group_sum.
template <int N>
__device__ __forceinline__ void halve(float* a, int off, bool upper) {
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    const float send = upper ? a[j] : a[j + N / 2];
    const float keep = upper ? a[j + N / 2] : a[j];
    a[j] = __fadd_rn(keep, __shfl_xor_sync(kFullMask, send, off));
  }
}

// The group's NB accumulators summed over its G threads (G a power of two
// <= 32, groups aligned in the warp): the reduce-scatter's halving steps
// while the group has offsets left for them (min(log2 G, log2 NB) steps),
// then the butterfly's remaining offsets on one value.  Thread g of the
// group ends with the full sums of NB >> steps accumulators in a[0 ..):
// those of held_sums<NB>(g, G), each bitwise ell::group_sum of that
// accumulator.  Why: at each step a thread adds its own value to its
// partner's exactly as group_sum does (own + partner), so every partial
// sum is one that group_sum forms (group_sum leaves identical values in
// both threads of a pair, addition being commutative).
template <int NB>
__device__ __forceinline__ void group_reduce(float (&a)[NB], int lane_id,
                                             int G) {
  int off = G >> 1, held = NB;
  if constexpr (NB >= 8) {
    if (off > 0) { halve<8>(a, off, lane_id & off); off >>= 1; held = 4; }
  }
  if constexpr (NB >= 4) {
    if (off > 0 && held == 4) {
      halve<4>(a, off, lane_id & off); off >>= 1; held = 2;
    }
  }
  if constexpr (NB >= 2) {
    if (off > 0 && held == 2) {
      halve<2>(a, off, lane_id & off); off >>= 1; held = 1;
    }
  }
  for (; off > 0; off >>= 1)
    a[0] = __fadd_rn(a[0], __shfl_xor_sync(kFullMask, a[0], off));
}

// The sums thread g of a G-wide group holds after group_reduce<NB>:
// accumulators first .. first + count, and whether it is their one writer
// (the lowest thread of those that hold them).
struct Held {
  int first, count;
  bool writer;
};

template <int NB>
__device__ __forceinline__ Held held_sums(int g, int G) {
  constexpr int h = NB == 8 ? 3 : NB == 4 ? 2 : NB == 2 ? 1 : 0;
  const int lg = __ffs(G) - 1;
  const int steps = lg < h ? lg : h;
  const int count = NB >> steps;
  return Held{(g >> (lg - steps)) * count, count,
              (g & ((1 << (lg - steps)) - 1)) == 0};
}

// The (col, val) pairs of U slots k, k + G, ... below len (0 past it),
// read together through the read-only cache.
template <int U>
struct SlotBatch {
  float v[U];
  int c[U];

  __device__ __forceinline__ void read(const int* __restrict__ cols,
                                       const float* __restrict__ vals, int k,
                                       int G, int len) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool ok = k + u * G < len;
      v[u] = ok ? __ldg(vals + k + u * G) : 0.0f;
      c[u] = ok ? __ldg(cols + k + u * G) : 0;
    }
  }
};

// Slots a thread reads together in a long row (a batch).
template <int NB>
__host__ __device__ constexpr int batch_slots() {
  return NB >= 4 ? 4 : 8;
}

// One batch of a long row: the gathers of slots k, k + G, ... (their
// (col, val) pairs in s), the next batch's pairs read while they are in
// flight, then before() (work that must precede this batch's sums), then
// the batch's fused multiply-adds in slot order.
template <int NB, int U, class Gather, class Before>
__device__ __forceinline__ void batch_step(float (&acc)[NB],
                                           const int* __restrict__ cols,
                                           const float* __restrict__ vals,
                                           int len, int G, int k,
                                           SlotBatch<U>& s,
                                           const Gather& gather,
                                           const Before& before) {
  float xv[U][NB], vk[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    vk[u] = s.v[u];
    if (k + u * G < len) {
      gather(xv[u], s.c[u]);
    } else {
#pragma unroll
      for (int b = 0; b < NB; ++b) xv[u][b] = 0.0f;
    }
  }
  if (k + U * G < len) s.read(cols, vals, k + U * G, G, len);
  before();
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (k + u * G < len) {
#pragma unroll
      for (int b = 0; b < NB; ++b) acc[b] = __fmaf_rn(vk[u], xv[u][b], acc[b]);
    }
  }
}

// The slots k, k + G, ... below len of a long row, batch by batch, the
// batch from k already in s: software-pipelined, each batch's gathers in
// flight with the next batch's (col, val) reads.
template <int NB, int U, class Gather>
__device__ __forceinline__ void row_sum_from(float (&acc)[NB],
                                             const int* __restrict__ cols,
                                             const float* __restrict__ vals,
                                             int len, int G, int k,
                                             SlotBatch<U>& s,
                                             const Gather& gather) {
  for (; k < len; k += U * G)
    batch_step<NB, U>(acc, cols, vals, len, G, k, s, gather, [] {});
}

// Thread g's partial sums of one row for NB accumulators: its slots g,
// g + G, ... below len in ascending order, one fused multiply-add per slot
// and accumulator, the first slot (v0, c0) already read.  gather(xv, c)
// fills xv with the NB values the accumulators multiply at column c.
// LONG (a level whose longest row exceeds 32 slots, so G = 32 and a thread
// may hold several): the rest go in batches of U slots, the batch's
// (col, val) pairs read together and its gathers issued with the next
// batch's reads, then its multiply-adds in slot order, so a long row costs
// about one round trip to memory a batch, not two a slot (the sums are
// the same).  Otherwise each thread holds one slot at most.
template <int NB, bool LONG, class Gather>
__device__ __forceinline__ void row_sum(float (&acc)[NB],
                                        const int* __restrict__ cols,
                                        const float* __restrict__ vals,
                                        int len, int g, int G, float v0,
                                        int c0, const Gather& gather) {
  constexpr int U = batch_slots<NB>();
  if (g < len) {
    float xv[NB];
    gather(xv, c0);
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[b] = __fmaf_rn(v0, xv[b], acc[b]);
  }
  if constexpr (!LONG) return;
  SlotBatch<U> s;
  const int k = g + G;
  if (k < len) s.read(cols, vals, k, G, len);
  row_sum_from<NB, U>(acc, cols, vals, len, G, k, s, gather);
}

// row_sum with the first slot (v0, c0) and the first batch s of U slots
// (g + G, ...) read beforehand, for a caller that reads them before it
// may gather: the first slot's gather is issued with the first batch's and
// the second batch's reads, so the row costs one round trip once it may
// gather, for rows of up to (1 + U) G slots.  The same sums, in the same
// order.
template <int NB, int U, class Gather>
__device__ __forceinline__ void row_sum_read(
    float (&acc)[NB], const int* __restrict__ cols,
    const float* __restrict__ vals, int len, int g, int G, float v0, int c0,
    SlotBatch<U>& s, const Gather& gather) {
  if (g >= len) return;
  float x0[NB];
  gather(x0, c0);
  auto first = [&] {
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[b] = __fmaf_rn(v0, x0[b], acc[b]);
  };
  const int k = g + G;
  if (k >= len) {
    first();
    return;
  }
  batch_step<NB, U>(acc, cols, vals, len, G, k, s, gather, first);
  row_sum_from<NB, U>(acc, cols, vals, len, G, k + U * G, s, gather);
}

}  // namespace ell
