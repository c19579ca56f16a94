// The row reduction shared by every ELL SpMV kernel of the port
// (ell_spmv_fleet.cu, ell_spmv.cu, ell_spmv_multi.cu).
//
// A group of G = min(32, pow2(K)) consecutive threads owns one row: thread g
// sums the slots k = g, g+G, g+2G, ... in order, each step one fused
// multiply-add (as XLA:CPU computes the reference's row sums, and as the
// plain versions do), then the group reduces by a fixed xor butterfly of
// plain adds (the build's --fmad=false contracts nothing else).
// The order of the sum depends on K alone, so every kernel that uses these
// two functions gives the same bits for the same row and vector: a single
// vector equals its lane of the fleet kernel and its column of the
// multi-vector kernel.
#pragma once
#include <stdint.h>

namespace ell {

// Width of the thread group that owns one row of a K-slot panel.
__host__ __device__ inline int group_width(int K) {
  int G = 1;
  while (G < K && G < 32) G <<= 1;
  return G;
}

// Thread g's partial sums of one row for NB vectors at once: acc[b] +=
// vals[k] * x[cols[k] * ldx + b] over k = g, g+G, ... < K, for b < nb.
// Each (col, val) pair is read once for all nb vectors.
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
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off, G));
  return acc;
}

}  // namespace ell
