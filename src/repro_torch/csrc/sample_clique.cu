// Batched vertex elimination (paper Algorithm 4, lines 14-23) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/sample_clique.py
// (sample_clique_pallas / _kernel).  Computes, for every row (one vertex's
// padded incident multi-edge list, width W a power of two), exactly what
// repro_torch.core.column_math.eliminate_column computes, bit for bit:
//
//   1. sort lanes by (id, w, lane); merge runs of equal id (Hillis-Steele
//      prefix sums of w, run sum = cs[run end] - cs[start - 1]);
//      l_kk = cs[nvalid - 1]; compact the merged entries to the front;
//      g_vals = -w / l_kk (IEEE division);
//   2. sort lanes by (w, id, lane) with invalid lanes keyed -inf, so the
//      valid run is right-aligned; suffix sums S by a Hillis-Steele scan
//      from the right; S1[p] = S[p+1];
//   3. for each position p of the valid run but the last, thresh =
//      fma(-u, S1, S1) (one rounding, as XLA:CPU contracts the reference's
//      S1 - u*S1); the partner is found by the same fixed-trip binary search
//      as jnp.searchsorted(method="scan", side="right") on reversed S1, and
//      the spanning-tree edge (sid[p], sid[j]) gets weight S1*sval/l_kk.
//
// Layout: one CTA per row; T = min(W, 1024) threads, LPT = W/T lanes per
// thread (lane i = tid + l*T, so shared-memory accesses are coalesced).
// The whole row lives in dynamic shared memory: three W-wide arrays
// (int key, float key, int payload) = 12*W bytes, 192 KiB at W = 16384,
// the widest row this kernel takes.  Sorts are shared-memory bitonic
// networks with the lane index as the final key (a strict total order);
// the partner search and the run-end search are binary searches on the
// sorted row in place of the TPU kernel's one-hot matmuls and W x W count
// matrix.
//
// What bounds it on an H100: the row's bytes are read and written once
// (33 bytes a lane), but the work per row is O(W log^2 W) shared-memory
// compare-exchanges behind a __syncthreads() each, so at the engine's
// shapes (256 rows of 256 lanes per round) the kernel is bound by
// barrier latency inside a CTA, not by HBM bandwidth.  Simple and right
// first; a warp-per-row variant for small W is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false -shared
// (--fmad=false: no multiply-add is contracted except the explicit
// __fmaf_rn below).
#include <cuda_runtime.h>
#include <stdint.h>

#define INVALID_ID 2147483647

namespace {

// ascending-order "less" for stage 1: (id, w, lane)
__device__ __forceinline__ bool less_idw(int ia, float wa, int la,
                                         int ib, float wb, int lb) {
  if (ia != ib) return ia < ib;
  if (wa != wb) return wa < wb;
  return la < lb;
}

// ascending-order "less" for stage 2: (w, id, lane)
__device__ __forceinline__ bool less_wid(int ia, float wa, int la,
                                         int ib, float wb, int lb) {
  if (wa != wb) return wa < wb;
  if (ia != ib) return ia < ib;
  return la < lb;
}

// In-place ascending bitonic sort of (ik, fk, lane) over W lanes.
template <bool BY_ID_FIRST>
__device__ void bitonic(int* ik, float* fk, int* lane, int W, int T) {
  const int half = W >> 1;
  for (int k = 2; k <= W; k <<= 1) {
    for (int j = k >> 1; j >= 1; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += T) {
        const int i = 2 * t - (t & (j - 1));
        const int p = i + j;
        const bool up = (i & k) == 0;
        const int ia = ik[i], ib = ik[p];
        const float wa = fk[i], wb = fk[p];
        const int la = lane[i], lb = lane[p];
        const bool b_less = BY_ID_FIRST ? less_idw(ib, wb, lb, ia, wa, la)
                                        : less_wid(ib, wb, lb, ia, wa, la);
        if (b_less == up) {
          ik[i] = ib; ik[p] = ia;
          fk[i] = wb; fk[p] = wa;
          lane[i] = lb; lane[p] = la;
        }
      }
      __syncthreads();
    }
  }
}

// In-place inclusive Hillis-Steele scan: x[i] += x[i-k] for k = 1, 2, 4...
// (x[i] + 0 for i < k), the bracketing of column_math.hs_cumsum.
template <int LPT, typename V>
__device__ void hs_scan(V* x, int W, int T) {
  for (int k = 1; k < W; k <<= 1) {
    V v[LPT];
#pragma unroll
    for (int l = 0; l < LPT; ++l) {
      const int i = threadIdx.x + l * T;
      v[l] = (i >= k) ? x[i - k] : V(0);
    }
    __syncthreads();
#pragma unroll
    for (int l = 0; l < LPT; ++l) {
      const int i = threadIdx.x + l * T;
      x[i] = x[i] + v[l];
    }
    __syncthreads();
  }
}

template <int LPT>
__global__ void __launch_bounds__(1024) sample_clique_kernel(
    const int* __restrict__ ids_g, const float* __restrict__ ws_g,
    const int* __restrict__ fill_g, const float* __restrict__ u_g,
    int* __restrict__ g_rows_o, float* __restrict__ g_vals_o,
    int* __restrict__ m_o, float* __restrict__ ell_o,
    int* __restrict__ e_lo_o, int* __restrict__ e_hi_o,
    float* __restrict__ e_w_o, unsigned char* __restrict__ e_valid_o,
    int W) {
  extern __shared__ unsigned char smem[];
  int* ik = reinterpret_cast<int*>(smem);
  float* fk = reinterpret_cast<float*>(ik + W);
  int* aux = reinterpret_cast<int*>(fk + W);
  __shared__ int s_nvalid, s_m;

  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * W;
  const int fill = fill_g[blockIdx.x];
  if (tid == 0) { s_nvalid = 0; s_m = 0; }

  // ---- load: invalid lanes become (INVALID, 0) ------------------------
#pragma unroll
  for (int l = 0; l < LPT; ++l) {
    const int i = tid + l * T;
    const bool valid = i < fill;
    ik[i] = valid ? ids_g[base + i] : INVALID_ID;
    fk[i] = valid ? ws_g[base + i] : 0.0f;
    aux[i] = i;
  }
  __syncthreads();

  // ---- stage 1: sort by (id, w), merge runs ---------------------------
  bitonic<true>(ik, fk, aux, W, T);
  {
    int cnt = 0;
#pragma unroll
    for (int l = 0; l < LPT; ++l) cnt += ik[tid + l * T] != INVALID_ID;
    if (cnt) atomicAdd(&s_nvalid, cnt);
  }
  hs_scan<LPT, float>(fk, W, T);            // fk = cs (prefix sums of w)
  const int nvalid = s_nvalid;
  const float ell = nvalid > 0 ? fk[nvalid - 1] : 0.0f;
  const float safe_ell = ell > 0.0f ? ell : 1.0f;

  int start_id[LPT];
  float run_sum[LPT];
  bool is_start[LPT];
#pragma unroll
  for (int l = 0; l < LPT; ++l) {
    const int i = tid + l * T;
    const int id = ik[i];
    is_start[l] = id != INVALID_ID && (i == 0 || ik[i - 1] != id);
    start_id[l] = id;
    run_sum[l] = 0.0f;
    if (is_start[l]) {
      // run end = last lane holding this id (upper bound - 1)
      int lo = i, hi = nvalid;               // ik[lo] == id, answer in [lo, hi)
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (ik[mid] == id) lo = mid; else hi = mid;
      }
      const float prev = i > 0 ? fk[i - 1] : 0.0f;
      run_sum[l] = fk[lo] - prev;
    }
  }
  __syncthreads();
  // rank of each start among starts (exclusive count, integer scan)
#pragma unroll
  for (int l = 0; l < LPT; ++l) aux[tid + l * T] = is_start[l] ? 1 : 0;
  __syncthreads();
  hs_scan<LPT, int>(aux, W, T);
  int rank[LPT];
#pragma unroll
  for (int l = 0; l < LPT; ++l) rank[l] = aux[tid + l * T] - 1;
  if (tid == T - 1) s_m = aux[W - 1];
  __syncthreads();
  const int m = s_m;
  // compact: g_rows[rank] = id, g_w[rank] = run sum; the rest invalid
#pragma unroll
  for (int l = 0; l < LPT; ++l) {
    const int i = tid + l * T;
    ik[i] = INVALID_ID;
    fk[i] = 0.0f;
  }
  __syncthreads();
#pragma unroll
  for (int l = 0; l < LPT; ++l) {
    if (is_start[l]) {
      ik[rank[l]] = start_id[l];
      fk[rank[l]] = run_sum[l];
    }
  }
  __syncthreads();
#pragma unroll
  for (int l = 0; l < LPT; ++l) {
    const int i = tid + l * T;
    const int gr = ik[i];
    const float gw = fk[i];
    g_rows_o[base + i] = gr;
    g_vals_o[base + i] = gr != INVALID_ID ? __fdiv_rn(-gw, safe_ell) : 0.0f;
    // stage-2 keys: invalid lanes sort to the front
    if (gr == INVALID_ID) fk[i] = __int_as_float(0xff800000);  // -inf
    aux[i] = i;
  }
  if (tid == 0) { m_o[blockIdx.x] = m; ell_o[blockIdx.x] = ell; }
  __syncthreads();

  // ---- stage 2: sort by (w, id), suffix sums --------------------------
  bitonic<false>(ik, fk, aux, W, T);
  int sid[LPT];
  float sval[LPT];
#pragma unroll
  for (int l = 0; l < LPT; ++l) {
    const int i = tid + l * T;
    sid[l] = ik[i];
    sval[l] = sid[l] != INVALID_ID ? fk[i] : 0.0f;
  }
  __syncthreads();
  // reversed layout: fk[W-1-p] = sval[p]; prefix scan = suffix sums
#pragma unroll
  for (int l = 0; l < LPT; ++l) fk[W - 1 - (tid + l * T)] = sval[l];
  __syncthreads();
  hs_scan<LPT, float>(fk, W, T);
  // now fk[t] = S[W-1-t]; S1[p] = S[p+1] = fk[W-2-p] (0 for p = W-1);
  // the searched array rev[t] = S1[W-1-t] = fk[t-1] (0 for t = 0)

  // ---- stage 3: inverse-CDF spanning-tree sampling --------------------
  const int first = W - m;
  int levels = 0;
  while ((1 << levels) < W + 1) ++levels;    // ceil(log2(W + 1))
  const int64_t ubase = base;
#pragma unroll
  for (int l = 0; l < LPT; ++l) {
    const int p = tid + l * T;
    const float s1 = p < W - 1 ? fk[W - 2 - p] : 0.0f;
    int il = p - first;
    il = il < 0 ? 0 : (il > W - 1 ? W - 1 : il);
    const float up = u_g[ubase + il];
    const float thresh = __fmaf_rn(-up, s1, s1);
    int low = 0, high = W;
    for (int s = 0; s < levels; ++s) {
      const int mid = (low + high) >> 1;
      const float rv = mid > 0 ? fk[mid - 1] : 0.0f;
      if (thresh < rv) high = mid; else low = mid;
    }
    int j = p + 1 > W - high ? p + 1 : W - high;
    j = j < W - 1 ? j : W - 1;
    const bool ev = p >= first && p < W - 1 && m >= 2;
    const int a = sid[l];
    const int b = ik[j];
    e_lo_o[ubase + p] = ev ? (a < b ? a : b) : INVALID_ID;
    e_hi_o[ubase + p] = ev ? (a < b ? b : a) : INVALID_ID;
    e_w_o[ubase + p] = ev ? __fdiv_rn(__fmul_rn(s1, sval[l]), safe_ell) : 0.0f;
    e_valid_o[ubase + p] = ev ? 1 : 0;
  }
}

template <int LPT>
int launch(const int* ids, const float* ws, const int* fill, const float* u,
           int* g_rows, float* g_vals, int* m, float* ell, int* e_lo,
           int* e_hi, float* e_w, unsigned char* e_valid, int R, int W,
           cudaStream_t stream) {
  const int T = W / LPT;
  const size_t smem = static_cast<size_t>(12) * W;
  if (LPT > 1) {
    // rows of 4096 lanes and more need the opt-in shared-memory carve-out:
    // dynamic + the kernel's static shared memory passes the default 48 KiB
    // (the total must stay <= 227 KiB)
    cudaError_t e = cudaFuncSetAttribute(
        sample_clique_kernel<LPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  sample_clique_kernel<LPT><<<R, T, smem, stream>>>(
      ids, ws, fill, u, g_rows, g_vals, m, ell, e_lo, e_hi, e_w, e_valid, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t; 0 on a successful launch.  W must be a power of
// two in [2, 16384]; the wrapper checks shapes, types and contiguity.
extern "C" int sample_clique_launch(
    const int* ids, const float* ws, const int* fill, const float* u,
    int* g_rows, float* g_vals, int* m, float* ell, int* e_lo, int* e_hi,
    float* e_w, unsigned char* e_valid, int R, int W, void* stream) {
  if (R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W <= 1024)
    return launch<1>(ids, ws, fill, u, g_rows, g_vals, m, ell, e_lo, e_hi,
                     e_w, e_valid, R, W, s);
  if (W == 2048)
    return launch<2>(ids, ws, fill, u, g_rows, g_vals, m, ell, e_lo, e_hi,
                     e_w, e_valid, R, W, s);
  if (W == 4096)
    return launch<4>(ids, ws, fill, u, g_rows, g_vals, m, ell, e_lo, e_hi,
                     e_w, e_valid, R, W, s);
  if (W == 8192)
    return launch<8>(ids, ws, fill, u, g_rows, g_vals, m, ell, e_lo, e_hi,
                     e_w, e_valid, R, W, s);
  if (W == 16384)
    return launch<16>(ids, ws, fill, u, g_rows, g_vals, m, ell, e_lo, e_hi,
                      e_w, e_valid, R, W, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
