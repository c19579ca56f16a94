// Batched vertex elimination (paper Algorithm 4, lines 14-23) for Hopper:
// the standalone row kernel and the engine's fused elimination round.
//
// Replaces the TPU kernel src/repro/kernels/sample_clique.py
// (sample_clique_pallas / _kernel).  Computes, for every row (one vertex's
// padded incident multi-edge list, reference width W a power of two),
// exactly what repro_torch.core.column_math.eliminate_column computes at
// width W, bit for bit:
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
// Two entry points share the device code:
//   sample_clique_launch        rows [R, W] in, eight outputs [R, W] / [R]
//                               out (the padded lanes written as at width W);
//   sample_clique_round_launch  one engine round: for each candidate (b, c)
//                               it gathers the column's slab and uniforms
//                               from the engine state, eliminates it and
//                               commits in place (factor column into the
//                               slab's first m slots, col_fill = m, D = l_kk,
//                               elim = 1, dep[id] -= 1 per consumed
//                               multi-edge by integer atomics, which are
//                               order-free), and writes the sampled edges
//                               [B*chunk, W] as the scatter stage reads them.
//
// Each row is eliminated at its own width w = max(next_pow2(fill), 2), not
// at W.  Why that gives the W-wide bits:
//
//   * Sorts: valid lanes (id < INVALID_ID) sort before the W - fill padded
//     lanes, which are all (INVALID_ID, 0); with the lane as the last key
//     the order is a strict total order, so the first w lanes of the W-wide
//     sort are the w-wide sort.  In stage 2 the m valid entries come last
//     in both, at positions p and p + (W - w).
//   * Scans: a Hillis-Steele prefix at position i < w sums lanes <= i with
//     a bracketing that depends on i alone; the W-wide scan's extra steps
//     (k >= w) add +0 to every lane i < w.  x + 0 changes only -0 into +0,
//     and twice is once, so the W-wide value is the w-wide one + 0, which
//     the kernel adds when w < W.
//   * Search: reversed S1 is rev[t] = x[t - 1] (x the scan of the reversed
//     values, 0 at t = 0).  At W the first L = log2(W / w) probes of the
//     fixed-trip search all land on multiples of w, where x[c*w - 1] is an
//     HS scan over whole blocks of w lanes: block 0 sums to the w-wide
//     total x_w[w-1], every later block is all +0, so x[c*w - 1] =
//     x_w[w-1] + 0 =: T for every c >= 1.  Those L probes therefore all
//     compare thresh < T: if true they all go left, leaving [0, w) with
//     log2(w) + 1 = ceil(log2(w + 1)) probes, which is the w-wide search
//     probe for probe; if false they all go right, high ends above W - w,
//     and j = max(p + 1, W - high) = p + 1 for every valid p >= W - m.
//     The kernel searches at w and takes j = p + 1 when w < W and
//     !(thresh < T).  (T is the total of the suffix sums, and thresh <=
//     S1[p] is a sum of fewer positive weights, so the second case needs
//     u = 0 and an unlucky rounding; it is handled all the same.)
//   * u: the slot read is p - (W - m) = p_w - (w - m), the same entry; only
//     the first m - 1 slots are read.
//
// Layout: one CTA per row.  A row with w <= 32 (almost all of them) runs in
// warp 0 alone: one lane per element, keys and payloads in registers, both
// bitonic sorts and the scans by __shfl_xor_sync / __shfl_up_sync with the
// scans bracketed as column_math.hs_cumsum, run ends and ranks by
// __ballot_sync, the compaction through 256 bytes of shared memory, and no
// __syncthreads().  A wider row runs on min(w, blockDim) threads of the CTA
// (the rest exit), in dynamic shared memory (three w-wide arrays: int key,
// float key, int payload) with a named barrier over those threads only;
// sorts are shared-memory bitonic networks with the lane index as the last
// key, run-end and partner searches are binary searches on the sorted row
// in place of the TPU kernel's one-hot matmuls.  The wide path holds at
// most one LPT-long register array across a barrier (LPT = lanes per
// thread, W / 1024 for W > 1024; two, in the paired scans, for LPT <= 4),
// so no variant spills.
//
// What bounds it on an H100: a row's bytes are read and written once (a
// few hundred bytes for a typical row), so a round is bound by latency: a
// warp row is a chain of dependent global loads and ~log^2(w) shuffles, a
// wide row ~log^2(w) barriers of its threads.  The kernel's time is set by
// the round's widest row.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false -shared
// (--fmad=false: no multiply-add is contracted except the explicit
// __fmaf_rn below).
#include <cuda_runtime.h>
#include <stdint.h>

#define INVALID_ID 2147483647

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

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

// w = max(next_pow2(fill), 2) for 0 <= fill <= W
__device__ __forceinline__ int row_width(int fill) {
  return fill <= 2 ? 2 : 1 << (32 - __clz(fill - 1));
}

__device__ __forceinline__ int ilog2(int x) { return 31 - __clz(x); }

// One row, wherever its inputs come from and its outputs go.
struct Row {
  const int* ids;         // the row's lanes; lanes < fill are valid
  const float* ws;
  const float* u;         // u[s]: uniform of sampling slot s
  int fill;               // valid lanes, <= W
  int W;                  // reference width
  int* g_rows;            // standalone: W lanes; fused: the slab
  float* g_vals;
  int* m_out;             // standalone: m[r]; fused: col_fill[b, cand]
  float* ell_out;         // standalone: ell[r]; fused: D[b, cand]
  unsigned char* elim;    // fused: elim[b, cand]
  int* dep;               // fused: dep[b, :]
  int* e_lo;              // W lanes, both entry points
  int* e_hi;
  float* e_w;
  unsigned char* e_valid;
  bool fused;             // commit into the engine state
  bool commit;            // fused and the candidate is real
};

// ---- outputs shared by both paths -----------------------------------------

// lane i < w of the compacted factor column (gr, gv)
__device__ __forceinline__ void put_g(const Row& r, int i, int m, int gr,
                                      float gv) {
  if (!r.fused) {
    r.g_rows[i] = gr;
    r.g_vals[i] = gv;
  } else if (r.commit && i < m) {
    r.g_rows[i] = gr;
    r.g_vals[i] = gv;
  }
}

// lanes [w, W) of a standalone row's factor column and lanes [0, W - w) of
// every row's edges: the padded lanes, as the W-wide kernel writes them
__device__ __forceinline__ void put_padding(const Row& r, int w, int t0,
                                            int stride) {
  const int W = r.W;
  if (!r.fused)
    for (int t = w + t0; t < W; t += stride) {
      r.g_rows[t] = INVALID_ID;
      r.g_vals[t] = 0.0f;
    }
  for (int t = t0; t < W - w; t += stride) {
    r.e_lo[t] = INVALID_ID;
    r.e_hi[t] = INVALID_ID;
    r.e_w[t] = 0.0f;
    r.e_valid[t] = 0;
  }
}

__device__ __forceinline__ void put_scalars(const Row& r, int m, float ell) {
  if (!r.fused) {
    *r.m_out = m;
    *r.ell_out = ell;
  } else if (r.commit) {
    *r.m_out = m;
    *r.ell_out = ell;
    *r.elim = 1;
  }
}

// edge of position p_w < w (W-wide position p_w + W - w)
__device__ __forceinline__ void put_edge(const Row& r, int w, int p, bool ev,
                                         int a, int b, float ew) {
  const int t = r.W - w + p;
  r.e_lo[t] = ev ? (a < b ? a : b) : INVALID_ID;
  r.e_hi[t] = ev ? (a < b ? b : a) : INVALID_ID;
  r.e_w[t] = ev ? ew : 0.0f;
  r.e_valid[t] = ev ? 1 : 0;
}

// ---- warp path: w <= 32, warp 0, one lane per element ---------------------

template <bool BY_ID_FIRST>
__device__ __forceinline__ void warp_bitonic(int& ik, float& fk, int& ln,
                                             int w, int i) {
  for (int k = 2; k <= w; k <<= 1) {
    for (int j = k >> 1; j >= 1; j >>= 1) {
      const int io = __shfl_xor_sync(FULL, ik, j);
      const float fo = __shfl_xor_sync(FULL, fk, j);
      const int lo = __shfl_xor_sync(FULL, ln, j);
      const bool other_less = BY_ID_FIRST ? less_idw(io, fo, lo, ik, fk, ln)
                                          : less_wid(io, fo, lo, ik, fk, ln);
      // the lower lane of a pair keeps the smaller element in an ascending
      // block ((i & k) == 0), the larger in a descending one
      const bool keep_min = ((i & j) == 0) == ((i & k) == 0);
      if (keep_min ? other_less : !other_less) {
        ik = io;
        fk = fo;
        ln = lo;
      }
    }
  }
}

// inclusive Hillis-Steele scan over lanes < w: x[i] + x[i-k] (x[i] + 0 for
// i < k), then + 0 for the W-wide scan's extra steps
__device__ __forceinline__ float warp_scan(float x, int w, int i, bool pad) {
  for (int k = 1; k < w; k <<= 1) {
    const float v = __shfl_up_sync(FULL, x, k);
    x = x + (i >= k ? v : 0.0f);
  }
  return pad ? x + 0.0f : x;
}

__device__ void warp_row(const Row& r, int w) {
  __shared__ int sh_id[32];
  __shared__ float sh_w[32];
  const int i = threadIdx.x;             // lane
  const bool act = i < w;
  const bool pad = w < r.W;
  const bool valid_in = i < r.fill;

  // ---- load: invalid lanes become (INVALID, 0) ------------------------
  int id = valid_in ? r.ids[i] : INVALID_ID;
  float wt = valid_in ? r.ws[i] : 0.0f;
  if (r.commit && valid_in) atomicSub(r.dep + id, 1);
  int ln = i;

  // ---- stage 1: sort by (id, w), merge runs ---------------------------
  warp_bitonic<true>(id, wt, ln, w, i);
  const bool real = act && id != INVALID_ID;
  const int nvalid = __popc(__ballot_sync(FULL, real));
  const float cs = warp_scan(wt, w, i, pad);
  const float cs_last = __shfl_sync(FULL, cs, nvalid > 0 ? nvalid - 1 : 0);
  const float ell = nvalid > 0 ? cs_last : 0.0f;
  const float safe_ell = ell > 0.0f ? ell : 1.0f;
  const int prev_id = __shfl_up_sync(FULL, id, 1);
  const int next_id = __shfl_down_sync(FULL, id, 1);
  const bool is_start = real && (i == 0 || prev_id != id);
  const bool is_end = real && (i == w - 1 || next_id != id);
  const unsigned starts = __ballot_sync(FULL, is_start);
  const unsigned ends = __ballot_sync(FULL, is_end);
  const int m = __popc(starts);
  // a run ends at the first run end at or after its start
  const unsigned ends_from = ends & (FULL << i);
  const int run_end = ends_from ? __ffs(ends_from) - 1 : i;
  const float cs_end = __shfl_sync(FULL, cs, run_end);
  const float cs_prev = __shfl_up_sync(FULL, cs, 1);
  if (is_start) {
    const int rank = __popc(starts & ((1u << i) - 1u));
    sh_id[rank] = id;
    sh_w[rank] = cs_end - (i > 0 ? cs_prev : 0.0f);
  }
  __syncwarp();
  const int gr = i < m ? sh_id[i] : INVALID_ID;
  const float gw = i < m ? sh_w[i] : 0.0f;
  const float gv = gr != INVALID_ID ? __fdiv_rn(-gw, safe_ell) : 0.0f;
  if (act) put_g(r, i, m, gr, gv);
  if (i == 0) put_scalars(r, m, ell);

  // ---- stage 2: sort by (w, id), suffix sums --------------------------
  int sid = gr;
  float key = gr != INVALID_ID ? gw : neg_inf();
  int ln2 = i;
  warp_bitonic<false>(sid, key, ln2, w, i);
  const float sval = sid != INVALID_ID ? key : 0.0f;
  // lane t of the reversed row holds sval[w-1-t]; its prefix scan x gives
  // S[p] = x[w-1-p]
  const float rv = __shfl_sync(FULL, sval, (w - 1 - i) & 31);
  const float x = warp_scan(rv, w, i, pad);
  const float total = __shfl_sync(FULL, x, w - 1);

  // ---- stage 3: inverse-CDF spanning-tree sampling --------------------
  const float s1v = __shfl_sync(FULL, x, (w - 2 - i) & 31);
  const float s1 = i < w - 1 ? s1v : 0.0f;
  const int first = w - m;
  const bool ev = act && i >= first && i < w - 1 && m >= 2;
  const float thresh = ev ? __fmaf_rn(-r.u[i - first], s1, s1) : 0.0f;
  int low = 0, high = w;
  const int levels = ilog2(w) + 1;        // ceil(log2(w + 1))
  for (int s = 0; s < levels; ++s) {
    const int mid = (low + high) >> 1;
    const float probe = __shfl_sync(FULL, x, (mid - 1) & 31);
    const float rvm = mid > 0 ? probe : 0.0f;
    if (thresh < rvm) high = mid; else low = mid;
  }
  int j = i + 1 > w - high ? i + 1 : w - high;
  if (pad && !(thresh < total)) j = i + 1;   // the W-wide search went right
  j = j < w - 1 ? j : w - 1;
  const int b = __shfl_sync(FULL, sid, j & 31);
  if (act)
    put_edge(r, w, i, ev, sid, b,
             __fdiv_rn(__fmul_rn(s1, sval), safe_ell));
  put_padding(r, w, i, 32);
}

// ---- CTA path: w > 32, Ta = min(w, blockDim) threads, lpt = w / Ta --------

__device__ __forceinline__ void bar(int nthreads) {
  asm volatile("bar.sync 1, %0;" ::"r"(nthreads) : "memory");
}

template <bool BY_ID_FIRST>
__device__ void cta_bitonic(int* ik, float* fk, int* lane, int w, int Ta) {
  const int half = w >> 1;
  for (int k = 2; k <= w; k <<= 1) {
    for (int j = k >> 1; j >= 1; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += Ta) {
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
      bar(Ta);
    }
  }
}

// In-place inclusive Hillis-Steele scans over w lanes, x[i] += x[i-k] for
// k = 1, 2, 4, ... (x[i] + 0 for i < k), the bracketing of
// column_math.hs_cumsum; c (when given) is scanned alongside with the same
// barriers.  With pad the last step adds + 0 (the W-wide scan's extra
// steps).  Ends with a barrier.
template <int LPT, typename V>
__device__ void cta_scan_one(V* x, int w, int Ta, bool pad) {
  const int lpt = w / Ta;
  for (int k = 1; k < w; k <<= 1) {
    V v[LPT];
#pragma unroll
    for (int l = 0; l < LPT; ++l) {
      if (l < lpt) {
        const int i = threadIdx.x + l * Ta;
        v[l] = i >= k ? x[i - k] : V(0);
      }
    }
    bar(Ta);
    const bool last = 2 * k >= w;
#pragma unroll
    for (int l = 0; l < LPT; ++l) {
      if (l < lpt) {
        const int i = threadIdx.x + l * Ta;
        V y = x[i] + v[l];
        if (pad && last) y = y + V(0);
        x[i] = y;
      }
    }
    bar(Ta);
  }
}

// In-place inclusive Hillis-Steele scans over w lanes, x[i] += x[i-k] for
// k = 1, 2, 4, ... (x[i] + 0 for i < k), the bracketing of
// column_math.hs_cumsum; c (when given) is scanned alongside, with the
// same barriers while LPT is small.  With pad the last step adds + 0 (the
// W-wide scan's extra steps).  Ends with a barrier.
template <int LPT>
__device__ void cta_scan(float* x, int* c, int w, int Ta, bool pad) {
  if (LPT > 4) {                 // two LPT-long arrays would spill
    cta_scan_one<LPT, float>(x, w, Ta, pad);
    if (c) cta_scan_one<LPT, int>(c, w, Ta, false);
    return;
  }
  const int lpt = w / Ta;
  for (int k = 1; k < w; k <<= 1) {
    float v[LPT];
    int vc[LPT];
#pragma unroll
    for (int l = 0; l < LPT; ++l) {
      if (l < lpt) {
        const int i = threadIdx.x + l * Ta;
        v[l] = i >= k ? x[i - k] : 0.0f;
        if (c) vc[l] = i >= k ? c[i - k] : 0;
      }
    }
    bar(Ta);
    const bool last = 2 * k >= w;
#pragma unroll
    for (int l = 0; l < LPT; ++l) {
      if (l < lpt) {
        const int i = threadIdx.x + l * Ta;
        float y = x[i] + v[l];
        if (pad && last) y = y + 0.0f;
        x[i] = y;
        if (c) c[i] = c[i] + vc[l];
      }
    }
    bar(Ta);
  }
}

template <int LPT>
__device__ void cta_row(const Row& r, int w, int Ta, int* ik, float* fk,
                        int* aux) {
  __shared__ int s_nvalid;
  const int tid = threadIdx.x;
  const int lpt = w / Ta;
  const bool pad = w < r.W;

  // ---- load: invalid lanes become (INVALID, 0) ------------------------
#pragma unroll 1
  for (int l = 0; l < LPT; ++l) {
    if (l < lpt) {
      const int i = tid + l * Ta;
      const bool valid = i < r.fill;
      const int id = valid ? r.ids[i] : INVALID_ID;
      ik[i] = id;
      fk[i] = valid ? r.ws[i] : 0.0f;
      aux[i] = i;
      if (r.commit && valid) atomicSub(r.dep + id, 1);
    }
  }
  if (tid == 0) s_nvalid = 0;
  bar(Ta);

  // ---- stage 1: sort by (id, w), merge runs ---------------------------
  cta_bitonic<true>(ik, fk, aux, w, Ta);
  // the payload is dead: aux becomes the run-start flags
#pragma unroll 1
  for (int l = 0; l < LPT; ++l) {
    if (l < lpt) {
      const int i = tid + l * Ta;
      const int id = ik[i];
      const bool real = id != INVALID_ID;
      if (real && (i == w - 1 || ik[i + 1] == INVALID_ID)) s_nvalid = i + 1;
      aux[i] = real && (i == 0 || ik[i - 1] != id) ? 1 : 0;
    }
  }
  bar(Ta);
  cta_scan<LPT>(fk, aux, w, Ta, pad);      // fk = cs; aux = starts so far
  const int nvalid = s_nvalid;
  const int m = aux[w - 1];
  const float ell = nvalid > 0 ? fk[nvalid - 1] : 0.0f;
  const float safe_ell = ell > 0.0f ? ell : 1.0f;

  // run sums of the start lanes: held in registers across one barrier,
  // then written compacted into fk (only fk is written: ik and aux still
  // tell the starts and their ranks)
  float run_sum[LPT];
#pragma unroll
  for (int l = 0; l < LPT; ++l) {
    run_sum[l] = 0.0f;
    if (l < lpt) {
      const int i = tid + l * Ta;
      const int id = ik[i];
      if (id != INVALID_ID && (i == 0 || ik[i - 1] != id)) {
        // run end = last lane holding this id (upper bound - 1)
        int lo = i, hi = nvalid;        // ik[lo] == id, answer in [lo, hi)
        while (hi - lo > 1) {
          const int mid = (lo + hi) >> 1;
          if (ik[mid] == id) lo = mid; else hi = mid;
        }
        run_sum[l] = fk[lo] - (i > 0 ? fk[i - 1] : 0.0f);
      }
    }
  }
  bar(Ta);
#pragma unroll
  for (int l = 0; l < LPT; ++l) {
    if (l < lpt) {
      const int i = tid + l * Ta;
      const int id = ik[i];
      if (id != INVALID_ID && (i == 0 || ik[i - 1] != id))
        fk[aux[i] - 1] = run_sum[l];
      if (i >= m) fk[i] = neg_inf();        // stage-2 key of invalid lanes
    }
  }
  // then the start ids, the same way into ik; aux (read only at the
  // thread's own lanes now) becomes the stage-2 payload
  int start_id[LPT];
#pragma unroll
  for (int l = 0; l < LPT; ++l) {
    start_id[l] = INVALID_ID;
    if (l < lpt) {
      const int i = tid + l * Ta;
      const int id = ik[i];
      if (id != INVALID_ID && (i == 0 || ik[i - 1] != id)) start_id[l] = id;
    }
  }
  bar(Ta);
#pragma unroll
  for (int l = 0; l < LPT; ++l) {
    if (l < lpt) {
      const int i = tid + l * Ta;
      if (start_id[l] != INVALID_ID) ik[aux[i] - 1] = start_id[l];
      if (i >= m) ik[i] = INVALID_ID;
      aux[i] = i;
    }
  }
  bar(Ta);
#pragma unroll 1
  for (int l = 0; l < LPT; ++l) {
    if (l < lpt) {
      const int i = tid + l * Ta;
      const int gr = ik[i];
      put_g(r, i, m, gr, gr != INVALID_ID ? __fdiv_rn(-fk[i], safe_ell)
                                          : 0.0f);
    }
  }
  if (tid == 0) put_scalars(r, m, ell);
  bar(Ta);

  // ---- stage 2: sort by (w, id), suffix sums --------------------------
  cta_bitonic<false>(ik, fk, aux, w, Ta);
  // the payload is dead: aux keeps sval's bits, ik keeps sid
#pragma unroll 1
  for (int l = 0; l < LPT; ++l) {
    if (l < lpt) {
      const int i = tid + l * Ta;
      aux[i] = __float_as_int(ik[i] != INVALID_ID ? fk[i] : 0.0f);
    }
  }
  bar(Ta);
  // reversed layout: fk[w-1-p] = sval[p]; prefix scan = suffix sums
#pragma unroll 1
  for (int l = 0; l < LPT; ++l) {
    if (l < lpt) {
      const int i = tid + l * Ta;
      fk[w - 1 - i] = __int_as_float(aux[i]);
    }
  }
  bar(Ta);
  cta_scan<LPT>(fk, nullptr, w, Ta, pad);
  // now fk[t] = S[w-1-t]; S1[p] = fk[w-2-p] (0 for p = w-1); the searched
  // array rev[t] = S1[w-1-t] = fk[t-1] (0 for t = 0)
  const float total = fk[w - 1];

  // ---- stage 3: inverse-CDF spanning-tree sampling --------------------
  const int first = w - m;
  const int levels = ilog2(w) + 1;         // ceil(log2(w + 1))
#pragma unroll 1
  for (int l = 0; l < LPT; ++l) {
    if (l < lpt) {
      const int p = tid + l * Ta;
      const float s1 = p < w - 1 ? fk[w - 2 - p] : 0.0f;
      const bool ev = p >= first && p < w - 1 && m >= 2;
      const float thresh = ev ? __fmaf_rn(-r.u[p - first], s1, s1) : 0.0f;
      int low = 0, high = w;
      for (int s = 0; s < levels; ++s) {
        const int mid = (low + high) >> 1;
        const float rv = mid > 0 ? fk[mid - 1] : 0.0f;
        if (thresh < rv) high = mid; else low = mid;
      }
      int j = p + 1 > w - high ? p + 1 : w - high;
      if (pad && !(thresh < total)) j = p + 1;   // W-wide search went right
      j = j < w - 1 ? j : w - 1;
      const float sval = __int_as_float(aux[p]);
      put_edge(r, w, p, ev, ik[p], ik[j],
               __fdiv_rn(__fmul_rn(s1, sval), safe_ell));
    }
  }
  put_padding(r, w, tid, Ta);
}

template <int LPT>
__device__ __forceinline__ void eliminate(const Row& r) {
  extern __shared__ unsigned char smem[];
  const int w = row_width(r.fill);
  if (w <= 32) {
    if (threadIdx.x < 32) warp_row(r, w);
    return;
  }
  const int Ta = w < static_cast<int>(blockDim.x) ? w : blockDim.x;
  if (threadIdx.x >= Ta) return;
  int* ik = reinterpret_cast<int*>(smem);
  float* fk = reinterpret_cast<float*>(ik + w);
  int* aux = reinterpret_cast<int*>(fk + w);
  cta_row<LPT>(r, w, Ta, ik, fk, aux);
}

struct CliqueArgs {
  const int* ids; const float* ws; const int* fill; const float* u;
  int* g_rows; float* g_vals; int* m; float* ell;
  int* e_lo; int* e_hi; float* e_w; unsigned char* e_valid;
  int W;
};

template <int LPT>
__global__ void __launch_bounds__(1024) sample_clique_kernel(
    const CliqueArgs a) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * a.W;
  int fill = a.fill[blockIdx.x];
  fill = fill < 0 ? 0 : (fill > a.W ? a.W : fill);
  Row r;
  r.ids = a.ids + base; r.ws = a.ws + base; r.u = a.u + base;
  r.fill = fill; r.W = a.W;
  r.g_rows = a.g_rows + base; r.g_vals = a.g_vals + base;
  r.m_out = a.m + blockIdx.x; r.ell_out = a.ell + blockIdx.x;
  r.elim = nullptr; r.dep = nullptr;
  r.e_lo = a.e_lo + base; r.e_hi = a.e_hi + base; r.e_w = a.e_w + base;
  r.e_valid = a.e_valid + base;
  r.fused = false; r.commit = false;
  eliminate<LPT>(r);
}

struct RoundArgs {
  int* pool_row; float* pool_val;                 // [B, P1]
  int* col_fill; int* dep; unsigned char* elim; float* D;   // [B, n + 1]
  const int64_t* col_base;                        // [B, n + 1]
  const float* u;                                 // [B, n, W]
  const int64_t* cand; const unsigned char* cand_ok;       // [B, chunk]
  int* e_lo; int* e_hi; float* e_w; unsigned char* e_valid;  // [B*chunk, W]
  int64_t P1; int n; int chunk; int W;
};

template <int LPT>
__global__ void __launch_bounds__(1024) sample_clique_round_kernel(
    const RoundArgs a) {
  const int row = blockIdx.x;
  const int b = row / a.chunk;
  const int64_t cand = a.cand[row];
  const bool ok = a.cand_ok[row] != 0;
  const int64_t col = static_cast<int64_t>(b) * (a.n + 1) + cand;
  const int64_t slab = ok ? static_cast<int64_t>(b) * a.P1 + a.col_base[col]
                          : 0;
  int fill = ok ? a.col_fill[col] : 0;
  fill = fill < 0 ? 0 : (fill > a.W ? a.W : fill);
  const int64_t vtx = cand < a.n - 1 ? cand : a.n - 1;
  const int64_t ebase = static_cast<int64_t>(row) * a.W;
  Row r;
  r.ids = a.pool_row + slab; r.ws = a.pool_val + slab;
  r.u = a.u + (static_cast<int64_t>(b) * a.n + vtx) * a.W;
  r.fill = fill; r.W = a.W;
  r.g_rows = a.pool_row + slab; r.g_vals = a.pool_val + slab;
  r.m_out = a.col_fill + col; r.ell_out = a.D + col; r.elim = a.elim + col;
  r.dep = a.dep + static_cast<int64_t>(b) * (a.n + 1);
  r.e_lo = a.e_lo + ebase; r.e_hi = a.e_hi + ebase; r.e_w = a.e_w + ebase;
  r.e_valid = a.e_valid + ebase;
  r.fused = true; r.commit = ok;
  eliminate<LPT>(r);
}

// Launch geometry of width W: T = min(max(W, 32), 1024) threads, LPT lanes
// per thread on the wide path, 12*W bytes of dynamic shared memory when a
// row may be wider than a warp.
template <class Args>
int launch(void (*kernel)(const Args), const Args& a, int R, int W,
           cudaStream_t stream) {
  const int T = W < 32 ? 32 : (W > 1024 ? 1024 : W);
  const size_t smem = W > 32 ? static_cast<size_t>(12) * W : 0;
  if (smem > 32768) {
    // rows of 4096 lanes and more need the opt-in shared-memory carve-out:
    // dynamic + the kernel's static shared memory passes the default 48 KiB
    // (the total must stay <= 227 KiB)
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<R, T, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <class Args>
int dispatch(void (*const kernels[5])(const Args), const Args& a, int R, int W,
             cudaStream_t s) {
  if (R == 0) return 0;
  if (W < 2 || (W & (W - 1)) || W > 16384)
    return static_cast<int>(cudaErrorInvalidValue);
  int k = 0;                                 // LPT = 1, 2, 4, 8, 16
  while ((1024 << k) < W) ++k;
  return launch(kernels[k], a, R, W, s);
}

}  // namespace

// Returns a cudaError_t; 0 on a successful launch.  W must be a power of
// two in [2, 16384]; the wrapper checks shapes, types and contiguity.
extern "C" int sample_clique_launch(
    const int* ids, const float* ws, const int* fill, const float* u,
    int* g_rows, float* g_vals, int* m, float* ell, int* e_lo, int* e_hi,
    float* e_w, unsigned char* e_valid, int R, int W, void* stream) {
  const CliqueArgs a{ids, ws, fill, u, g_rows, g_vals, m, ell,
                     e_lo, e_hi, e_w, e_valid, W};
  static void (*const kernels[5])(const CliqueArgs) = {
      sample_clique_kernel<1>, sample_clique_kernel<2>,
      sample_clique_kernel<4>, sample_clique_kernel<8>,
      sample_clique_kernel<16>};
  return dispatch(kernels, a, R, W, static_cast<cudaStream_t>(stream));
}

// One engine round over the B*chunk candidates (cand int64 [B, chunk],
// cand_ok bool [B, chunk]), in place on the engine state; edges to
// e_* [B*chunk, W].  P1 = pool slots per graph (drop slot included), n =
// vertices per graph (without the drop column).  Returns a cudaError_t.
extern "C" int sample_clique_round_launch(
    int* pool_row, float* pool_val, int* col_fill, int* dep,
    unsigned char* elim, float* D, const int64_t* col_base, const float* u,
    const int64_t* cand, const unsigned char* cand_ok, int* e_lo, int* e_hi,
    float* e_w, unsigned char* e_valid, long long P1, int n, int B,
    int chunk, int W, void* stream) {
  const RoundArgs a{pool_row, pool_val, col_fill, dep, elim, D, col_base, u,
                    cand, cand_ok, e_lo, e_hi, e_w, e_valid,
                    static_cast<int64_t>(P1), n, chunk, W};
  static void (*const kernels[5])(const RoundArgs) = {
      sample_clique_round_kernel<1>, sample_clique_round_kernel<2>,
      sample_clique_round_kernel<4>, sample_clique_round_kernel<8>,
      sample_clique_round_kernel<16>};
  return dispatch(kernels, a, B * chunk, W, static_cast<cudaStream_t>(stream));
}
