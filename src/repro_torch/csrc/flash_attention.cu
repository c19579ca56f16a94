// Flash attention (forward), for Hopper:
//
//   o[b, h, r] = sum_c softmax_c(scale * q[b, h, r] . k[b, h, c]) v[b, h, c]
//
// over q, k, v, o: [B*H, S, d] contiguous, scale = 1/sqrt(d), causal rows
// keeping columns c <= r only.  Replaces the TPU kernel
// src/repro/kernels/flash_attention.py (_kernel, launched by
// flash_attention).  Its plain version is
// kernels/flash_attention.py::flash_attention_plain.
//
// Design: a block of 256 threads (16 x 16) owns one (b*h, q tile) of
// kTq = 64 rows and keeps, in float32, its q tile (times scale) in shared
// memory and its running (m, l, acc) online softmax in registers: thread
// (ty, tx) holds rows ty + 16 i (i < 4) and, of those rows, output columns
// tx + 16 j (j < d/16).  It loops over KV tiles of kTk = 64 rows staged in
// shared memory as float32, up to the causal bound
// min(ceil(S/kTk), ceil((q0 + kTq)/kTk)) — the tile skip that halves causal
// work.  Per tile: the 64 x 64 score block (each thread a 4 x 4 piece, dot
// products by fmaf), the mask (-1e30 off the causal triangle and past S),
// row maxima and sums by shuffles across the 16 threads that share a row,
// the probabilities through shared memory, and acc = alpha*acc + P V by
// fmaf.  It ends with acc / max(l, 1e-30), rounded to the output type.
// The internal tile sizes differ from the wrapper's q_tile / block_k:
// they change only the order of the sums, not the function.  S need not
// divide by them (rows and columns past S are masked).
//
// The build has --fmad=false, so every multiply-add that should be one
// rounding is an explicit fmaf; exponentials are the accurate expf.
//
// Grid: x over b*h, y over q tiles in reverse, so the blocks are issued
// heaviest causal tiles first and the last wave is the light ones.
//
// What bounds it on an H100: operations.  The work is 4*d flops per (row,
// kept column): at the model shapes 500-1,000 flops per byte of q, k, v
// and o, above the ~295 flops per byte at which the tensor cores' bf16
// rate (989 TFLOP/s) overtakes the memory's, so the card's least time is
// the tensor-core time.  This kernel does
// the products on the CUDA cores in float32 (67 TFLOP/s), from shared
// memory, one thread block per SM at d = 128 and 256 (its shared memory),
// so it is held by the fp32 rate and by shared-memory loads (two fmaf
// per scalar load in the score loop).  wgmma on bf16 tiles, TMA staging
// and a warp-specialised pipeline are the redesign that closes the gap.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTq = 64;        // q rows per block
constexpr int kTk = 64;        // kv rows per shared-memory tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kRows = kTq / 16;   // rows per thread
constexpr int kCols = kTk / 16;   // score columns per thread
constexpr int kPs = kTk + 16;     // row stride of P: the two rows a warp
                                  // touches land 16 banks apart
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int D>
constexpr size_t smem_bytes() {
  // q and k rows padded to D + 1 floats (the score loop reads 16 k rows at
  // one column: D + 1 puts them in 16 banks), v rows unpadded, P
  return sizeof(float) *
         (static_cast<size_t>(kTq + kTk) * (D + 1) + kTk * D + kTq * kPs);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int S, float scale,
    int causal) {
  constexpr int QS = D + 1;
  constexpr int DJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sq = smem;              // [kTq][QS]
  float* sk = sq + kTq * QS;     // [kTk][QS]
  float* sv = sk + kTk * QS;     // [kTk][D]
  float* sp = sv + kTk * D;      // [kTq][kPs]

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTq;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * S * D;

  for (int idx = threadIdx.x; idx < kTq * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    sq[r * QS + c] =
        q0 + r < S
            ? __fmul_rn(to_f32(q[base + static_cast<int64_t>(q0 + r) * D + c]),
                        scale)
            : 0.0f;
  }

  float m[kRows], l[kRows], acc[kRows][DJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }

  int n_kv = (S + kTk - 1) / kTk;
  if (causal) n_kv = min(n_kv, (q0 + kTq + kTk - 1) / kTk);
  for (int kb = 0; kb < n_kv; ++kb) {
    const int k0 = kb * kTk;
    __syncthreads();  // the previous tile's k, v and P are read; q is staged
    for (int idx = threadIdx.x; idx < kTk * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      const bool in = k0 + r < S;
      const int64_t g = base + static_cast<int64_t>(k0 + r) * D + c;
      sk[r * QS + c] = in ? to_f32(k[g]) : 0.0f;
      sv[r * D + c] = in ? to_f32(v[g]) : 0.0f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float a[kRows], b[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = sq[(ty + 16 * i) * QS + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) b[j] = sk[(tx + 16 * j) * QS + c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = __fmaf_rn(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = k0 + tx + 16 * j;
        if (col >= S || (causal && col > row)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are lanes 16*(ty&1) .. +15 of one warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        sp[(ty + 16 * i) * kPs + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = __fmaf_rn(alpha, l[i], rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] = __fmul_rn(acc[i][j], alpha);
    }
    __syncthreads();  // P complete

#pragma unroll 4
    for (int kk = 0; kk < kTk; ++kk) {
      float p[kRows], w[DJ];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = sp[(ty + 16 * i) * kPs + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) w[j] = sv[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = __fmaf_rn(p[i], w[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* out = o + base + static_cast<int64_t>(row) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      store(out + tx + 16 * j, __fdiv_rn(acc[i][j], denom));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int S, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static_assert(smem <= 232448, "over the H100's 227 KB per block");
  // above 48 KB a block's shared memory needs the opt-in carve-out
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(BH, (S + kTq - 1) / kTq);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int BH,
             int S, int d, int causal, float scale, cudaStream_t s) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, o, BH, S, causal, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, BH, S, causal, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, BH, S, causal, scale, s);
    case 256: return launch<T, 256>(q, k, v, o, BH, S, causal, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Returns a cudaError_t; 0 on a successful launch.  q, k, v, o: [BH, S, d]
// contiguous, float32 (bf16 == 0) or bfloat16 (bf16 == 1); d in
// {32, 64, 128, 256}; scale is 1/sqrt(d) rounded once to float32, as the
// plain version's q * scale takes it.  The wrapper checks shapes, types
// and contiguity.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int BH, int S,
                                      int d, int causal, int bf16,
                                      float scale, void* stream) {
  if (BH == 0 || S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_d<__nv_bfloat16>(q, k, v, o, BH, S, d, causal, scale, s);
  return launch_d<float>(q, k, v, o, BH, S, d, causal, scale, s);
}
