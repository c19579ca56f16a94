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
// What bounds it on an H100: operations.  The work is 4*d flops per (row,
// kept column): at the model shapes 500-1,000 flops per byte of q, k, v
// and o, above the ~295 flops per byte at which the tensor cores' bf16
// rate (989 TFLOP/s) overtakes the memory's.
//
// bfloat16 inputs: flash_fwd_wgmma, on the tensor cores.
//   * A block of one warpgroup (128 threads) owns one (b*h, 64-row q
//     tile).  q, k and v stay bf16 in shared memory, loaded by TMA
//     (cp.async.bulk.tensor, 3-D tensor maps [b*h, S, d] with 128-byte
//     swizzle, or 64-byte at d = 32) in 64-row boxes of 64 columns; rows
//     past S arrive as zeros.  K and V tiles of 64 rows land in a ring of
//     two stages with full and empty mbarriers: the TMA of tile j + 2 is
//     issued as soon as every thread has released tile j, so it loads
//     while tile j + 1 computes.
//   * S = Q K^T by wgmma.mma_async m64n64k16 with both operands in shared
//     memory (K-major), fp32 accumulator; scale * log2(e) is applied to
//     the fp32 scores, and the online softmax runs on the accumulator's
//     register layout (each row's 64 scores spread over the 4 threads of
//     a quad: two shuffles per row maximum) with ex2.approx.
//   * P is rounded to bf16 in registers and becomes the A operand of
//     O += P V, a wgmma m64n{d}k16 with B = the V tile read MN-major
//     (the transpose-B form that 16-bit types allow), so V is used in its
//     row-major layout.  The row sums l are kept from the fp32 P.
//   * The causal tile skip and heaviest-first order of q tiles stay;
//     columns past S and above the diagonal are set to -1e30 in the tiles
//     that hold any.
//   * It has no producer warp (one thread of the warpgroup issues the
//     TMA), no setmaxnreg, no second consumer warpgroup and no overlap of
//     the softmax with the next product: those are the next steps.
//   Registers: the O accumulator is d/2 fp32 a thread (128 at d = 256),
//   the scores 32, P 16; the build's -Xptxas -v reports spills.
//
// float32 inputs: flash_fwd_f32, fp32 FMAs on the CUDA cores.  A block of
// 256 threads (16 x 16) owns one (b*h, 64-row q tile) and keeps its q tile
// (times scale) in shared memory and its running (m, l, acc) in
// registers: thread (ty, tx) holds rows ty + 16 i (i < 4) and output
// columns tx + 16 j (j < d/16).  It loops over KV tiles of 64 rows staged
// in shared memory up to the causal bound; per tile the 64 x 64 score
// block by fmaf, the mask (-1e30), row maxima and sums by shuffles, P
// through shared memory and acc = alpha*acc + P V by fmaf; exponentials
// are the accurate expf.  The build has --fmad=false, so every
// multiply-add that should be one rounding is an explicit fmaf.
//
// Both kernels tile by 64 whatever the wrapper's q_tile / block_k: that
// changes only the order of the sums.  S need not divide by 64.  Grid: x
// over b*h, y over q tiles in reverse, so the heaviest causal tiles are
// issued first.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTq = 64;        // q rows per block
constexpr int kTk = 64;        // kv rows per shared-memory tile
constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// float32: fp32 FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;  // 16 x 16
constexpr int kRows = kTq / 16;   // rows per thread
constexpr int kCols = kTk / 16;   // score columns per thread
constexpr int kPs = kTk + 16;     // row stride of P: the two rows a warp
                                  // touches land 16 banks apart

template <int D>
constexpr size_t f32_smem_bytes() {
  // q and k rows padded to D + 1 floats (the score loop reads 16 k rows at
  // one column: D + 1 puts them in 16 banks), v rows unpadded, P
  return sizeof(float) *
         (static_cast<size_t>(kTq + kTk) * (D + 1) + kTk * D + kTq * kPs);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int S, float scale,
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
            ? __fmul_rn(q[base + static_cast<int64_t>(q0 + r) * D + c],
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
      sk[r * QS + c] = in ? k[g] : 0.0f;
      sv[r * D + c] = in ? v[g] : 0.0f;
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
    float* out = o + base + static_cast<int64_t>(row) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      out[tx + 16 * j] = __fdiv_rn(acc[i][j], denom);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma on the tensor cores, K and V by TMA
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 128;   // one warpgroup
constexpr int kStages = 2;        // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory layout of one 64-row tile of a [., d] bf16 matrix: d / CW
// chunks of 64 rows x CW columns, each row SW = 2 CW bytes, swizzled by
// the TMA in SW-byte rows (the layout wgmma reads without bank conflicts).
template <int D>
struct Tile {
  static constexpr int CW = D < 64 ? D : 64;     // columns per chunk
  static constexpr int SW = 2 * CW;              // swizzle span, bytes
  static constexpr int CHUNKS = D / CW;
  static constexpr int CHUNK = kTk * SW;         // bytes of one chunk
  static constexpr int BYTES = CHUNKS * CHUNK;   // bytes of one tile
  // q, then kStages K tiles, then kStages V tiles, then the mbarriers;
  // 1 KB of slack to align the base to the 1 KB swizzle atom
  static constexpr size_t SMEM =
      1024 + static_cast<size_t>(BYTES) * (1 + 2 * kStages) +
      8 * (2 * kStages + 1);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box (CW columns x 64 rows of one b*h) into shared memory,
// completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row,
                                         int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row), "r"(bh)
      : "memory");
}

template <int D>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row, int bh) {
  using T = Tile<D>;
#pragma unroll
  for (int c = 0; c < T::CHUNKS; ++c)
    tma_load(dst + c * T::CHUNK, map, bar, c * T::CW, row, bh);
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units) and the swizzle mode.
template <int SW>
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  constexpr uint64_t layout = SW == 128 ? 1 : 2;   // 128B or 64B swizzle
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pins accumulator registers at a point of the program, so the compiler
// neither reads them before wgmma.wait_group nor moves writes past a
// wgmma that reads them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// D[64 x 64] (+)= A[64 x 16] * B[64 x 16]^T, A and B K-major in shared
// memory; the accumulator is kept when acc != 0 and overwritten otherwise.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// D[64 x 32] += A[64 x 16] * B[16 x 32], A from registers (bf16 pairs),
// B MN-major in shared memory (the transposed form).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A from registers (bf16 pairs),
// B MN-major in shared memory (the transposed form).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128], A from registers (bf16 pairs),
// B MN-major in shared memory (the transposed form).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 256] += A[64 x 16] * B[16 x 256], A from registers (bf16 pairs),
// B MN-major in shared memory (the transposed form).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (D == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (D == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1) flash_fwd_wgmma(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
    int S, float scale, int causal) {
  using T = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sk = sq + T::BYTES;                  // [kStages][BYTES]
  uint8_t* sv = sk + kStages * T::BYTES;        // [kStages][BYTES]
  uint64_t* full = reinterpret_cast<uint64_t*>(sv + kStages * T::BYTES);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTq;
  int n_kv = (S + kTk - 1) / kTk;
  if (causal) n_kv = min(n_kv, (q0 + kTq + kTk - 1) / kTk);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWgThreads);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qbar, T::BYTES);
    tma_tile<D>(sq, &tq, qbar, q0, bh);
    for (int s = 0; s < kStages && s < n_kv; ++s) {
      mbar_expect_tx(&full[s], 2 * T::BYTES);
      tma_tile<D>(sk + s * T::BYTES, &tk, &full[s], s * kTk, bh);
      tma_tile<D>(sv + s * T::BYTES, &tv, &full[s], s * kTk, bh);
    }
  }

  // accumulator layout (m64nN, fp32): thread (warp w, lane l) holds rows
  // r0 = 16 w + l/4 and r0 + 8, and in each 8-column block j the columns
  // 8 j + 2 (l % 4) + {0, 1}: d[4j], d[4j+1] of row r0, d[4j+2], d[4j+3]
  // of row r0 + 8
  const int r0 = warp * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  const float scale_log2 = scale * kLog2e;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};   // this thread's part of the row sums

  mbar_wait(qbar, 0);
  const uint32_t q_addr = smem_u32(sq);
  for (int j = 0; j < n_kv; ++j) {
    const int st = j % kStages;
    const uint32_t phase = (j / kStages) & 1;
    mbar_wait(&full[st], phase);

    // S = Q K^T over d / 16 steps of 16 columns
    float s[kTk / 2];
#pragma unroll
    for (int i = 0; i < kTk / 2; ++i) s[i] = 0.0f;
    const uint32_t k_addr = smem_u32(sk + st * T::BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk * 16 / T::CW) * T::CHUNK + (kk * 16 % T::CW) * 2;
      wgmma_ss_n64(s, gmma_desc<T::SW>(q_addr + off, 16, 8 * T::SW),
                   gmma_desc<T::SW>(k_addr + off, 16, 8 * T::SW), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // scores in the log2 domain, masked where a column is past S or above
    // the diagonal
    const int k0 = j * kTk;
    const bool edge = k0 + kTk > S || (causal && k0 + kTk - 1 > q0);
#pragma unroll
    for (int i = 0; i < kTk / 2; ++i) {
      float x = s[i] * scale_log2;
      if (edge) {
        const int col = k0 + 8 * (i >> 2) + c0 + (i & 1);
        const int row = q0 + r0 + ((i & 2) ? 8 : 0);
        if (col >= S || (causal && col > row)) x = kNegInf;
      }
      s[i] = x;
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int b = 0; b < kTk / 8; ++b)
        mx = fmaxf(mx, fmaxf(s[4 * b + 2 * h], s[4 * b + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      alpha[h] = exp2_approx(m[h] - m_new);
      m[h] = m_new;
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < kTk / 2; ++i) {
      const int h = (i >> 1) & 1;
      s[i] = exp2_approx(s[i] - m[h]);
      rs[h] += s[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = __fmaf_rn(alpha[h], l[h], rs[h]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // P (bf16) as the A fragments of the k16 steps: step t takes the
    // column blocks 2t and 2t + 1
    uint32_t pa[kTk / 16][4];
#pragma unroll
    for (int t = 0; t < kTk / 16; ++t) {
      pa[t][0] = pack_bf16(s[8 * t + 0], s[8 * t + 1]);
      pa[t][1] = pack_bf16(s[8 * t + 2], s[8 * t + 3]);
      pa[t][2] = pack_bf16(s[8 * t + 4], s[8 * t + 5]);
      pa[t][3] = pack_bf16(s[8 * t + 6], s[8 * t + 7]);
    }

    // O += P V: V MN-major, 16 kv rows (16 SW bytes) per step, chunks of
    // CW output columns CHUNK bytes apart
    const uint32_t v_addr = smem_u32(sv + st * T::BYTES);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < kTk / 16; ++t)
      wgmma_pv<D>(acc, pa[t],
                  gmma_desc<T::SW>(v_addr + t * 16 * T::SW, T::CHUNK,
                                   8 * T::SW));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);

    // release the stage; one thread refills it with tile j + kStages
    mbar_arrive(&empty[st]);
    if (tid == 0 && j + kStages < n_kv) {
      mbar_wait(&empty[st], phase);
      mbar_expect_tx(&full[st], 2 * T::BYTES);
      tma_tile<D>(sk + st * T::BYTES, &tk, &full[st], (j + kStages) * kTk,
                  bh);
      tma_tile<D>(sv + st * T::BYTES, &tv, &full[st], (j + kStages) * kTk,
                  bh);
    }
    __syncwarp();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  const int64_t base = static_cast<int64_t>(bh) * S;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + 8 * h;
    if (row >= S) continue;
    const float inv = 1.0f / fmaxf(l[h], 1e-30f);
    __nv_bfloat16* out = o + (base + row) * D + c0;
#pragma unroll
    for (int b = 0; b < D / 8; ++b)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * b) =
          __floats2bfloat162_rn(acc[4 * b + 2 * h] * inv,
                                acc[4 * b + 2 * h + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time (no link against libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [BH, S, D] bf16 as a 3-D tensor map (D innermost) read in boxes of CW
// columns x 64 rows of one b*h; rows past S are filled with zeros.
template <int D>
int make_map(CUtensorMap* map, const void* ptr, int BH, int S) {
  using T = Tile<D>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(S) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(T::CW), kTk, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      T::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int BH,
                int S, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = Tile<D>::SMEM;
  static_assert(smem <= 232448, "over the H100's 227 KB per block");
  CUtensorMap tq, tk, tv;
  int e = make_map<D>(&tq, q, BH, S);
  if (e == 0) e = make_map<D>(&tk, k, BH, S);
  if (e == 0) e = make_map<D>(&tv, v, BH, S);
  if (e != 0) return e;
  cudaError_t ce = cudaFuncSetAttribute(
      flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (ce != cudaSuccess) return static_cast<int>(ce);
  const dim3 grid(BH, (S + kTq - 1) / kTq);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_wgmma<D><<<grid, kWgThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), S, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int BH,
               int S, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<D>();
  static_assert(smem <= 232448, "over the H100's 227 KB per block");
  // above 48 KB a block's shared memory needs the opt-in carve-out
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(BH, (S + kTq - 1) / kTq);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_f32<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int S, int causal, int bf16, float scale, cudaStream_t s) {
  return bf16 ? launch_bf16<D>(q, k, v, o, BH, S, causal, scale, s)
              : launch_f32<D>(q, k, v, o, BH, S, causal, scale, s);
}

}  // namespace

// Returns a cudaError_t; 0 on a successful launch.  q, k, v, o: [BH, S, d]
// contiguous, float32 (bf16 == 0) or bfloat16 (bf16 == 1, base addresses
// 16-byte aligned for the TMA); d in {32, 64, 128, 256}; scale is
// 1/sqrt(d) rounded once to float32, as the plain version's q * scale
// takes it.  The wrapper checks shapes, types, contiguity and alignment.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int BH, int S,
                                      int d, int causal, int bf16,
                                      float scale, void* stream) {
  if (BH == 0 || S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch<32>(q, k, v, o, BH, S, causal, bf16, scale, s);
    case 64: return launch<64>(q, k, v, o, BH, S, causal, bf16, scale, s);
    case 128: return launch<128>(q, k, v, o, BH, S, causal, bf16, scale, s);
    case 256: return launch<256>(q, k, v, o, BH, S, causal, bf16, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
