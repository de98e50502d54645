// int8 weight-only matmul with the dequantize fused into the kernel:
//
//     out[R, N] = bf16( (x[R, D] @ q8[D, N]) * scale[N] )
//
// Replaces the Pallas kernels of mlcomp_tpu/ops/pallas/quant_matmul.py:
// `_kernel` (the plain product) and `_kernel_norm` (an RMSNorm of x folded
// into the prologue), both launched by `quant_matmul`.
//
// What bounds it on an H100: at decode (R <= 64 rows) the int8 weight
// bytes.  Every generated token reads every projection once; x is a few
// KB.  The design streams q8 once with 16-byte loads along N (the
// contiguous axis of the (D, N) layout) and does nothing else with
// device memory: one CTA owns a 128-column strip of N for a slice of D,
// its 8 warps split that slice 32 rows at a time, and partial sums meet
// in shared memory.  Narrow N (2048 columns = 16 strips) would leave most
// of the 132 SMs idle, so D is also split across CTAs and a second, tiny
// pass adds the splits in a fixed order (deterministic; no atomics).
//
// Above 64 rows (admission chunks of 256 rows, prefills of thousands) the
// product is bound by tensor-core operations, and at 256 rows the weight
// bytes come close behind.  That path is a Hopper GEMM whose B operand is
// dequantized in shared memory (wgmma.cuh):
// - a CTA of two warpgroups owns a 128 x 128 output tile for a slice of D;
//   each warpgroup's 64 rows are wgmma's M, and m64n128k16 reads x and the
//   bf16 weight tile, both K-major in 128-byte-swizzled shared memory,
//   into f32 register accumulators;
// - a three-stage cp.async ring brings each 64-deep step's x tile (bf16)
//   and raw int8 weight tile (8 KB, half the bytes of a bf16 weight);
// - all threads turn the raw tile into bf16, transposed to K-major: a
//   byte permute interleaves two weight rows, another puts each value
//   under the exponent of 128, two logic ops split off its sign and one
//   bf16x2 add removes the offset (exact; 2.25 instructions a value).  Two
//   bf16 buffers let step t + 1's conversion run while step t's products
//   are in flight;
// - 128 registers and 105 KB of shared memory a CTA: two CTAs share an
//   SM, so one converts or waits at a barrier while the other's products
//   run;
// - a small planner in the wrapper splits D into slices of whole steps
//   where the output tiles leave SMs idle (256 rows of a 2048-wide
//   projection make 32 tiles), and the GEMV path's second pass adds the
//   slices in a fixed order: deterministic, no atomics.
// No TMA, producer warp or register rebalancing: all 256 threads copy,
// convert and issue products.  (A producer warpgroup that copied and
// converted for two consumer ones fell behind them; 256-column tiles ran
// their transposed-B products slower, and their K-major ones left the
// conversion nothing to hide behind on a one-CTA SM.)

// Arithmetic matches the TPU kernel: x arrives rounded to bf16, int8 ->
// bf16 is exact and a product of two bf16 values is exact in f32, so the
// only difference is the order of the f32 sums.  The scale multiplies the
// f32 accumulator once; the result rounds to bf16.  With the norm
// prologue, each CTA first computes every row's inverse RMS over the full
// row (f32 mean of squares), then normalises x as it stages it:
// bf16(x * inv_rms * g) — the TPU's order.  The normed rows are never
// written to device memory, and never held whole (64 rows x 2048 x 2 B
// would not fit a block's shared memory).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int GEMV_COLS = 128;   // N strip per CTA
constexpr int GEMV_THREADS = 256;
constexpr int GEMV_WARPS = GEMV_THREADS / 32;
constexpr int ROW_TILE = 8;      // rows accumulated per pass over D
constexpr int MAX_GEMV_ROWS = 64;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

// grid (N / 128, splits); dynamic smem: rows * d_chunk floats of staged x,
// then the cross-warp reduction buffer, then the rows' inverse RMS.  x is
// bf16, or f32 for the norm prologue of an f32 model (the norm's input).
template <typename TX, bool NORM>
__global__ void __launch_bounds__(GEMV_THREADS)
qmm_gemv_kernel(const TX* __restrict__ x,
                const int8_t* __restrict__ q,
                const float* __restrict__ scale,
                const float* __restrict__ g,
                float eps,
                float* __restrict__ partial,
                __nv_bfloat16* __restrict__ out,
                int rows, int D, int N, int d_chunk) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  float* red = xs + rows * d_chunk;
  float* inv = red + GEMV_WARPS * ROW_TILE * GEMV_COLS;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int cg = lane & 7;                 // 16-column group
  const int dl = warp * 4 + (lane >> 3);   // D lane, 0..31
  const int n0 = blockIdx.x * GEMV_COLS;
  const int split = blockIdx.y;
  const int d_begin = split * d_chunk;

  if (NORM) {
    for (int r = warp; r < rows; r += GEMV_WARPS) {
      float ss = 0.f;
      for (int d = lane; d < D; d += 32) {
        const float v = to_float(x[(size_t)r * D + d]);
        ss += v * v;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
      if (lane == 0) inv[r] = 1.0f / sqrtf(ss / (float)D + eps);
    }
    __syncthreads();
  }
  for (int i = tid; i < rows * d_chunk; i += GEMV_THREADS) {
    const int r = i / d_chunk;
    const int d = d_begin + (i - r * d_chunk);
    float v = to_float(x[(size_t)r * D + d]);
    if (NORM) v = bf16_round((v * inv[r]) * g[d]);
    xs[i] = v;
  }
  __syncthreads();

  for (int r0 = 0; r0 < rows; r0 += ROW_TILE) {
    const int rt = min(ROW_TILE, rows - r0);
    float acc[ROW_TILE][16];
#pragma unroll
    for (int r = 0; r < ROW_TILE; ++r)
#pragma unroll
      for (int k = 0; k < 16; ++k) acc[r][k] = 0.f;

    const int8_t* qp = q + (size_t)(d_begin + dl) * N + n0 + cg * 16;
    for (int dd = dl; dd < d_chunk; dd += 32, qp += (size_t)32 * N) {
      const int4 raw = __ldg(reinterpret_cast<const int4*>(qp));
      const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
      float qf[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) qf[k] = (float)b[k];
#pragma unroll
      for (int r = 0; r < ROW_TILE; ++r) {
        if (r < rt) {
          const float xv = xs[(r0 + r) * d_chunk + dd];
#pragma unroll
          for (int k = 0; k < 16; ++k) acc[r][k] = fmaf(xv, qf[k], acc[r][k]);
        }
      }
    }
    // the four D lanes of a warp that share a column group
#pragma unroll
    for (int r = 0; r < ROW_TILE; ++r)
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        float v = acc[r][k];
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        acc[r][k] = v;
      }
    if ((lane >> 3) == 0) {
#pragma unroll
      for (int r = 0; r < ROW_TILE; ++r)
#pragma unroll
        for (int k = 0; k < 16; ++k)
          red[(warp * ROW_TILE + r) * GEMV_COLS + cg * 16 + k] = acc[r][k];
    }
    __syncthreads();
    for (int o = tid; o < rt * GEMV_COLS; o += GEMV_THREADS) {
      const int r = o / GEMV_COLS;
      const int c = o - r * GEMV_COLS;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < GEMV_WARPS; ++w) s += red[(w * ROW_TILE + r) * GEMV_COLS + c];
      const int n = n0 + c;
      if (gridDim.y == 1) {
        out[(size_t)(r0 + r) * N + n] = __float2bfloat16(s * scale[n]);
      } else {
        partial[((size_t)split * rows + r0 + r) * N + n] = s;
      }
    }
    __syncthreads();
  }
}

__global__ void qmm_reduce_kernel(const float* __restrict__ partial,
                                  const float* __restrict__ scale,
                                  __nv_bfloat16* __restrict__ out,
                                  int splits, int rows, int N) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)rows * N;
  if (idx >= total) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += partial[sp * total + idx];
  out[idx] = __float2bfloat16(s * scale[idx % N]);
}

// ---- more than 64 rows: wgmma tiles, B dequantized in shared memory -----

constexpr int BM = 128, BN = 128, BK = 64;    // output tile; depth of a step
constexpr int GEMM_THREADS = 256;             // two warpgroups of 64 rows
constexpr int STAGES = 3;                     // cp.async ring of (x, raw q8)
constexpr int X_BYTES = BM * BK * 2;          // 16 KB, K-major, swizzled
constexpr int Q_BYTES = BK * BN;              // 8 KB raw int8, N contiguous
constexpr int B_BYTES = BK * BN * 2;          // 16 KB bf16, K-major, swizzled
// the ring, two bf16 weight tiles, alignment: 105 KB, two CTAs an SM
constexpr int GEMM_SMEM = STAGES * (X_BYTES + Q_BYTES) + 2 * B_BYTES + 1024;

// grid (N / 128, ceil(rows / 128), splits); each CTA sums `steps` steps of
// 64 from D row split * steps * 64.  partial == null: out = bf16(acc *
// scale); else the f32 sums go to partial[split] for qmm_reduce_kernel.
__global__ void __launch_bounds__(GEMM_THREADS, 2)
qmm_wgmma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ scale, float* __restrict__ partial,
                 __nv_bfloat16* __restrict__ out, int rows, int D, int N, int steps) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw0 = smem_u32(smem_raw);
  const uint32_t base = (raw0 + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw0);   // the same bytes, generic
  const uint32_t sB = base;                          // two converted tiles
  const uint32_t sX = sB + 2 * B_BYTES;              // STAGES x tiles
  const uint32_t sQ = sX + STAGES * X_BYTES;         // STAGES raw weight tiles

  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * steps * BK;

  // Step t's copies into stage t % STAGES.  A warpgroup copies its own 64
  // rows of x (so it may refill a stage once its own products of that
  // stage are done), chunk c of row r at chunk c ^ (r % 8).  All threads
  // copy the raw weights, whole 128-byte rows per eight lanes; chunk c of
  // weight row r lands at c ^ (r / 8 % 8), so that the conversion's reads
  // below meet no bank conflict.
  auto load_step = [&](int t) {
    const int stage = t % STAGES;
    const int k0 = k_begin + t * BK;
    const uint32_t xs = sX + stage * X_BYTES;
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int i = wt + it * 128;
      const int r = wg * 64 + (i >> 3), c = i & 7;
      const bool valid = m0 + r < rows;
      const __nv_bfloat16* src = valid ? x + (size_t)(m0 + r) * D + k0 + c * 8 : x;
      cp_async_16(xs + r * 128 + ((c ^ (r & 7)) << 4), src, valid);
    }
    const uint32_t qs = sQ + stage * Q_BYTES;
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int i = tid + it * GEMM_THREADS;
      const int r = i >> 3, c = i & 7;
      cp_async_16(qs + r * 128 + ((c ^ ((r >> 3) & 7)) << 4),
                  q + (size_t)(k0 + r) * N + n0 + c * 16, true);
    }
  };

  // Step t's raw weights -> bf16 buffer t % 2, transposed to K-major (the
  // layout of K in the flash kernels: the transposed-B products run slower
  // than K-major ones on the card): weight column n is a 128-byte row, its
  // 8-deep chunk j at j ^ (n % 8).  Lane l of warp w converts rows
  // 8 (l % 8) .. + 7 of the four columns from n = 16 w + 4 (l / 8):
  // thirty-two lanes read distinct banks, and each eight store eight
  // distinct chunks of one column.  A byte permute interleaves rows k and
  // k + 1 (two columns a word), then each pair converts exactly
  // (wgmma.cuh's bf16x2_of_int8).
  const int cj = lane & 7;
  const int cn = (wg * 4 + warp) * 16 + (lane >> 3) * 4;
  auto convert_step = [&](int t) {
    const unsigned char* qs = gbase + (sQ - base) + (t % STAGES) * Q_BYTES;
    unsigned char* bs = gbase + (t & 1) * B_BYTES;
    uint32_t w[8];
#pragma unroll
    for (int m = 0; m < 8; ++m)
      w[m] = *reinterpret_cast<const uint32_t*>(qs + (8 * cj + m) * 128 +
                                                (((cn >> 4) ^ cj) << 4) + (cn & 15));
    uint32_t o[4][4];   // [column][pair of rows]
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const uint32_t ta = __byte_perm(w[2 * p], w[2 * p + 1], 0x5140);   // columns 0, 1
      const uint32_t tb = __byte_perm(w[2 * p], w[2 * p + 1], 0x7362);   // columns 2, 3
      o[0][p] = bf16x2_of_int8(ta, 0x4140);
      o[1][p] = bf16x2_of_int8(ta, 0x4342);
      o[2][p] = bf16x2_of_int8(tb, 0x4140);
      o[3][p] = bf16x2_of_int8(tb, 0x4342);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = cn + i;
      *reinterpret_cast<uint4*>(bs + n * 128 + ((cj ^ (n & 7)) << 4)) =
          make_uint4(o[i][0], o[i][1], o[i][2], o[i][3]);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_step(s);
    cp_async_commit();
  }

  // Step t: this thread's copies of step t have landed.  The first barrier
  // publishes every thread's copies and says both warpgroups have retired
  // step t - 2's products, the last readers of bf16 buffer t % 2; the
  // threads convert into it.  The second publishes the buffer; the
  // products issue; waiting for all but the newest group retires step
  // t - 1's, which frees this warpgroup's x rows of stage
  // (t - 1) % STAGES (its raw weights were converted before the second
  // barrier of step t - 1) for the copies of step t + STAGES - 1.  The
  // conversion of step t + 1 runs while step t's products are in flight,
  // and the SM's other CTA fills the barriers' gaps.
  float acc[64];
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    convert_step(t);
    fence_proxy_async();
    __syncthreads();
    const uint32_t xa = sX + (t % STAGES) * X_BYTES + wg * 64 * 128;
    const uint32_t bb = sB + (t & 1) * B_BYTES;
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_ss_n128(acc, desc_kmajor(xa, 64, kk), desc_kmajor(bb, BN, kk), t > 0 || kk > 0);
    wgmma_commit();
    fence_operands(acc);
    wgmma_wait<1>();
    fence_operands(acc);
    if (t + STAGES - 1 < steps) load_step(t + STAGES - 1);
    cp_async_commit();
  }
  wgmma_wait<0>();
  fence_operands(acc);

  // accumulator element 4j + 2h + e: row 16 warp + lane / 4 + 8h, column
  // 8j + 2 (lane % 4) + e of this warpgroup's 64 x 128 tile
  const int row0 = m0 + wg * 64 + warp * 16 + (lane >> 2);
  const int col0 = n0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = col0 + 8 * j;
    const float2 sc = partial ? make_float2(1.f, 1.f)
                              : *reinterpret_cast<const float2*>(scale + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= rows) continue;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (partial) {
        *reinterpret_cast<float2*>(partial + ((size_t)blockIdx.z * rows + row) * N + col) =
            make_float2(v0, v1);
      } else {
        *reinterpret_cast<uint32_t*>(out + (size_t)row * N + col) =
            pack_bf16(v0 * sc.x, v1 * sc.y);
      }
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory the decode kernel needs for (rows, d_chunk).
int qmm_gemv_smem_bytes(int rows, int d_chunk) {
  return (rows * d_chunk + GEMV_WARPS * ROW_TILE * GEMV_COLS + MAX_GEMV_ROWS) *
         (int)sizeof(float);
}

// x (rows, D) bf16 (or f32 when x_f32 != 0, norm prologue only); q (D, N)
// int8; scale (N,) f32; g (D,) f32 or null (null: no norm prologue);
// partial (splits, rows, N) f32 scratch, used when splits > 1; out (rows,
// N) bf16.  D % 128 == 0 and N % 128 == 0; D splits into `splits` slices
// of d_chunk rows.  rows <= 64 takes the decode kernel, more rows the
// wgmma tiles (no norm; d_chunk a multiple of 64).  Returns
// cudaGetLastError() after the launches.
int qmm_launch(const void* x, const void* q, const void* scale, const void* g,
               float eps, void* partial, void* out, int rows, int D, int N,
               int splits, int d_chunk, int x_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const int8_t* qb = static_cast<const int8_t*>(q);
  const float* sc = static_cast<const float*>(scale);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
  float* pf = splits > 1 ? static_cast<float*>(partial) : nullptr;
  if (rows <= MAX_GEMV_ROWS) {
    const int smem = qmm_gemv_smem_bytes(rows, d_chunk);
    dim3 grid(N / GEMV_COLS, splits);
    const float* gf = static_cast<const float*>(g);
    if (g != nullptr && x_f32) {
      cudaFuncSetAttribute(qmm_gemv_kernel<float, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      qmm_gemv_kernel<float, true><<<grid, GEMV_THREADS, smem, st>>>(
          static_cast<const float*>(x), qb, sc, gf, eps, pf, ob, rows, D, N, d_chunk);
    } else if (g != nullptr) {
      cudaFuncSetAttribute(qmm_gemv_kernel<__nv_bfloat16, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      qmm_gemv_kernel<__nv_bfloat16, true><<<grid, GEMV_THREADS, smem, st>>>(
          xb, qb, sc, gf, eps, pf, ob, rows, D, N, d_chunk);
    } else {
      cudaFuncSetAttribute(qmm_gemv_kernel<__nv_bfloat16, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      qmm_gemv_kernel<__nv_bfloat16, false><<<grid, GEMV_THREADS, smem, st>>>(
          xb, qb, sc, nullptr, eps, pf, ob, rows, D, N, d_chunk);
    }
  } else {
    cudaFuncSetAttribute(qmm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         GEMM_SMEM);
    dim3 grid(N / BN, (rows + BM - 1) / BM, splits);
    qmm_wgmma_kernel<<<grid, GEMM_THREADS, GEMM_SMEM, st>>>(xb, qb, sc, pf, ob, rows, D, N,
                                                            d_chunk / BK);
  }
  if (splits > 1) {
    const size_t total = (size_t)rows * N;
    const int threads = 256;
    qmm_reduce_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0, st>>>(
        pf, sc, ob, splits, rows, N);
  }
  return (int)cudaGetLastError();
}

// Resources of the tiled path's kernel and of the split pass, six ints
// each: registers per thread, static shared bytes, dynamic shared bytes,
// local (spill) bytes per thread, threads per CTA, CTAs per SM.  Returns
// the first CUDA error.
int qmm_resources(int* res) {
  cudaFuncSetAttribute(qmm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       GEMM_SMEM);
  const void* fns[2] = {(const void*)qmm_wgmma_kernel, (const void*)qmm_reduce_kernel};
  const int threads[2] = {GEMM_THREADS, 256};
  const int smem[2] = {GEMM_SMEM, 0};
  for (int i = 0; i < 2; ++i) {
    cudaFuncAttributes a;
    cudaError_t err = cudaFuncGetAttributes(&a, fns[i]);
    if (err != cudaSuccess) return (int)err;
    int ctas = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fns[i], threads[i], smem[i]);
    if (err != cudaSuccess) return (int)err;
    int* r = res + 6 * i;
    r[0] = a.numRegs;
    r[1] = (int)a.sharedSizeBytes;
    r[2] = smem[i];
    r[3] = (int)a.localSizeBytes;
    r[4] = threads[i];
    r[5] = ctas;
  }
  return 0;
}

}  // extern "C"
