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
// At prefill (R = B*S, thousands of rows) the same product is bound by
// tensor-core operations; that path is a bf16 WMMA tile loop (128x128
// tiles, f32 accumulation) that converts each int8 weight tile to bf16 in
// shared memory.  It is the simple first cut: no asynchronous copies, no
// pipelining.
//
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
#include <mma.h>
#include <stdint.h>

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

// ---- prefill: bf16 WMMA tiles -------------------------------------------

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int GEMM_THREADS = 256;
constexpr int AS_LD = BK + 8;    // bf16 elements; row stride 80 B
constexpr int BS_LD = BN + 8;    // bf16 elements; row stride 272 B

__global__ void __launch_bounds__(GEMM_THREADS)
qmm_gemm_kernel(const __nv_bfloat16* __restrict__ x,
                const int8_t* __restrict__ q,
                const float* __restrict__ scale,
                __nv_bfloat16* __restrict__ out,
                int rows, int D, int N) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 As[BM * AS_LD];
  __shared__ __align__(32) __nv_bfloat16 Bs[BK * BS_LD];
  __shared__ __align__(32) float Cs[GEMM_THREADS / 32][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 2;   // 2 warp rows of 64
  const int wn = warp & 3;    // 4 warp columns of 32
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < D; k0 += BK) {
    // A: 128 x 32 bf16, two 16-byte chunks per thread
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int idx = tid + it * GEMM_THREADS;
      const int r = idx >> 2;
      const int c = (idx & 3) * 8;
      int4 v = make_int4(0, 0, 0, 0);
      if (m0 + r < rows)
        v = __ldg(reinterpret_cast<const int4*>(x + (size_t)(m0 + r) * D + k0 + c));
      *reinterpret_cast<int4*>(&As[r * AS_LD + c]) = v;
    }
    // B: 32 x 128 int8 -> bf16, one 16-byte chunk per thread
    {
      const int r = tid >> 3;
      const int c = (tid & 7) * 16;
      const int4 raw = __ldg(reinterpret_cast<const int4*>(q + (size_t)(k0 + r) * N + n0 + c));
      const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
      __align__(16) __nv_bfloat16 h[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) h[k] = __float2bfloat16((float)b[k]);
      *reinterpret_cast<int4*>(&Bs[r * BS_LD + c]) = *reinterpret_cast<int4*>(&h[0]);
      *reinterpret_cast<int4*>(&Bs[r * BS_LD + c + 8]) = *reinterpret_cast<int4*>(&h[8]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], &As[(wm * 64 + i * 16) * AS_LD + kk], AS_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], &Bs[kk * BS_LD + wn * 32 + j * 16], BS_LD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* cs = Cs[warp];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int idx = lane * 8 + e;
        const int r = m0 + wm * 64 + i * 16 + (idx >> 4);
        const int n = n0 + wn * 32 + j * 16 + (idx & 15);
        if (r < rows) out[(size_t)r * N + n] = __float2bfloat16(cs[idx] * scale[n]);
      }
      __syncwarp();
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
// int8; scale (N,) f32; g (D,) f32 or null (null: no norm prologue); partial (splits, rows, N) f32 scratch, used
// when splits > 1; out (rows, N) bf16.  D % 128 == 0 and N % 128 == 0.
// rows <= 64 takes the decode kernel, more rows the WMMA tile loop (which
// takes no norm).  Returns cudaGetLastError() after the launches.
int qmm_launch(const void* x, const void* q, const void* scale, const void* g,
               float eps, void* partial, void* out, int rows, int D, int N,
               int splits, int d_chunk, int x_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const int8_t* qb = static_cast<const int8_t*>(q);
  const float* sc = static_cast<const float*>(scale);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
  if (rows <= MAX_GEMV_ROWS) {
    const int smem = qmm_gemv_smem_bytes(rows, d_chunk);
    dim3 grid(N / GEMV_COLS, splits);
    const float* gf = static_cast<const float*>(g);
    float* pf = static_cast<float*>(partial);
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
          xb, qb, sc, nullptr, eps, static_cast<float*>(partial), ob, rows,
          D, N, d_chunk);
    }
    if (splits > 1) {
      const size_t total = (size_t)rows * N;
      const int threads = 256;
      qmm_reduce_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0, st>>>(
          static_cast<const float*>(partial), sc, ob, splits, rows, N);
    }
  } else {
    dim3 grid(N / BN, (rows + BM - 1) / BM);
    qmm_gemm_kernel<<<grid, GEMM_THREADS, 0, st>>>(xb, qb, sc, ob, rows, D, N);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
