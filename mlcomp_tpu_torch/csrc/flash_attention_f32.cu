// Flash attention on f32 inputs, forward and backward (delta, dq, dk/dv),
// causal and/or bounded by per-row key windows [kv_lo, kv_hi), with GQA,
// at head dims 128 and 256 (the wrapper zero-pads smaller heads, as for
// bf16).
//
// Replaces the same Pallas kernels as flash_attention.cu and
// flash_attention_bwd.cu (mlcomp_tpu/ops/pallas/flash_attention.py:
// `_fwd_kernel` :291, `_fwd_kernel_tri` :435, `_fwd_kernel_bsched` :507;
// `_dq_kernel` / `_dkv_kernel` :639 / :676, `_dq_kernel_tri` /
// `_dkv_kernel_tri` :738 / :761, `_dq_kernel_bsched` / `_dkv_kernel_bsched`
// :787 / :813) when they run on f32 inputs.  The TPU kernel then computes
// in f32 throughout: f32 products, an f32 softmax, and p kept in f32
// before P V (`p.astype(v.dtype)` is a no-op).  Hopper's tensor cores take
// f32 only as TF32, which keeps 10 mantissa bits and does not hold f32
// tolerances, so these kernels run on the CUDA cores (FFMA).
//
// What bounds it on an H100 (each of the four kernels): operations, at
// the card's 67 TFLOP/s of f32 outside the tensor cores (4 x dh operations
// per live pair forward, 10 x dh backward, against 4 x 3 x dh bytes of
// Q/K/V rows).  The design is the simple one; it does not approach that
// bound:
// - a warp owns R = 4 query rows (forward, dq) or 4 keys (dk/dv); a CTA of
//   8 warps owns 32, and the other side streams through shared memory in
//   tiles of 32, one element per lane;
// - lane j computes the dot products of element j of the tile with the
//   warp's 4 rows (its own row of the tile padded to DH + 1 floats, so the
//   32 lanes hit 32 banks; the warp's rows are broadcast reads); the
//   softmax's max and sum are xor-shuffle trees over the 32 lanes;
// - the accumulators (O, dQ, dK, dV) are spread over the lanes by column:
//   lane l holds columns l, l + 32, ..., each product's coefficient
//   arrives by a shuffle from the lane that computed it.
// Semantics are the bf16 kernels': logits masked to -1e30; p selected to 0
// on masked logits, so a row whose causal-and-window key set is empty
// outputs 0 with lse -1e30 and gets zero gradients; the output divides by
// l (l == 0 gives 0).  No atomics: every sum runs in one fixed order, and
// the same inputs give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8, R = 4, TILE = 32, THREADS = 32 * WARPS, BQ = WARPS * R;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// rows [row0, row0 + ROWS) of a (n_rows x DH) f32 matrix with a row stride
// of `stride` floats into shared memory with a row pitch of `pitch`
// floats; rows past n_rows are zero-filled.  All THREADS threads share it.
template <int ROWS, int DH>
__device__ __forceinline__ void load_rows(float* dst, int pitch, const float* src, int row0,
                                          int n_rows, size_t stride) {
  for (int i = threadIdx.x; i < ROWS * DH; i += THREADS) {
    const int r = i / DH, d = i % DH;
    dst[r * pitch + d] = row0 + r < n_rows ? src[(size_t)(row0 + r) * stride + d] : 0.f;
  }
}

template <int DH>
struct F32 {
  static constexpr int E = DH / 32;   // accumulator columns a lane
  static constexpr int P = DH + 1;    // padded row pitch: lane j reads row j
  static constexpr int FWD_SMEM = (BQ * DH + TILE * P + TILE * DH) * 4;
  static constexpr int DQ_SMEM = (2 * BQ * DH + 2 * TILE * P) * 4;
  static constexpr int DKV_SMEM = (2 * BQ * DH + 2 * TILE * P + 2 * TILE) * 4;
};

// one CTA per (head, batch, 32-row Q tile); warp w owns rows q0 + 4 w ..
template <int DH>
__global__ void __launch_bounds__(THREADS)
f32_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const int* __restrict__ kv_lo,
               const int* __restrict__ kv_hi, float* __restrict__ out,
               float* __restrict__ lse, int H, int Hkv, int Sq, int Sk, int causal,
               float scale) {
  using C = F32<DH>;
  constexpr int E = C::E, P = C::P;
  extern __shared__ float smem[];
  float* sQ = smem;                  // (BQ, DH)
  float* sK = sQ + BQ * DH;          // (TILE, DH + 1)
  float* sV = sK + TILE * P;         // (TILE, DH)

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // longest causal tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hk = h / (H / Hkv);
  const int lo = kv_lo ? max(kv_lo[b], 0) : 0;
  const int hi = kv_hi ? min(kv_hi[b], Sk) : Sk;
  const int kv_begin = (lo / TILE) * TILE;
  const int kv_end = causal ? min(hi, q0 + BQ) : hi;

  const size_t q_stride = (size_t)H * DH, kv_stride = (size_t)Hkv * DH;
  load_rows<BQ, DH>(sQ, DH, q + ((size_t)b * Sq * H + h) * DH, q0, Sq, q_stride);
  const float* kb = k + ((size_t)b * Sk * Hkv + hk) * DH;
  const float* vb = v + ((size_t)b * Sk * Hkv + hk) * DH;
  const float* qw = sQ + warp * R * DH;
  const int row0 = q0 + warp * R;

  float o[R][E], m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) o[r][e] = 0.f;
  }

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += TILE) {
    __syncthreads();   // every warp is done with the previous tile
    load_rows<TILE, DH>(sK, P, kb, kv0, Sk, kv_stride);
    load_rows<TILE, DH>(sV, DH, vb, kv0, Sk, kv_stride);
    __syncthreads();
    // lane j: the logits of key kv0 + j against the warp's R rows
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
    const float* kj = sK + lane * P;
    for (int d = 0; d < DH; ++d) {
      const float kd = kj[d];
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] = fmaf(qw[r * DH + d], kd, s[r]);
    }
    const int col = kv0 + lane;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = row0 + r;
      const bool live = col >= lo && col < hi && (!causal || row >= col);
      const float sr = live ? s[r] * scale : NEG_INF;
      const float mx = fmaxf(m[r], warp_max(sr));
      const float alpha = expf(m[r] - mx);
      const float p = live ? expf(sr - mx) : 0.f;   // selected, never exp of a mask
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = mx;
      s[r] = p;
#pragma unroll
      for (int e = 0; e < E; ++e) o[r][e] *= alpha;
    }
    for (int j = 0; j < TILE; ++j) {
      float vj[E];
#pragma unroll
      for (int e = 0; e < E; ++e) vj[e] = sV[j * DH + lane + 32 * e];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float pj = __shfl_sync(0xffffffffu, s[r], j);
#pragma unroll
        for (int e = 0; e < E; ++e) o[r][e] = fmaf(pj, vj[e], o[r][e]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    if (row >= Sq) continue;
    const float ls = l[r] == 0.f ? 1.f : l[r];
    float* orow = out + (((size_t)b * Sq + row) * H + h) * DH;
#pragma unroll
    for (int e = 0; e < E; ++e) orow[lane + 32 * e] = o[r][e] / ls;
    if (lane == 0)
      lse[((size_t)b * H + h) * Sq + row] = (m[r] > NEG_INF / 2 ? m[r] : NEG_INF) + logf(ls);
  }
}

// delta = sum_d dO * O (minus the lse cotangent when given): one warp per
// (b, i, h) row of the (B, Sq, H, DH) tensors
template <int DH>
__global__ void __launch_bounds__(256)
f32_delta_kernel(const float* __restrict__ dout, const float* __restrict__ out,
                 const float* __restrict__ g_lse, float* __restrict__ delta, int H, int Sq,
                 long rows) {
  const long row = (long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < DH / 32; ++e)
    s = fmaf(dout[row * DH + lane + 32 * e], out[row * DH + lane + 32 * e], s);
  s = warp_sum(s);
  if (lane == 0) {
    const int h = (int)(row % H);
    const long bi = row / H;
    const int i = (int)(bi % Sq);
    const long b = bi / Sq;
    const long idx = (b * H + h) * Sq + i;
    delta[idx] = g_lse ? s - g_lse[idx] : s;
  }
}

// dq: one CTA per (head, batch, 32-row Q tile), warp w owning 4 rows; K/V
// tiles of 32 keys, lane j computing s and dp of key j; dQ += dS K
template <int DH>
__global__ void __launch_bounds__(THREADS)
f32_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const int* __restrict__ kv_lo, const int* __restrict__ kv_hi,
              float* __restrict__ dq, int H, int Hkv, int Sq, int Sk, int causal,
              float scale) {
  using C = F32<DH>;
  constexpr int E = C::E, P = C::P;
  extern __shared__ float smem[];
  float* sQ = smem;                  // (BQ, DH)
  float* sdO = sQ + BQ * DH;         // (BQ, DH)
  float* sK = sdO + BQ * DH;         // (TILE, DH + 1)
  float* sV = sK + TILE * P;         // (TILE, DH + 1)

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hk = h / (H / Hkv);
  const int lo = kv_lo ? max(kv_lo[b], 0) : 0;
  const int hi = kv_hi ? min(kv_hi[b], Sk) : Sk;
  const int kv_begin = (lo / TILE) * TILE;
  const int kv_end = causal ? min(hi, q0 + BQ) : hi;

  const size_t q_stride = (size_t)H * DH, kv_stride = (size_t)Hkv * DH;
  const size_t q_off = ((size_t)b * Sq * H + h) * DH;
  load_rows<BQ, DH>(sQ, DH, q + q_off, q0, Sq, q_stride);
  load_rows<BQ, DH>(sdO, DH, dout + q_off, q0, Sq, q_stride);
  const float* kb = k + ((size_t)b * Sk * Hkv + hk) * DH;
  const float* vb = v + ((size_t)b * Sk * Hkv + hk) * DH;
  const float* qw = sQ + warp * R * DH;
  const float* dow = sdO + warp * R * DH;
  const int row0 = q0 + warp * R;
  float lse_r[R], dl[R], acc[R][E];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    const size_t idx = ((size_t)b * H + h) * Sq + row;
    lse_r[r] = row < Sq ? lse[idx] : 0.f;
    dl[r] = row < Sq ? delta[idx] : 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += TILE) {
    __syncthreads();
    load_rows<TILE, DH>(sK, P, kb, kv0, Sk, kv_stride);
    load_rows<TILE, DH>(sV, P, vb, kv0, Sk, kv_stride);
    __syncthreads();
    float s[R], dp[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = dp[r] = 0.f;
    const float* kj = sK + lane * P;
    const float* vj = sV + lane * P;
    for (int d = 0; d < DH; ++d) {
      const float kd = kj[d], vd = vj[d];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        s[r] = fmaf(qw[r * DH + d], kd, s[r]);
        dp[r] = fmaf(dow[r * DH + d], vd, dp[r]);
      }
    }
    const int col = kv0 + lane;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = row0 + r;
      const bool live = col >= lo && col < hi && (!causal || row >= col);
      const float p = live ? expf(s[r] * scale - lse_r[r]) : 0.f;   // selected
      s[r] = p * (dp[r] - dl[r]) * scale;                              // ds
    }
    for (int j = 0; j < TILE; ++j) {
      float kj2[E];
#pragma unroll
      for (int e = 0; e < E; ++e) kj2[e] = sK[j * P + lane + 32 * e];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float dsj = __shfl_sync(0xffffffffu, s[r], j);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] = fmaf(dsj, kj2[e], acc[r][e]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    if (row >= Sq) continue;
    float* drow = dq + (((size_t)b * Sq + row) * H + h) * DH;
#pragma unroll
    for (int e = 0; e < E; ++e) drow[lane + 32 * e] = acc[r][e];
  }
}

// dk/dv: one CTA per (32-key tile, kv head, batch), warp w owning 4 keys;
// the walk over the group's query heads and the live 32-query tiles, lane
// j computing s^T and dp^T of query j; dV += P^T dO, dK += dS^T Q
template <int DH>
__global__ void __launch_bounds__(THREADS)
f32_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const int* __restrict__ kv_lo, const int* __restrict__ kv_hi,
               float* __restrict__ dk, float* __restrict__ dv, int H, int Hkv, int Sq, int Sk,
               int causal, float scale) {
  using C = F32<DH>;
  constexpr int E = C::E, P = C::P;
  extern __shared__ float smem[];
  float* sK = smem;                  // (BQ keys, DH)
  float* sV = sK + BQ * DH;          // (BQ keys, DH)
  float* sQ = sV + BQ * DH;          // (TILE queries, DH + 1)
  float* sdO = sQ + TILE * P;        // (TILE queries, DH + 1)
  float* sL = sdO + TILE * P;        // lse, then delta, of the tile's queries

  const int hk = blockIdx.x, b = blockIdx.y;
  const int kv0 = blockIdx.z * BQ;   // causal: the longest walks come first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rep = H / Hkv;
  const int lo = kv_lo ? max(kv_lo[b], 0) : 0;
  const int hi = kv_hi ? min(kv_hi[b], Sk) : Sk;
  const bool tile_live = kv0 < hi && kv0 + BQ > lo;
  const int q_begin = causal ? (kv0 / TILE) * TILE : 0;

  const size_t q_stride = (size_t)H * DH, kv_stride = (size_t)Hkv * DH;
  load_rows<BQ, DH>(sK, DH, k + ((size_t)b * Sk * Hkv + hk) * DH, kv0, Sk, kv_stride);
  load_rows<BQ, DH>(sV, DH, v + ((size_t)b * Sk * Hkv + hk) * DH, kv0, Sk, kv_stride);
  const float* kw = sK + warp * R * DH;
  const float* vw = sV + warp * R * DH;
  const int key0 = kv0 + warp * R;
  float dka[R][E], dva[R][E];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < E; ++e) dka[r][e] = dva[r][e] = 0.f;

  for (int g = 0; tile_live && g < rep; ++g) {
    const int hq = hk * rep + g;
    const size_t q_off = ((size_t)b * Sq * H + hq) * DH;
    for (int qt = q_begin; qt < Sq; qt += TILE) {
      __syncthreads();
      load_rows<TILE, DH>(sQ, P, q + q_off, qt, Sq, q_stride);
      load_rows<TILE, DH>(sdO, P, dout + q_off, qt, Sq, q_stride);
      if (threadIdx.x < 2 * TILE) {
        const int c = threadIdx.x & (TILE - 1);
        const size_t idx = ((size_t)b * H + hq) * Sq + qt + c;
        sL[threadIdx.x] = qt + c < Sq ? (threadIdx.x < TILE ? lse[idx] : delta[idx]) : 0.f;
      }
      __syncthreads();
      float s[R], dp[R];
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] = dp[r] = 0.f;
      const float* qj = sQ + lane * P;
      const float* doj = sdO + lane * P;
      for (int d = 0; d < DH; ++d) {
        const float qd = qj[d], dod = doj[d];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          s[r] = fmaf(qd, kw[r * DH + d], s[r]);
          dp[r] = fmaf(dod, vw[r * DH + d], dp[r]);
        }
      }
      const int qq = qt + lane;
      float ds[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int key = key0 + r;
        const bool live = key >= lo && key < hi && qq < Sq && (!causal || qq >= key);
        const float p = live ? expf(s[r] * scale - sL[lane]) : 0.f;   // selected
        ds[r] = p * (dp[r] - sL[TILE + lane]) * scale;
        s[r] = p;
      }
      for (int j = 0; j < TILE; ++j) {
        float qj2[E], doj2[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          qj2[e] = sQ[j * P + lane + 32 * e];
          doj2[e] = sdO[j * P + lane + 32 * e];
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float pj = __shfl_sync(0xffffffffu, s[r], j);
          const float dsj = __shfl_sync(0xffffffffu, ds[r], j);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            dva[r][e] = fmaf(pj, doj2[e], dva[r][e]);
            dka[r][e] = fmaf(dsj, qj2[e], dka[r][e]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int key = key0 + r;
    if (key >= Sk) continue;
    const size_t off = (((size_t)b * Sk + key) * Hkv + hk) * DH;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      dk[off + lane + 32 * e] = dka[r][e];
      dv[off + lane + 32 * e] = dva[r][e];
    }
  }
}

template <typename F>
void set_smem(F* fn, int bytes) {
  cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int DH>
int fwd(const void* q, const void* k, const void* v, const void* lo, const void* hi, void* out,
        void* lse, int B, int H, int Hkv, int Sq, int Sk, int causal, float scale,
        cudaStream_t st) {
  set_smem(f32_fwd_kernel<DH>, F32<DH>::FWD_SMEM);
  dim3 grid(H, B, (Sq + BQ - 1) / BQ);
  f32_fwd_kernel<DH><<<grid, THREADS, F32<DH>::FWD_SMEM, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const int*)lo, (const int*)hi,
      (float*)out, (float*)lse, H, Hkv, Sq, Sk, causal, scale);
  return (int)cudaGetLastError();
}

template <int DH>
int delta(const void* dout, const void* out, const void* g_lse, void* d, int B, int H, int Sq,
          cudaStream_t st) {
  const long rows = (long)B * Sq * H;
  f32_delta_kernel<DH><<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      (const float*)dout, (const float*)out, (const float*)g_lse, (float*)d, H, Sq, rows);
  return (int)cudaGetLastError();
}

template <int DH>
int dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
       const void* dl, const void* lo, const void* hi, void* dq_, int B, int H, int Hkv, int Sq,
       int Sk, int causal, float scale, cudaStream_t st) {
  set_smem(f32_dq_kernel<DH>, F32<DH>::DQ_SMEM);
  dim3 grid(H, B, (Sq + BQ - 1) / BQ);
  f32_dq_kernel<DH><<<grid, THREADS, F32<DH>::DQ_SMEM, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const float*)lse,
      (const float*)dl, (const int*)lo, (const int*)hi, (float*)dq_, H, Hkv, Sq, Sk, causal,
      scale);
  return (int)cudaGetLastError();
}

template <int DH>
int dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
        const void* dl, const void* lo, const void* hi, void* dk, void* dv, int B, int H,
        int Hkv, int Sq, int Sk, int causal, float scale, cudaStream_t st) {
  set_smem(f32_dkv_kernel<DH>, F32<DH>::DKV_SMEM);
  dim3 grid(Hkv, B, (Sk + BQ - 1) / BQ);
  f32_dkv_kernel<DH><<<grid, THREADS, F32<DH>::DKV_SMEM, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const float*)lse,
      (const float*)dl, (const int*)lo, (const int*)hi, (float*)dk, (float*)dv, H, Hkv, Sq, Sk,
      causal, scale);
  return (int)cudaGetLastError();
}

template <typename F>
int resources_of(F* fn, int threads, int smem, int* r) {
  if (smem) set_smem(fn, smem);
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return (int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, threads, smem);
  r[0] = a.numRegs;
  r[1] = (int)a.sharedSizeBytes;
  r[2] = smem;
  r[3] = (int)a.localSizeBytes;
  r[4] = threads;
  r[5] = ctas;
  return (int)err;
}

template <int DH>
int resources(int* r) {
  int err = resources_of(f32_fwd_kernel<DH>, THREADS, F32<DH>::FWD_SMEM, r);
  if (!err) err = resources_of(f32_delta_kernel<DH>, 256, 0, r + 6);
  if (!err) err = resources_of(f32_dq_kernel<DH>, THREADS, F32<DH>::DQ_SMEM, r + 12);
  if (!err) err = resources_of(f32_dkv_kernel<DH>, THREADS, F32<DH>::DKV_SMEM, r + 18);
  return err;
}

}  // namespace

extern "C" {

// The f32 counterparts of flash_fwd_launch, flash_bwd_delta_launch,
// flash_bwd_dq_launch and flash_bwd_dkv_launch, with the same arguments and
// every tensor f32 (DH 128 or 256; another DH returns
// cudaErrorInvalidValue).  Each returns cudaGetLastError().
int flash_f32_fwd_launch(const void* q, const void* k, const void* v, const void* kv_lo,
                         const void* kv_hi, void* out, void* lse, int B, int H, int Hkv,
                         int Sq, int Sk, int DH, int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (DH == 128) return fwd<128>(q, k, v, kv_lo, kv_hi, out, lse, B, H, Hkv, Sq, Sk, causal, scale, st);
  if (DH == 256) return fwd<256>(q, k, v, kv_lo, kv_hi, out, lse, B, H, Hkv, Sq, Sk, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

int flash_f32_bwd_delta_launch(const void* dout, const void* out, const void* g_lse,
                               void* delta_, int B, int H, int Sq, int DH, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (DH == 128) return delta<128>(dout, out, g_lse, delta_, B, H, Sq, st);
  if (DH == 256) return delta<256>(dout, out, g_lse, delta_, B, H, Sq, st);
  return (int)cudaErrorInvalidValue;
}

int flash_f32_bwd_dq_launch(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta_, const void* kv_lo,
                            const void* kv_hi, void* dq_, int B, int H, int Hkv, int Sq, int Sk,
                            int DH, int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (DH == 128)
    return dq<128>(q, k, v, dout, lse, delta_, kv_lo, kv_hi, dq_, B, H, Hkv, Sq, Sk, causal, scale, st);
  if (DH == 256)
    return dq<256>(q, k, v, dout, lse, delta_, kv_lo, kv_hi, dq_, B, H, Hkv, Sq, Sk, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

int flash_f32_bwd_dkv_launch(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta_, const void* kv_lo,
                             const void* kv_hi, void* dk, void* dv, int B, int H, int Hkv,
                             int Sq, int Sk, int DH, int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (DH == 128)
    return dkv<128>(q, k, v, dout, lse, delta_, kv_lo, kv_hi, dk, dv, B, H, Hkv, Sq, Sk, causal, scale, st);
  if (DH == 256)
    return dkv<256>(q, k, v, dout, lse, delta_, kv_lo, kv_hi, dk, dv, B, H, Hkv, Sq, Sk, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

// The four kernels' resources (forward, delta, dq, dk/dv) at DH 128, then at
// DH 256, six ints each (as flash_fwd_resources).  Returns the first CUDA
// error.
int flash_f32_resources(int* res) {
  const int err = resources<128>(res);
  return err ? err : resources<256>(res + 24);
}

}  // extern "C"
