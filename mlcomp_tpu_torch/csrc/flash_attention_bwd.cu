// Flash-attention backward: delta, dq and dk/dv, causal and/or bounded by
// per-row key windows [kv_lo, kv_hi), with GQA.
//
// Replaces the Pallas backward of mlcomp_tpu/ops/pallas/flash_attention.py:
// the delta reduction of `_flash_bwd` (:1042-1051), the rectangular
// `_dq_kernel` / `_dkv_kernel` (:639 / :676), the triangular causal
// `_dq_kernel_tri` / `_dkv_kernel_tri` (:738 / :761) and the compacted
// window schedule `_dq_kernel_bsched` / `_dkv_kernel_bsched` (:787 /
// :813).  On the TPU those are three grid schedules of one computation;
// here each kernel skips dead tiles (above the causal diagonal, outside
// [kv_lo, kv_hi)) inside its own loop, so one implementation serves all
// three.
//
// What bounds it on an H100: tensor-core operations.  Per live (query,
// key) pair and head the backward does five dh-long products (q.k and
// dO.v recomputed, then dq, dk and dv), ~10 dh operations, against ~6 dh
// bytes per row of Q/K/V/dO/dQ/dK/dV: at S = 4096 several hundred
// operations per byte, far above the card's ~295 balance point.
//
// The design (the simple first cut, like the forward's): tiles of 64
// queries and 64 keys in shared memory; bf16 WMMA products with f32
// accumulation; synchronous loads; no warp specialisation.
// - dq: one CTA of 4 warps per (64-row Q tile, head, batch).  It loops
//   over the live K/V tiles, recomputes s = (q k^T) * scale and dp =
//   dO v^T, forms ds = p (dp - delta) * scale in f32, rounds ds to bf16
//   and accumulates dq += ds k in registers (f32).
// - dk/dv: one CTA per (64-key tile, kv head, batch).  It loops over the
//   G query heads of the group and the live Q tiles (from the diagonal
//   when causal), rounds p to bf16 before dv += p^T dO and ds to bf16
//   before dk += ds^T q, with the sums in f32 shared memory.  One CTA owns
//   a key tile's whole sum, so dk and dv need no atomics and come out the
//   same on every run; this is the TPU's sequential pass over
//   (group x q blocks) at flash_attention.py:1100-1140.
// - delta: one warp per (batch, position, head) row: sum_d dO * O in f32,
//   minus the lse cotangent when one is given (ring attention's path).
//
// Semantics follow `_dq_update` / `_dkv_update` (:613 / :626): p =
// exp(s - lse), SELECTED to 0 where the logit is masked (a row whose
// causal-and-window key set is empty carries lse = -1e30 and must give
// zero gradients, never exp of garbage); ragged tiles are zero-filled and
// masked; rows past Sq and keys past Sk are never written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64, BKV = 64, DH = 128, THREADS = 128;
constexpr int LD = DH + 8;         // bf16 tile row stride (Q, dO, K, V)
constexpr int S_LD = 64 + 4;       // f32 score / dp row stride
constexpr int P_LD = 64 + 8;       // bf16 p / ds row stride
constexpr int A_LD = DH + 4;       // f32 accumulator row stride

constexpr int TILE_BYTES = 64 * LD * 2;
constexpr int SCORE_BYTES = 64 * S_LD * 4;
constexpr int PROB_BYTES = 64 * P_LD * 2;
constexpr int ACC_BYTES = 64 * A_LD * 4;

// dq: Q, dO, K, V tiles; s and dp; ds; lse and delta rows
constexpr int DQ_SMEM = 4 * TILE_BYTES + 2 * SCORE_BYTES + PROB_BYTES + 2 * 64 * 4;
// dk/dv: K, V, Q, dO tiles; s^T and dp^T; p^T and ds^T; dK and dV sums;
// lse and delta of the Q tile
constexpr int DKV_SMEM = 4 * TILE_BYTES + 2 * SCORE_BYTES + 2 * PROB_BYTES + 2 * ACC_BYTES +
                         2 * 64 * 4;
static_assert(2 * TILE_BYTES >= ACC_BYTES, "dq staging reuses the K and V tiles");

__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* __restrict__ src,
                                          int row0, int nrows, size_t row_stride) {
  // 64 rows x 128 bf16 = 1024 16-byte chunks; 8 per thread; rows past
  // nrows are zero-filled
  for (int i = threadIdx.x; i < 64 * (DH / 8); i += THREADS) {
    const int r = i / (DH / 8);
    const int c = (i % (DH / 8)) * 8;
    int4 v = make_int4(0, 0, 0, 0);
    if (row0 + r < nrows)
      v = __ldg(reinterpret_cast<const int4*>(src + (size_t)(row0 + r) * row_stride + c));
    *reinterpret_cast<int4*>(dst + r * LD + c) = v;
  }
}

__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const __nv_bfloat16* __restrict__ dout,
                       const __nv_bfloat16* __restrict__ out,
                       const float* __restrict__ g_lse,
                       float* __restrict__ delta, int H, int Sq, long rows) {
  // one warp per (b, i, h) row of the (B, Sq, H, 128) tensors
  const long row = (long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const __nv_bfloat16* a = dout + row * DH + lane * 4;
  const __nv_bfloat16* o = out + row * DH + lane * 4;
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) s += __bfloat162float(a[e]) * __bfloat162float(o[e]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = (int)(row % H);
    const long bi = row / H;
    const int i = (int)(bi % Sq);
    const long b = bi / Sq;
    const long idx = (b * H + h) * Sq + i;     // (B, H, Sq)
    delta[idx] = g_lse ? s - g_lse[idx] : s;
  }
}

__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ kv_lo,
                    const int* __restrict__ kv_hi,
                    __nv_bfloat16* __restrict__ dq,
                    int H, int Hkv, int Sq, int Sk, int causal, float scale) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dOs = Qs + 64 * LD;
  __nv_bfloat16* Ks = dOs + 64 * LD;
  __nv_bfloat16* Vs = Ks + 64 * LD;
  float* Ss = reinterpret_cast<float*>(Vs + 64 * LD);
  float* dPs = Ss + 64 * S_LD;
  __nv_bfloat16* dSs = reinterpret_cast<__nv_bfloat16*>(dPs + 64 * S_LD);
  float* lse_s = reinterpret_cast<float*>(dSs + 64 * P_LD);
  float* dl_s = lse_s + 64;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wr = warp * 16;     // this warp's 16 query rows of the tile

  const int lo = kv_lo ? max(kv_lo[b], 0) : 0;
  const int hi = kv_hi ? min(kv_hi[b], Sk) : Sk;
  int kv_end = hi;
  if (causal) kv_end = min(kv_end, q0 + BQ);

  const size_t qrow = (size_t)H * DH, krow = (size_t)Hkv * DH;
  load_tile(Qs, q + ((size_t)b * Sq * H + h) * DH, q0, Sq, qrow);
  load_tile(dOs, dout + ((size_t)b * Sq * H + h) * DH, q0, Sq, qrow);
  if (threadIdx.x < BQ) {
    const int i = q0 + threadIdx.x;
    const size_t idx = ((size_t)b * H + h) * Sq + i;
    lse_s[threadIdx.x] = i < Sq ? lse[idx] : 0.f;
    dl_s[threadIdx.x] = i < Sq ? delta[idx] : 0.f;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[DH / 16];
#pragma unroll
  for (int n = 0; n < DH / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  const __nv_bfloat16* kbase = k + ((size_t)b * Sk * Hkv + hk) * DH;
  const __nv_bfloat16* vbase = v + ((size_t)b * Sk * Hkv + hk) * DH;

  for (int kv0 = (lo / BKV) * BKV; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();
    load_tile(Ks, kbase, kv0, Sk, krow);
    load_tile(Vs, vbase, kv0, Sk, krow);
    __syncthreads();

    // s = Q K^T and dp = dO V^T for this warp's rows
#pragma unroll
    for (int n = 0; n < BKV / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc, pacc;
      wmma::fill_fragment(sacc, 0.f);
      wmma::fill_fragment(pacc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bt;
        wmma::load_matrix_sync(a, Qs + wr * LD + kk * 16, LD);
        wmma::load_matrix_sync(bt, Ks + n * 16 * LD + kk * 16, LD);
        wmma::mma_sync(sacc, a, bt, sacc);
        wmma::load_matrix_sync(a, dOs + wr * LD + kk * 16, LD);
        wmma::load_matrix_sync(bt, Vs + n * 16 * LD + kk * 16, LD);
        wmma::mma_sync(pacc, a, bt, pacc);
      }
      wmma::store_matrix_sync(Ss + wr * S_LD + n * 16, sacc, S_LD, wmma::mem_row_major);
      wmma::store_matrix_sync(dPs + wr * S_LD + n * 16, pacc, S_LD, wmma::mem_row_major);
    }
    __syncwarp();

    // ds = p (dp - delta) * scale, p selected to 0 on masked logits
    for (int r = 0; r < 16; ++r) {
      const int row = wr + r;
      const int qpos = q0 + row;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = lane + 32 * e;
        const int key = kv0 + c;
        const bool live = qpos < Sq && key >= lo && key < hi && (!causal || qpos >= key);
        const float s = Ss[row * S_LD + c] * scale;
        const float p = live ? expf(s - lse_s[row]) : 0.f;
        const float ds = p * (dPs[row * S_LD + c] - dl_s[row]) * scale;
        dSs[row * P_LD + c] = __float2bfloat16(ds);
      }
    }
    __syncwarp();

    // dq += ds K
#pragma unroll
    for (int n = 0; n < DH / 16; ++n) {
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bk;
        wmma::load_matrix_sync(a, dSs + wr * P_LD + kk * 16, P_LD);
        wmma::load_matrix_sync(bk, Ks + kk * 16 * LD + n * 16, LD);
        wmma::mma_sync(acc[n], a, bk, acc[n]);
      }
    }
  }
  __syncthreads();

  // stage the f32 sums through the (now free) K/V tiles, write bf16 rows
  float* stage = reinterpret_cast<float*>(Ks);
#pragma unroll
  for (int n = 0; n < DH / 16; ++n)
    wmma::store_matrix_sync(stage + wr * A_LD + n * 16, acc[n], A_LD, wmma::mem_row_major);
  __syncwarp();
  for (int r = 0; r < 16; ++r) {
    const int qpos = q0 + wr + r;
    if (qpos >= Sq) break;
    __nv_bfloat16* drow = dq + (((size_t)b * Sq + qpos) * H + h) * DH;
    for (int c = lane; c < DH; c += 32) drow[c] = __float2bfloat16(stage[(wr + r) * A_LD + c]);
  }
}

__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ kv_lo,
                     const int* __restrict__ kv_hi,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv,
                     int H, int Hkv, int Sq, int Sk, int causal, float scale) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + 64 * LD;
  __nv_bfloat16* Qs = Vs + 64 * LD;
  __nv_bfloat16* dOs = Qs + 64 * LD;
  float* St = reinterpret_cast<float*>(dOs + 64 * LD);
  float* dPt = St + 64 * S_LD;
  __nv_bfloat16* Pt = reinterpret_cast<__nv_bfloat16*>(dPt + 64 * S_LD);
  __nv_bfloat16* dSt = Pt + 64 * P_LD;
  float* dKa = reinterpret_cast<float*>(dSt + 64 * P_LD);
  float* dVa = dKa + 64 * A_LD;
  float* lse_s = dVa + 64 * A_LD;
  float* dl_s = lse_s + 64;

  const int kv0 = blockIdx.x * BKV;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = H / Hkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wk = warp * 16;     // this warp's 16 keys of the tile

  const int lo = kv_lo ? max(kv_lo[b], 0) : 0;
  const int hi = kv_hi ? min(kv_hi[b], Sk) : Sk;
  // a tile with no key inside [lo, hi) gets no live pair: its dk, dv are 0
  const bool tile_live = kv0 < hi && kv0 + BKV > lo;

  const size_t qrow = (size_t)H * DH, krow = (size_t)Hkv * DH;
  for (int i = threadIdx.x; i < 64 * A_LD; i += THREADS) {
    dKa[i] = 0.f;
    dVa[i] = 0.f;
  }
  if (tile_live) {
    load_tile(Ks, k + ((size_t)b * Sk * Hkv + hk) * DH, kv0, Sk, krow);
    load_tile(Vs, v + ((size_t)b * Sk * Hkv + hk) * DH, kv0, Sk, krow);
  }
  // causal: query tiles wholly above this key tile's diagonal are dead
  const int q_begin = tile_live ? (causal ? (kv0 / BQ) * BQ : 0) : Sq;

  for (int g = 0; g < rep; ++g) {
    const int h = hk * rep + g;
    const __nv_bfloat16* qbase = q + ((size_t)b * Sq * H + h) * DH;
    const __nv_bfloat16* dobase = dout + ((size_t)b * Sq * H + h) * DH;
    for (int q0 = q_begin; q0 < Sq; q0 += BQ) {
      __syncthreads();
      load_tile(Qs, qbase, q0, Sq, qrow);
      load_tile(dOs, dobase, q0, Sq, qrow);
      if (threadIdx.x < BQ) {
        const int i = q0 + threadIdx.x;
        const size_t idx = ((size_t)b * H + h) * Sq + i;
        lse_s[threadIdx.x] = i < Sq ? lse[idx] : 0.f;
        dl_s[threadIdx.x] = i < Sq ? delta[idx] : 0.f;
      }
      __syncthreads();

      // s^T = K Q^T and dp^T = V dO^T for this warp's keys
#pragma unroll
      for (int n = 0; n < BQ / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc, pacc;
        wmma::fill_fragment(sacc, 0.f);
        wmma::fill_fragment(pacc, 0.f);
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bt;
          wmma::load_matrix_sync(a, Ks + wk * LD + kk * 16, LD);
          wmma::load_matrix_sync(bt, Qs + n * 16 * LD + kk * 16, LD);
          wmma::mma_sync(sacc, a, bt, sacc);
          wmma::load_matrix_sync(a, Vs + wk * LD + kk * 16, LD);
          wmma::load_matrix_sync(bt, dOs + n * 16 * LD + kk * 16, LD);
          wmma::mma_sync(pacc, a, bt, pacc);
        }
        wmma::store_matrix_sync(St + wk * S_LD + n * 16, sacc, S_LD, wmma::mem_row_major);
        wmma::store_matrix_sync(dPt + wk * S_LD + n * 16, pacc, S_LD, wmma::mem_row_major);
      }
      __syncwarp();

      // p^T and ds^T, each rounded to bf16 for its product
      for (int r = 0; r < 16; ++r) {
        const int row = wk + r;
        const int key = kv0 + row;
        const bool key_live = key >= lo && key < hi;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = lane + 32 * e;
          const int qpos = q0 + c;
          const bool live = key_live && qpos < Sq && (!causal || qpos >= key);
          const float s = St[row * S_LD + c] * scale;
          const float p = live ? expf(s - lse_s[c]) : 0.f;
          const float ds = p * (dPt[row * S_LD + c] - dl_s[c]) * scale;
          Pt[row * P_LD + c] = __float2bfloat16(p);
          dSt[row * P_LD + c] = __float2bfloat16(ds);
        }
      }
      __syncwarp();

      // dv += p^T dO and dk += ds^T Q, sums in shared memory
#pragma unroll
      for (int n = 0; n < DH / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> va, ka;
        wmma::load_matrix_sync(va, dVa + wk * A_LD + n * 16, A_LD, wmma::mem_row_major);
        wmma::load_matrix_sync(ka, dKa + wk * A_LD + n * 16, A_LD, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bm;
          wmma::load_matrix_sync(a, Pt + wk * P_LD + kk * 16, P_LD);
          wmma::load_matrix_sync(bm, dOs + kk * 16 * LD + n * 16, LD);
          wmma::mma_sync(va, a, bm, va);
          wmma::load_matrix_sync(a, dSt + wk * P_LD + kk * 16, P_LD);
          wmma::load_matrix_sync(bm, Qs + kk * 16 * LD + n * 16, LD);
          wmma::mma_sync(ka, a, bm, ka);
        }
        wmma::store_matrix_sync(dVa + wk * A_LD + n * 16, va, A_LD, wmma::mem_row_major);
        wmma::store_matrix_sync(dKa + wk * A_LD + n * 16, ka, A_LD, wmma::mem_row_major);
      }
    }
  }
  __syncthreads();

  for (int r = 0; r < 16; ++r) {
    const int key = kv0 + wk + r;
    if (key >= Sk) break;
    const size_t off = (((size_t)b * Sk + key) * Hkv + hk) * DH;
    for (int c = lane; c < DH; c += 32) {
      dk[off + c] = __float2bfloat16(dKa[(wk + r) * A_LD + c]);
      dv[off + c] = __float2bfloat16(dVa[(wk + r) * A_LD + c]);
    }
  }
}

}  // namespace

extern "C" {

// dout/out (B, Sq, H, 128) bf16; g_lse (B, H, Sq) f32 or null; delta
// (B, H, Sq) f32.  Returns cudaGetLastError().
int flash_bwd_delta_launch(const void* dout, const void* out, const void* g_lse,
                           void* delta, int B, int H, int Sq, void* stream) {
  const long rows = (long)B * Sq * H;
  const unsigned blocks = (unsigned)((rows + 7) / 8);
  flash_bwd_delta_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(dout), static_cast<const __nv_bfloat16*>(out),
      static_cast<const float*>(g_lse), static_cast<float*>(delta), H, Sq, rows);
  return (int)cudaGetLastError();
}

// q/dout (B, Sq, H, 128) bf16; k/v (B, Sk, Hkv, 128) bf16; lse/delta
// (B, H, Sq) f32; kv_lo/kv_hi (B,) int32 or null; dq (B, Sq, H, 128) bf16.
int flash_bwd_dq_launch(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, const void* kv_lo,
                        const void* kv_hi, void* dq, int B, int H, int Hkv, int Sq, int Sk,
                        int causal, float scale, void* stream) {
  cudaFuncSetAttribute(flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       DQ_SMEM);
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_bwd_dq_kernel<<<grid, THREADS, DQ_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(kv_lo), static_cast<const int*>(kv_hi),
      static_cast<__nv_bfloat16*>(dq), H, Hkv, Sq, Sk, causal, scale);
  return (int)cudaGetLastError();
}

// as above; dk/dv (B, Sk, Hkv, 128) bf16, summed over the G = H / Hkv
// query heads of each kv head.
int flash_bwd_dkv_launch(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, const void* kv_lo,
                         const void* kv_hi, void* dk, void* dv, int B, int H, int Hkv, int Sq,
                         int Sk, int causal, float scale, void* stream) {
  cudaFuncSetAttribute(flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       DKV_SMEM);
  dim3 grid((Sk + BKV - 1) / BKV, Hkv, B);
  flash_bwd_dkv_kernel<<<grid, THREADS, DKV_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(kv_lo), static_cast<const int*>(kv_hi),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H, Hkv, Sq, Sk,
      causal, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
