// Flash-attention forward (blocked online softmax), causal and/or bounded
// by per-row key windows [kv_lo, kv_hi), with GQA.
//
// Replaces the Pallas forward kernels of
// mlcomp_tpu/ops/pallas/flash_attention.py: `_fwd_kernel` (rectangular
// grid, launched by `_flash_fwd` through `_maybe_bounded_call`),
// `_fwd_kernel_tri` (the triangular causal schedule, `_flash_fwd_tri`) and
// `_fwd_kernel_bsched` (the compacted window schedule,
// `_flash_fwd_bsched`).  On the TPU those three are grid schedules of one
// computation; here one kernel skips dead tiles inside its own loop, so
// there is no separate schedule.
//
// What bounds it on an H100: tensor-core operations at prefill (S = 512,
// dh = 128: ~64 FLOPs per byte of Q/K/V, far above the card's ~295
// FLOP/byte balance point).  The design: one CTA of 4 warps per (batch,
// head, 64-row Q tile); K/V tiles of 64 keys stage through shared memory;
// Q K^T and P V run as bf16 WMMA products with f32 accumulation; the
// running max and sum live in shared memory beside an f32 output tile.
// Tiles above the causal diagonal or outside [kv_lo, kv_hi) are never
// loaded.  This is the simple first cut (synchronous loads, WMMA through
// shared memory, no warp specialisation).
//
// Semantics follow the TPU kernel: logits (q . k) * scale in f32, masked
// to -1e30; p = exp(s - m_new), and 0 for masked logits, so a row whose
// causal-and-window key set is empty outputs 0 (not a uniform average);
// p rounds to the value dtype before the P V product; the output divides
// by l (l == 0 gives 0); lse = m + log(l).  Any sequence length >= 1 works:
// ragged tiles are zero-filled and masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64, BKV = 64, DH = 128, THREADS = 128;
constexpr int QK_LD = DH + 8;      // bf16, Q/K/V tile row stride
constexpr int S_LD = BKV + 4;      // f32 logits row stride
constexpr int P_LD = BKV + 8;      // bf16 probabilities row stride
constexpr int O_LD = DH + 4;       // f32 output row stride
constexpr float NEG_INF = -1e30f;

constexpr int SMEM_BYTES = 3 * BQ * QK_LD * 2 + BQ * S_LD * 4 + BQ * P_LD * 2 +
                           BQ * O_LD * 4 + 3 * BQ * 4;

__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* __restrict__ src,
                                          int row0, int nrows, size_t row_stride) {
  // 64 rows x 128 bf16 = 1024 16-byte chunks; 8 per thread
  for (int i = threadIdx.x; i < BQ * (DH / 8); i += THREADS) {
    const int r = i / (DH / 8);
    const int c = (i % (DH / 8)) * 8;
    int4 v = make_int4(0, 0, 0, 0);
    if (row0 + r < nrows) v = __ldg(reinterpret_cast<const int4*>(src + (size_t)(row0 + r) * row_stride + c));
    *reinterpret_cast<int4*>(dst + r * QK_LD + c) = v;
  }
}

__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ kv_lo,
                 const int* __restrict__ kv_hi,
                 __nv_bfloat16* __restrict__ out,
                 float* __restrict__ lse,
                 int H, int Hkv, int Sq, int Sk, int causal, float scale) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + BQ * QK_LD;
  __nv_bfloat16* Vs = Ks + BKV * QK_LD;
  float* Ss = reinterpret_cast<float*>(Vs + BKV * QK_LD);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(Ss + BQ * S_LD);
  float* Os = reinterpret_cast<float*>(Ps + BQ * P_LD);
  float* mrow = Os + BQ * O_LD;
  float* lrow = mrow + BQ;
  float* arow = lrow + BQ;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const int lo = kv_lo ? max(kv_lo[b], 0) : 0;
  const int hi = kv_hi ? min(kv_hi[b], Sk) : Sk;
  int kv_end = hi;
  if (causal) kv_end = min(kv_end, q0 + BQ);

  // (B, S, H, D) rows: stride H * D between consecutive positions
  load_tile(Qs, q + ((size_t)b * Sq * H + h) * DH, q0, Sq, (size_t)H * DH);
  for (int i = threadIdx.x; i < BQ * O_LD; i += THREADS) Os[i] = 0.f;
  if (threadIdx.x < BQ) {
    mrow[threadIdx.x] = NEG_INF;
    lrow[threadIdx.x] = 0.f;
  }

  const __nv_bfloat16* kbase = k + ((size_t)b * Sk * Hkv + hk) * DH;
  const __nv_bfloat16* vbase = v + ((size_t)b * Sk * Hkv + hk) * DH;
  const int wr = warp * 16;   // this warp's 16 query rows of the tile

  for (int kv0 = (lo / BKV) * BKV; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();
    load_tile(Ks, kbase, kv0, Sk, (size_t)Hkv * DH);
    load_tile(Vs, vbase, kv0, Sk, (size_t)Hkv * DH);
    __syncthreads();

    // S = Q K^T for this warp's rows
#pragma unroll
    for (int n = 0; n < BKV / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc;
      wmma::fill_fragment(sacc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bk;
        wmma::load_matrix_sync(a, Qs + wr * QK_LD + kk * 16, QK_LD);
        wmma::load_matrix_sync(bk, Ks + n * 16 * QK_LD + kk * 16, QK_LD);
        wmma::mma_sync(sacc, a, bk, sacc);
      }
      wmma::store_matrix_sync(Ss + wr * S_LD + n * 16, sacc, S_LD, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax, one row at a time across the warp (2 keys per lane)
    for (int r = 0; r < 16; ++r) {
      const int row = wr + r;
      const int qpos = q0 + row;
      float s[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = lane + 32 * e;
        const int key = kv0 + c;
        const bool live = key >= lo && key < hi && (!causal || qpos >= key);
        s[e] = live ? Ss[row * S_LD + c] * scale : NEG_INF;
      }
      float mx = fmaxf(s[0], s[1]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = mrow[row];
      const float m_new = fmaxf(m_old, mx);
      float p[2], ps = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[e] = (s[e] > NEG_INF / 2) ? expf(s[e] - m_new) : 0.f;
        ps += p[e];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
      const float alpha = expf(m_old - m_new);
      __syncwarp();
      if (lane == 0) {
        lrow[row] = alpha * lrow[row] + ps;
        mrow[row] = m_new;
        arow[row] = alpha;
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) Ps[row * P_LD + lane + 32 * e] = __float2bfloat16(p[e]);
#pragma unroll
      for (int c = lane; c < DH; c += 32) Os[row * O_LD + c] *= alpha;
    }
    __syncwarp();

    // O += P V for this warp's rows
#pragma unroll
    for (int n = 0; n < DH / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc;
      wmma::load_matrix_sync(oacc, Os + wr * O_LD + n * 16, O_LD, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, Ps + wr * P_LD + kk * 16, P_LD);
        wmma::load_matrix_sync(bv, Vs + kk * 16 * QK_LD + n * 16, QK_LD);
        wmma::mma_sync(oacc, a, bv, oacc);
      }
      wmma::store_matrix_sync(Os + wr * O_LD + n * 16, oacc, O_LD, wmma::mem_row_major);
    }
    __syncwarp();
  }
  __syncthreads();

  for (int r = 0; r < 16; ++r) {
    const int row = wr + r;
    const int qpos = q0 + row;
    if (qpos >= Sq) break;
    const float l = lrow[row];
    const float ls = (l == 0.f) ? 1.f : l;
    __nv_bfloat16* orow = out + (((size_t)b * Sq + qpos) * H + h) * DH;
    for (int c = lane; c < DH; c += 32) orow[c] = __float2bfloat16(Os[row * O_LD + c] / ls);
    if (lane == 0) lse[((size_t)b * H + h) * Sq + qpos] = mrow[row] + logf(ls);
  }
}

}  // namespace

extern "C" {

// q (B, Sq, H, 128) bf16; k/v (B, Sk, Hkv, 128) bf16; kv_lo/kv_hi (B,)
// int32 or null; out (B, Sq, H, 128) bf16; lse (B, H, Sq) f32.  causal
// needs Sq == Sk.  Returns cudaGetLastError().
int flash_fwd_launch(const void* q, const void* k, const void* v,
                     const void* kv_lo, const void* kv_hi, void* out, void* lse,
                     int B, int H, int Hkv, int Sq, int Sk, int causal,
                     float scale, void* stream) {
  cudaFuncSetAttribute(flash_fwd_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(kv_lo),
      static_cast<const int*>(kv_hi), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), H, Hkv, Sq, Sk, causal, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
