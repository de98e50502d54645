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
// What bounds it on an H100: tensor-core operations (S = 4096, dh = 128:
// ~4 x S / 2 x dh operations per 2 x 3 x dh bytes of Q/K/V rows, far above
// the card's ~295 FLOP/byte balance point).  The design, for Hopper's
// tensor cores (wgmma.cuh):
// - one CTA of two warpgroups per (head, batch, 128-row Q tile); each
//   warpgroup owns 64 query rows, wgmma's M.  Causal Q tiles run longest
//   first (the grid's slowest dimension counts the tiles down);
// - K and V tiles of 128 keys arrive by cp.async into two-stage rings of
//   128-byte-swizzled shared memory (2 x 2 x 32 KB beside a 32 KB Q
//   tile).  128 keys (not 64) halve the barriers and the softmax
//   bookkeeping per key.  One barrier per tile: it publishes the tile
//   that landed and frees the stages of the tile before, whose copies
//   then run beside this tile's products;
// - S = Q K^T by wgmma with the accumulator in registers; the online
//   softmax runs on the accumulator layout (a row spans the four threads
//   of a quad: two shuffles per reduction; exp2 on the SFU with the
//   scale folded in); P rounds to bf16 in registers and is wgmma's
//   register A operand of O += P V, V read MN-major (the transpose bit);
//   O stays in registers and is rescaled there;
// - S of tile j + 1 and O += P_j V_j issue back to back as one batch;
//   the softmax of tile j + 1 then runs while the other warpgroup's batch
//   is on the tensor cores;
// - the mask is evaluated only on tiles that cross the causal diagonal, a
//   window edge or the end of the keys; tiles outside [kv_lo, kv_hi) or
//   above the diagonal are never loaded.
// There is no producer warp: all 256 threads issue the copies, so none
// holds registers the products need (up to 255 a thread, one CTA per SM)
// and no register rebalancing (setmaxnreg) is required.  cp.async rather
// than TMA keeps the kernel free of tensor maps (cuTensorMapEncodeTiled).

// Semantics follow the TPU kernel: logits (q . k) * scale in f32, masked
// to -1e30; p = exp(s - m_new), and 0 for masked logits, so a row whose
// causal-and-window key set is empty outputs 0 (not a uniform average);
// p rounds to the value dtype before the P V product; the output divides
// by l (l == 0 gives 0); lse = m + log(l).  Any sequence length >= 1 works:
// ragged tiles are zero-filled and masked.  No atomics: the same inputs
// give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int DH = 128, BQ = 128, BKV = 128, THREADS = 256;
constexpr int Q_BYTES = BQ * DH * 2;
constexpr int KV_BYTES = BKV * DH * 2;
// Q, then two stages of K and of V; 1024 bytes of slack to align the base
constexpr int SMEM_BYTES = Q_BYTES + 4 * KV_BYTES + 1024;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// S = Q K^T for one warpgroup's 64 rows and one tile of 128 keys, raw
// (unscaled) logits, issued and committed as one wgmma group
// (the first step overwrites s: no instruction but wgmma defines it, so
// ptxas keeps the products asynchronous)
__device__ __forceinline__ void qk_tile(float (&s)[64], uint32_t q_tile, uint32_t k_tile) {
  fence_operands(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_ss_n128(s, desc_kmajor(q_tile, BQ, kk), desc_kmajor(k_tile, BKV, kk), kk > 0);
  wgmma_commit();
  fence_operands(s);
}

// O += P V for one warpgroup: P (64 x 128) as bf16 register A fragments,
// V (128 keys x 128) MN-major; issued and committed as one wgmma group
__device__ __forceinline__ void pv_tile(float (&o)[64], const uint32_t (&pa)[32],
                                        uint32_t v_tile) {
  fence_operands(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
    wgmma_rs_n128(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                  desc_mnmajor(v_tile, BKV, kk));
  wgmma_commit();
  fence_operands(o);
}

// The online softmax of one tile of raw logits, in place: masks (only when
// `masked`), moves the running max m (raw units) and sum l, returns each
// row's rescale factor in alpha and leaves p = exp((s - m) * scale) in s,
// selected to 0 on masked logits
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool masked, int kv0, int row0,
                                             int col0, int lo, int hi, int causal, float c) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int x = 0; x < 64; ++x) {
    if (masked) {
      const int col = kv0 + 8 * (x >> 2) + col0 + (x & 1);
      const int row = row0 + 8 * ((x >> 1) & 1);
      const bool live = col >= lo && col < hi && (!causal || row >= col);
      s[x] = live ? s[x] : NEG_INF;
    }
    mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], s[x]);
  }
  float mneg[2], ps[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    alpha[i] = ex2((m[i] - mx[i]) * c);
    m[i] = mx[i];
    mneg[i] = -mx[i] * c;
  }
#pragma unroll
  for (int x = 0; x < 64; ++x) {
    const int i = (x >> 1) & 1;
    float p = ex2(fmaf(s[x], c, mneg[i]));
    if (masked) p = s[x] > NEG_INF / 2 ? p : 0.f;   // selected, never exp of a mask
    s[x] = p;
    ps[i] += p;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + ps[i];
}

__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ kv_lo,
                 const int* __restrict__ kv_hi, bf16* __restrict__ out,
                 float* __restrict__ lse, int H, int Hkv, int Sq, int Sk, int causal,
                 float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base, sK = base + Q_BYTES, sV = sK + 2 * KV_BYTES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // longest causal tiles first
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int hk = h / (H / Hkv);

  const int lo = kv_lo ? max(kv_lo[b], 0) : 0;
  const int hi = kv_hi ? min(kv_hi[b], Sk) : Sk;
  const int kv_begin = (lo / BKV) * BKV;
  const int kv_end = causal ? min(hi, q0 + BQ) : hi;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV : 0;

  // (B, S, H, D) rows: stride H * D between consecutive positions.  Tile t
  // of K lives in stage t & 1 of the K ring, of V in stage t & 1 of the V
  // ring
  const size_t q_stride = (size_t)H * DH, kv_stride = (size_t)Hkv * DH;
  const bf16* kb = k + ((size_t)b * Sk * Hkv + hk) * DH;
  const bf16* vb = v + ((size_t)b * Sk * Hkv + hk) * DH;
  load_tile<BQ, THREADS>(sQ, q + ((size_t)b * Sq * H + h) * DH, q0, Sq, q_stride, tid);
  if (n_tiles > 0) {
    load_tile<BKV, THREADS>(sK, kb, kv_begin, Sk, kv_stride, tid);
    load_tile<BKV, THREADS>(sV, vb, kv_begin, Sk, kv_stride, tid);
  }
  if (n_tiles > 1)
    load_tile<BKV, THREADS>(sK + KV_BYTES, kb, kv_begin + BKV, Sk, kv_stride, tid);
  cp_async_commit();

  const uint32_t sQw = sQ + wg * 64 * 128;               // this warpgroup's 64 rows
  const int wg_row0 = q0 + wg * 64;
  const int row0 = wg_row0 + warp * 16 + (lane >> 2);    // rows row0 and row0 + 8
  const int col0 = 2 * (lane & 3);
  const float c = scale * LOG2E;
  // a tile needs the mask where it crosses a window edge, the end of the
  // keys or this warpgroup's causal diagonal
  auto masked_at = [&](int kv0) {
    return kv0 < lo || kv0 + BKV > hi || (causal && kv0 + BKV - 1 > wg_row0);
  };

  float o[64], s[64];
#pragma unroll
  for (int x = 0; x < 64; ++x) o[x] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];
  uint32_t pa[32];   // P of the current tile as bf16 register A fragments

  if (n_tiles > 0) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    qk_tile(s, sQw, sK);
    wgmma_wait<0>();
    fence_operands(s);
    softmax_tile(s, m, l, alpha, masked_at(kv_begin), kv_begin, row0, col0, lo, hi, causal, c);
#pragma unroll
    for (int r = 0; r < 32; ++r) pa[r] = pack_bf16(s[2 * r], s[2 * r + 1]);
  }

  // Tile j: S of tile j + 1 and O += P_j V_j issue back to back as one
  // batch, so the tensor cores run them without a gap, and tile j + 1's
  // softmax runs while the other warpgroup's batch is on the tensor
  // cores.  (Starting the softmax as soon as S is done, beside P_j V_j,
  // measured slower on the H100.)  The last tile (O += P V only) is peeled
  // off, so the loop body issues and retires its products unconditionally.
  for (int j = 0; j + 1 < n_tiles; ++j) {
    // K_{j+1} and V_j have landed, and every thread is past tile j - 1:
    // K stage j & 1 (K_j, read by the previous S product) and V stage
    // (j + 1) & 1 (V_{j-1}) are free for the next copies
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    const int kv_next = kv_begin + (j + 1) * BKV;
    if (j + 2 < n_tiles)
      load_tile<BKV, THREADS>(sK + (j & 1) * KV_BYTES, kb, kv_next + BKV, Sk, kv_stride, tid);
    load_tile<BKV, THREADS>(sV + ((j + 1) & 1) * KV_BYTES, vb, kv_next, Sk, kv_stride, tid);
    cp_async_commit();

    qk_tile(s, sQw, sK + ((j + 1) & 1) * KV_BYTES);
    pv_tile(o, pa, sV + (j & 1) * KV_BYTES);
    wgmma_wait<0>();
    fence_operands(s);
    fence_operands(o);
    softmax_tile(s, m, l, alpha, masked_at(kv_next), kv_next, row0, col0, lo, hi, causal, c);
#pragma unroll
    for (int x = 0; x < 64; ++x) o[x] *= alpha[(x >> 1) & 1];
    fence_operands(o);
#pragma unroll
    for (int r = 0; r < 32; ++r) pa[r] = pack_bf16(s[2 * r], s[2 * r + 1]);
  }
  if (n_tiles > 0) {
    cp_async_wait<0>();   // V of the last tile
    fence_proxy_async();
    __syncthreads();
    pv_tile(o, pa, sV + ((n_tiles - 1) & 1) * KV_BYTES);
    wgmma_wait<0>();
    fence_operands(o);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= Sq) continue;
    const float ls = (l[i] == 0.f) ? 1.f : l[i];
    const float inv = 1.f / ls;
    bf16* orow = out + (((size_t)b * Sq + row) * H + h) * DH + col0;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const uint32_t pr = pack_bf16(o[4 * jj + 2 * i] * inv, o[4 * jj + 2 * i + 1] * inv);
      *reinterpret_cast<uint32_t*>(orow + 8 * jj) = pr;
    }
    // m is in raw logit units: lse = m * scale + log(l), and -1e30 + log(1)
    // for a row that saw no live key
    const float ms = m[i] > NEG_INF / 2 ? m[i] * scale : NEG_INF;
    if ((lane & 3) == 0) lse[((size_t)b * H + h) * Sq + row] = ms + logf(ls);
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
  cudaFuncSetAttribute(flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       SMEM_BYTES);
  dim3 grid(H, B, (Sq + BQ - 1) / BQ);
  flash_fwd_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(kv_lo), static_cast<const int*>(kv_hi),
      static_cast<bf16*>(out), static_cast<float*>(lse), H, Hkv, Sq, Sk, causal, scale);
  return (int)cudaGetLastError();
}

// The forward kernel's resources, six ints: registers per thread, static
// shared bytes, dynamic shared bytes, local (spill) bytes per thread,
// threads per CTA, CTAs per SM.  Returns the first CUDA error.
int flash_fwd_resources(int* res) {
  cudaFuncSetAttribute(flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       SMEM_BYTES);
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, flash_fwd_kernel);
  if (err != cudaSuccess) return (int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, flash_fwd_kernel, THREADS,
                                                      SMEM_BYTES);
  res[0] = a.numRegs;
  res[1] = (int)a.sharedSizeBytes;
  res[2] = SMEM_BYTES;
  res[3] = (int)a.localSizeBytes;
  res[4] = THREADS;
  res[5] = ctas;
  return (int)err;
}

}  // extern "C"
