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
// operations per byte, far above the card's ~295 balance point.  The
// split into a dq kernel and a dk/dv kernel recomputes s and dp in both
// (7 tile products where the bound counts 5) and buys determinism: no f32
// atomics, the same inputs give the same bits.
//
// The design, for Hopper's tensor cores (wgmma.cuh): every product is a
// wgmma with its accumulator in registers; operand tiles arrive by
// cp.async into rings of 128-byte-swizzled shared memory, one barrier per
// tile publishing the tile that landed and freeing the stages of the one
// before, whose copies then run beside this tile's products; the mask is
// evaluated only on tiles that cross the diagonal, a window edge or the
// end of the sequence.  No producer warp: all 256 threads issue the
// copies, so each consumer thread may hold up to 255 registers (one CTA
// per SM) without register rebalancing (setmaxnreg).
// - dq: one CTA of two warpgroups per (head, batch, 128-row Q tile), 64
//   rows each, longest causal tiles first.  Q and dO stay in shared
//   memory; K/V tiles of 64 keys stream through a three-stage K ring (a
//   K tile feeds two products one tile apart) and a two-stage V ring.
//   s = Q K^T and dp = dO V^T of tile j + 1 run on the tensor cores
//   beside dQ += dS_j K_j, and tile j + 1's ds = p (dp - delta) * scale
//   forms in registers while that product is in flight; ds rounds to
//   bf16 and is the register A operand of dQ += dS K, K read MN-major.
//   64-key tiles keep dQ (64 registers), s and dp (32 each) and two dS
//   operands in registers.
// - dk/dv: one CTA of two warpgroups per (64-key tile, kv head, batch).
//   K and V stay in shared memory; the walk over the G query heads of
//   the group and the live 64-query blocks (from the diagonal when
//   causal) is dealt out alternately to the two warpgroups, each with its
//   own two-stage ring of Q, dO, lse and delta and its own named barrier,
//   so the two drift apart and one's exp and ds overlap the other's
//   products.  s^T = K Q^T and dp^T = V dO^T by wgmma as two groups: p^T
//   forms while dp^T runs, ds^T while dV += P^T dO runs; p^T and ds^T
//   round to bf16 and are the register A operands of dV += P^T dO and
//   dK += dS^T Q, dO and Q read MN-major.  dK and dV accumulate in
//   registers across the whole walk; at the end the two warpgroups' sums
//   add through shared memory once, in a fixed order.  64-key tiles put
//   4 x Sk / 64 x B CTAs on the card for a GQA group of 4 (512 at
//   2 x 4096 on 4 kv heads: ~3.9 per SM).
// - delta: one warp per (batch, position, head) row: sum_d dO * O in f32,
//   minus the lse cotangent when one is given (ring attention's path).
//
// Semantics follow `_dq_update` / `_dkv_update` (:613 / :626): p =
// exp(s - lse), SELECTED to 0 where the logit is masked (a row whose
// causal-and-window key set is empty carries lse = -1e30 and must give
// zero gradients, never exp of garbage); ds rounds to bf16 before dq +=
// ds k and dk += ds^T q, p before dv += p^T dO; ragged tiles are
// zero-filled and masked; rows past Sq and keys past Sk are never written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int DH = 128, THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

// dq: Q and dO (128 rows), then three stages of K and two of V (64 keys):
// a K tile is read by two products one tile apart
constexpr int DQ_BQ = 128, DQ_BKV = 64, DQ_K_STAGES = 3;
constexpr int DQ_Q_BYTES = DQ_BQ * DH * 2, DQ_KV_BYTES = DQ_BKV * DH * 2;
constexpr int DQ_SMEM = 2 * DQ_Q_BYTES + (DQ_K_STAGES + 2) * DQ_KV_BYTES + 1024;

// dk/dv: K and V (64 keys), then for each warpgroup a two-stage ring of
// 64-query blocks (Q, dO, lse and delta); the final cross-warpgroup sum
// reuses the rings
constexpr int DKV_BKV = 64, DKV_BQ = 64;
constexpr int DKV_KV_BYTES = DKV_BKV * DH * 2, DKV_Q_BYTES = DKV_BQ * DH * 2;
constexpr int DKV_STAGE = 33 * 1024;   // 2 x 16 KB of Q and dO, 2 x 256 B of lse and delta
constexpr int DKV_SMEM = 2 * DKV_KV_BYTES + 4 * DKV_STAGE + 1024;
static_assert(2 * DKV_Q_BYTES + 2 * DKV_BQ * 4 <= DKV_STAGE, "a block fits its stage");
static_assert(4 * DKV_STAGE >= 2 * 64 * DH * 4, "the dK/dV sum fits in the rings");

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

// s = Q K^T and dp = dO V^T of one warpgroup's 64 rows against one tile of
// 64 keys, raw (unscaled) logits, issued and committed as one wgmma group
// (the first steps overwrite s and dp: no instruction but wgmma defines
// them, so ptxas keeps the products asynchronous)
__device__ __forceinline__ void dq_scores(float (&s)[32], float (&dp)[32], uint32_t q_tile,
                                          uint32_t do_tile, uint32_t k_tile, uint32_t v_tile) {
  fence_operands(s);
  fence_operands(dp);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_ss_n64(s, desc_kmajor(q_tile, DQ_BQ, kk), desc_kmajor(k_tile, DQ_BKV, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_ss_n64(dp, desc_kmajor(do_tile, DQ_BQ, kk), desc_kmajor(v_tile, DQ_BKV, kk), kk > 0);
  wgmma_commit();
  fence_operands(s);
  fence_operands(dp);
}

// dQ += dS K for one warpgroup: dS (64 x 64) as bf16 register A
// fragments, K (64 keys x 128) MN-major; issued and committed as one group
__device__ __forceinline__ void ds_k_tile(float (&acc)[64], const uint32_t (&da)[16],
                                          uint32_t k_tile) {
  fence_operands(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DQ_BKV / 16; ++kk)
    wgmma_rs_n128(acc, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3],
                  desc_mnmajor(k_tile, DQ_BKV, kk));
  wgmma_commit();
  fence_operands(acc);
}

// ds = p (dp - delta) * scale in place of s, p = exp(s * scale - lse)
// selected to 0 on masked logits (the mask only when `masked`)
__device__ __forceinline__ void dq_ds(float (&s)[32], const float (&dp)[32], bool masked,
                                      int kv0, int row0, int col0, int lo, int hi, int causal,
                                      float c, const float (&nl2)[2], const float (&dl)[2],
                                      float scale) {
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    const int i = (x >> 1) & 1;
    float p = ex2(fmaf(s[x], c, nl2[i]));
    if (masked) {
      const int col = kv0 + 8 * (x >> 2) + col0 + (x & 1);
      const int row = row0 + 8 * i;
      const bool live = col >= lo && col < hi && (!causal || row >= col);
      p = live ? p : 0.f;   // selected, never exp of a masked logit
    }
    s[x] = p * (dp[x] - dl[i]) * scale;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ kv_lo, const int* __restrict__ kv_hi,
                    bf16* __restrict__ dq, int H, int Hkv, int Sq, int Sk, int causal,
                    float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  // tile t of K lives in stage t % 3 of the K ring, of V in stage t % 2
  const uint32_t sQ = base, sdO = base + DQ_Q_BYTES;
  const uint32_t sK = base + 2 * DQ_Q_BYTES, sV = sK + DQ_K_STAGES * DQ_KV_BYTES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * DQ_BQ;   // longest causal tiles first
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int hk = h / (H / Hkv);

  const int lo = kv_lo ? max(kv_lo[b], 0) : 0;
  const int hi = kv_hi ? min(kv_hi[b], Sk) : Sk;
  const int kv_begin = (lo / DQ_BKV) * DQ_BKV;
  const int kv_end = causal ? min(hi, q0 + DQ_BQ) : hi;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + DQ_BKV - 1) / DQ_BKV : 0;

  const size_t q_stride = (size_t)H * DH, kv_stride = (size_t)Hkv * DH;
  const size_t q_off = ((size_t)b * Sq * H + h) * DH;
  const bf16* kb = k + ((size_t)b * Sk * Hkv + hk) * DH;
  const bf16* vb = v + ((size_t)b * Sk * Hkv + hk) * DH;
  auto load_kv = [&](int t) {
    const int kv0 = kv_begin + t * DQ_BKV;
    load_tile<DQ_BKV, THREADS>(sK + (t % DQ_K_STAGES) * DQ_KV_BYTES, kb, kv0, Sk, kv_stride,
                               tid);
    load_tile<DQ_BKV, THREADS>(sV + (t & 1) * DQ_KV_BYTES, vb, kv0, Sk, kv_stride, tid);
  };
  load_tile<DQ_BQ, THREADS>(sQ, q + q_off, q0, Sq, q_stride, tid);
  load_tile<DQ_BQ, THREADS>(sdO, dout + q_off, q0, Sq, q_stride, tid);
  if (n_tiles > 0) load_kv(0);
  if (n_tiles > 1) load_kv(1);
  cp_async_commit();

  const uint32_t sQw = sQ + wg * 64 * 128, sdOw = sdO + wg * 64 * 128;
  const int wg_row0 = q0 + wg * 64;
  const int row0 = wg_row0 + warp * 16 + (lane >> 2);    // rows row0 and row0 + 8
  const int col0 = 2 * (lane & 3);
  const float c = scale * LOG2E;
  float nl2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const size_t idx = ((size_t)b * H + h) * Sq + row;
    nl2[i] = row < Sq ? -lse[idx] * LOG2E : 0.f;
    dl[i] = row < Sq ? delta[idx] : 0.f;
  }
  // a tile needs the mask where it crosses a window edge, the end of the
  // keys or this warpgroup's causal diagonal
  auto masked_at = [&](int kv0) {
    return kv0 < lo || kv0 + DQ_BKV > hi || (causal && kv0 + DQ_BKV - 1 > wg_row0);
  };

  float acc[64], s[32], dp[32];
#pragma unroll
  for (int x = 0; x < 64; ++x) acc[x] = 0.f;
  uint32_t da[16];   // dS of the current tile as bf16 register A fragments

  if (n_tiles > 0) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    dq_scores(s, dp, sQw, sdOw, sK, sV);
    wgmma_wait<0>();
    fence_operands(s);
    fence_operands(dp);
    dq_ds(s, dp, masked_at(kv_begin), kv_begin, row0, col0, lo, hi, causal, c, nl2, dl, scale);
#pragma unroll
    for (int r = 0; r < 16; ++r) da[r] = pack_bf16(s[2 * r], s[2 * r + 1]);
  }

  // Tile j: s and dp of tile j + 1 run on the tensor cores beside dQ +=
  // dS_j K_j, and tile j + 1's dS forms while dQ += dS_j K_j is in flight.
  // The last tile (dQ += dS K only) is peeled off, so the loop body issues
  // and retires its products unconditionally.
  for (int j = 0; j + 1 < n_tiles; ++j) {
    // K/V of tile j + 1 have landed, and every thread is past tile j - 1:
    // K stage (j + 2) % 3 (K_{j-1}) and V stage j % 2 (V_j, read by the
    // previous dp product) are free for tile j + 2
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (j + 2 < n_tiles) load_kv(j + 2);
    cp_async_commit();

    const int kv_next = kv_begin + (j + 1) * DQ_BKV;
    dq_scores(s, dp, sQw, sdOw, sK + ((j + 1) % DQ_K_STAGES) * DQ_KV_BYTES,
              sV + ((j + 1) & 1) * DQ_KV_BYTES);
    ds_k_tile(acc, da, sK + (j % DQ_K_STAGES) * DQ_KV_BYTES);
    wgmma_wait<1>();   // s and dp of tile j + 1 are done; dS_j K_j may still run
    fence_operands(s);
    fence_operands(dp);
    dq_ds(s, dp, masked_at(kv_next), kv_next, row0, col0, lo, hi, causal, c, nl2, dl, scale);
    wgmma_wait<0>();
    fence_operands(acc);
#pragma unroll
    for (int r = 0; r < 16; ++r) da[r] = pack_bf16(s[2 * r], s[2 * r + 1]);
  }
  if (n_tiles > 0) {
    ds_k_tile(acc, da, sK + ((n_tiles - 1) % DQ_K_STAGES) * DQ_KV_BYTES);
    wgmma_wait<0>();
    fence_operands(acc);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= Sq) continue;
    bf16* drow = dq + (((size_t)b * Sq + row) * H + h) * DH + col0;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj)
      *reinterpret_cast<uint32_t*>(drow + 8 * jj) =
          pack_bf16(acc[4 * jj + 2 * i], acc[4 * jj + 2 * i + 1]);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ kv_lo, const int* __restrict__ kv_hi,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Hkv, int Sq,
                     int Sk, int causal, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));   // generic view of base
  const uint32_t sK = base, sV = base + DKV_KV_BYTES;

  const int hk = blockIdx.x, b = blockIdx.y;
  const int kv0 = blockIdx.z * DKV_BKV;   // causal: the longest walks come first
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int rep = H / Hkv;

  const int lo = kv_lo ? max(kv_lo[b], 0) : 0;
  const int hi = kv_hi ? min(kv_hi[b], Sk) : Sk;
  // a key tile with no key inside [lo, hi) gets no live pair: dk, dv are 0
  const bool tile_live = kv0 < hi && kv0 + DKV_BKV > lo;
  // causal: query blocks wholly above this key tile's diagonal are dead
  const int q_begin = causal ? (kv0 / DKV_BQ) * DKV_BQ : 0;
  const int n_qb = tile_live && q_begin < Sq ? (Sq - q_begin + DKV_BQ - 1) / DKV_BQ : 0;
  // the walk over (group head, query block); warpgroup w takes its items
  // w, w + 2, ... through its own ring, so the two drift apart freely and
  // one's exp and ds overlap the other's products
  const int n_it = rep * n_qb;
  const int n_mine = n_it > wg ? (n_it - wg + 1) / 2 : 0;
  const int t = tid & 127;
  const uint32_t ring = base + 2 * DKV_KV_BYTES + wg * 2 * DKV_STAGE;
  const float* ring_f = reinterpret_cast<const float*>(gbase + 2 * DKV_KV_BYTES +
                                                       wg * 2 * DKV_STAGE);

  const size_t q_stride = (size_t)H * DH, kv_stride = (size_t)Hkv * DH;
  auto block_q0 = [&](int i) { return q_begin + ((wg + 2 * i) % n_qb) * DKV_BQ; };
  auto load_block = [&](int i) {   // this warpgroup's i-th item into stage i & 1
    const int it = wg + 2 * i;
    const int hq = hk * rep + it / n_qb;
    const int qb0 = block_q0(i);
    const size_t q_off = ((size_t)b * Sq * H + hq) * DH;
    const uint32_t st = ring + (i & 1) * DKV_STAGE;
    load_tile<DKV_BQ, 128>(st, q + q_off, qb0, Sq, q_stride, t);
    load_tile<DKV_BQ, 128>(st + DKV_Q_BYTES, dout + q_off, qb0, Sq, q_stride, t);
    // lse (threads 0-63) and delta (64-127) of the block's queries
    const int c = t & (DKV_BQ - 1);
    const bool valid = qb0 + c < Sq;
    const size_t idx = ((size_t)b * H + hq) * Sq + (valid ? qb0 + c : 0);
    const float* src = t < DKV_BQ ? lse + idx : delta + idx;
    cp_async_4(st + 2 * DKV_Q_BYTES + (t >> 6) * DKV_BQ * 4 + c * 4, src, valid);
  };
  if (tile_live) {
    load_tile<DKV_BKV, THREADS>(sK, k + ((size_t)b * Sk * Hkv + hk) * DH, kv0, Sk, kv_stride,
                                tid);
    load_tile<DKV_BKV, THREADS>(sV, v + ((size_t)b * Sk * Hkv + hk) * DH, kv0, Sk, kv_stride,
                                tid);
  }
  if (n_mine > 0) load_block(0);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();   // K and V (copied by both warpgroups) are visible to both

  const int key0 = kv0 + warp * 16 + (lane >> 2);   // keys key0 and key0 + 8 (rows of s^T)
  const int col0 = 2 * (lane & 3);
  const float sl2 = scale * LOG2E;
  float dka[64], dva[64];
#pragma unroll
  for (int x = 0; x < 64; ++x) dka[x] = dva[x] = 0.f;

  for (int i = 0; i < n_mine; ++i) {
    // item i has landed, and every thread of this warpgroup is past item
    // i - 1: its stage is free for item i + 1, whose copy runs beside this
    // item's products
    cp_async_wait<0>();
    fence_proxy_async();
    named_barrier_sync(1 + wg, 128);
    if (i + 1 < n_mine) load_block(i + 1);
    cp_async_commit();
    const int qw = block_q0(i);   // this item's 64 queries
    const uint32_t sQw = ring + (i & 1) * DKV_STAGE;
    const uint32_t sdOw = sQw + DKV_Q_BYTES;
    const float* lse_s = ring_f + (i & 1) * (DKV_STAGE / 4) + 2 * DKV_Q_BYTES / 4;
    const float* dl_s = lse_s + DKV_BQ;

    if (!(causal && qw + 63 < kv0)) {
      // s^T and dp^T as two groups: p^T forms while dp^T runs, ds^T while
      // dV += P^T dO runs (no instruction but wgmma defines s or dp before
      // their first steps, so ptxas keeps the products asynchronous)
      float s[32], dp[32];
      fence_operands(s);
      fence_operands(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        wgmma_ss_n64(s, desc_kmajor(sK, DKV_BKV, kk), desc_kmajor(sQw, DKV_BQ, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        wgmma_ss_n64(dp, desc_kmajor(sV, DKV_BKV, kk), desc_kmajor(sdOw, DKV_BQ, kk), kk > 0);
      wgmma_commit();
      fence_operands(s);
      fence_operands(dp);

      const bool masked = kv0 < lo || kv0 + DKV_BKV > hi || qw + 64 > Sq ||
                          (causal && kv0 + DKV_BKV - 1 > qw);
      wgmma_wait<1>();   // s^T is done; dp^T may still run
      fence_operands(s);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 L = *reinterpret_cast<const float2*>(lse_s + 8 * jj + col0);
#pragma unroll
        for (int ie = 0; ie < 4; ++ie) {
          const int x = 4 * jj + ie, e = ie & 1;
          float p = ex2(fmaf(s[x], sl2, -(e ? L.y : L.x) * LOG2E));
          if (masked) {
            const int key = key0 + 8 * (ie >> 1);
            const int qq = qw + 8 * jj + col0 + e;
            const bool live = key >= lo && key < hi && qq < Sq && (!causal || qq >= key);
            p = live ? p : 0.f;   // selected, never exp of a masked logit
          }
          s[x] = p;
        }
      }
      uint32_t pa[16], da[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) pa[r] = pack_bf16(s[2 * r], s[2 * r + 1]);
      fence_operands(dva);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DKV_BQ / 16; ++kk)
        wgmma_rs_n128(dva, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                      desc_mnmajor(sdOw, DKV_BQ, kk));
      wgmma_commit();
      fence_operands(dva);
      wgmma_wait<1>();   // dp^T is done; dV += P^T dO may still run
      fence_operands(dp);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 D = *reinterpret_cast<const float2*>(dl_s + 8 * jj + col0);
#pragma unroll
        for (int ie = 0; ie < 4; ++ie) {
          const int x = 4 * jj + ie;
          dp[x] = s[x] * (dp[x] - ((ie & 1) ? D.y : D.x)) * scale;
        }
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) da[r] = pack_bf16(dp[2 * r], dp[2 * r + 1]);
      fence_operands(dka);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DKV_BQ / 16; ++kk)
        wgmma_rs_n128(dka, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3],
                      desc_mnmajor(sQw, DKV_BQ, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(dva);
      fence_operands(dka);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // dK, dV = warpgroup 0's sums + warpgroup 1's, in that order, through the
  // (now free) rings; element x of thread t at [x][t], conflict-free
  float* red = reinterpret_cast<float*>(gbase + 2 * DKV_KV_BYTES);
  if (wg == 1) {
#pragma unroll
    for (int x = 0; x < 64; ++x) {
      red[x * 128 + t] = dka[x];
      red[(64 + x) * 128 + t] = dva[x];
    }
  }
  __syncthreads();
  if (wg == 1) return;
#pragma unroll
  for (int x = 0; x < 64; ++x) {
    dka[x] += red[x * 128 + t];
    dva[x] += red[(64 + x) * 128 + t];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key >= Sk) continue;
    const size_t off = (((size_t)b * Sk + key) * Hkv + hk) * DH + col0;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * jj) =
          pack_bf16(dka[4 * jj + 2 * i], dka[4 * jj + 2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * jj) =
          pack_bf16(dva[4 * jj + 2 * i], dva[4 * jj + 2 * i + 1]);
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
  dim3 grid(H, B, (Sq + DQ_BQ - 1) / DQ_BQ);
  flash_bwd_dq_kernel<<<grid, THREADS, DQ_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(kv_lo),
      static_cast<const int*>(kv_hi), static_cast<bf16*>(dq), H, Hkv, Sq, Sk, causal, scale);
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
  dim3 grid(Hkv, B, (Sk + DKV_BKV - 1) / DKV_BKV);
  flash_bwd_dkv_kernel<<<grid, THREADS, DKV_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(kv_lo),
      static_cast<const int*>(kv_hi), static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Hkv,
      Sq, Sk, causal, scale);
  return (int)cudaGetLastError();
}

// The three kernels' resources, six ints each (delta, dq, dk/dv): registers
// per thread, static shared bytes, dynamic shared bytes, local (spill)
// bytes per thread, threads per CTA, CTAs per SM.  Returns the first CUDA
// error.
int flash_bwd_resources(int* res) {
  const void* fns[3] = {(const void*)flash_bwd_delta_kernel, (const void*)flash_bwd_dq_kernel,
                        (const void*)flash_bwd_dkv_kernel};
  const int smem[3] = {0, DQ_SMEM, DKV_SMEM};
  const int threads[3] = {256, THREADS, THREADS};
  for (int f = 0; f < 3; ++f) {
    if (smem[f])
      cudaFuncSetAttribute(fns[f], cudaFuncAttributeMaxDynamicSharedMemorySize, smem[f]);
    cudaFuncAttributes a;
    cudaError_t err = cudaFuncGetAttributes(&a, fns[f]);
    if (err != cudaSuccess) return (int)err;
    int ctas = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fns[f], threads[f], smem[f]);
    if (err != cudaSuccess) return (int)err;
    int* r = res + 6 * f;
    r[0] = a.numRegs;
    r[1] = (int)a.sharedSizeBytes;
    r[2] = smem[f];
    r[3] = (int)a.localSizeBytes;
    r[4] = threads[f];
    r[5] = ctas;
  }
  return 0;
}

}  // extern "C"
