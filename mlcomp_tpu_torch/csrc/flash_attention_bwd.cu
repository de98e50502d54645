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
// The design at DH 128, for Hopper's tensor cores (wgmma.cuh): every
// product is a wgmma with its accumulator in registers; operand tiles
// arrive by cp.async into rings of 128-byte-swizzled shared memory, one
// barrier per tile publishing the tile that landed and freeing the stages
// of the one before, whose copies then run beside this tile's products;
// the mask is evaluated only on tiles that cross the diagonal, a window
// edge or the end of the sequence.  No producer warp: all 256 threads
// issue the copies, so each consumer thread may hold up to 255 registers
// (one CTA per SM) without register rebalancing (setmaxnreg).  DH 64 and
// 256 differ, below.
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
// - delta: one warp per (batch, position, head) row (eight threads at
//   DH = 64, a 16-byte chunk of dO and O each): sum_d dO * O in f32,
//   minus the lse cotangent when one is given (ring attention's path).
//
// Head dims.  The dq and dk/dv kernels above are templates on the head dim
// DH, instantiated at 128; DH = 64 and DH = 256 have kernels of their own
// (the wrapper passes bf16 heads of 64 or less to the dh-64 kernels and
// pads heads of 129-255 to 256, as the forward's does).
//
// DH = 64 (bf16 heads of 64 or less, unpadded: the TPU's 128-lane padding
// doubled every product and byte).  A row is one 128-byte swizzle line and
// every tile one column block.  What bounds it: a (query, key) pair costs
// each kernel one exp2 on the SFU (16 a clock an SM) beside three (dq) or
// four (dk/dv) 64-deep products, and the f32 work around the exp (the
// mask above all) takes as long again, so the kernels are bound by the
// instructions between products and by their latency, not by the tensor
// cores.  The kernels before these ran in lockstep: every 64 keys
// (dq) or every item (dk/dv) ended in cp.async waits and a barrier over
// the whole CTA.  The design, the forward's machinery (tma.cuh):
// - warp specialisation: one producer warpgroup, of which one thread
//   issues every TMA load (setmaxnreg.dec to 40), and two consumer
//   warpgroups that take its registers (setmaxnreg.inc to 232), one CTA an
//   SM; rings of stages with full and empty mbarriers, an empty barrier
//   counting every consumer warp; no barrier over the CTA after the
//   barriers' initialisation;
// - dq (Dq64, flash_bwd_dq64_kernel): persistent, two consumers of 64
//   query rows (a 128-row Q tile, so a K/V tile feeds 128 rows), Q and dO
//   double-buffered, K and V tiles of 64 keys in a ring of four stages, a
//   stage released once dQ += dS K has read its K; s and dp of tile j + 1
//   beside dQ += dS_j K_j, dS of tile j + 1 formed while that product
//   runs, the mask arithmetic only in tiles that cross an edge (a template
//   argument: a runtime test inside the unrolled loop left it on every
//   element);
// - dk/dv (Dkv64, flash_bwd_dkv64_kernel): one CTA a work item (the
//   hardware's scheduler balances the key tiles that windows leave empty),
//   two consumers of 64 keys each, dK and dV of 64 x 64 in registers, K
//   and V of the CTA's keys once; the walk's items (group head, 64-query
//   block: Q and dO by TMA, lse and delta by cp.async arriving on the same
//   full barrier) come through one ring of five stages that each consumer
//   reads at its own pace; a Q/dO block is read once for 128 keys; an
//   item is `dkv_item`.  Two consumers at every length (three spill at
//   the 160 registers a thread that four warpgroups leave); the parent's
//   switch to three at 1024 keys (`DKV64_LONG_KEYS`) is gone.
// Tried and dropped (PERF.md): a persistent dk/dv kernel (slower
// at windows and long causal walks); issuing the next item's scores
// before this item's dK/dV retire (ptxas serialises the products when a
// barrier wait's loop runs while they are in flight: slower); dk/dv's
// mask as a template argument, as dq's (1.2x faster at 1 x 32768, but it
// spills at 232 registers, or at a producer of 24, and ptxas serialises
// its products).
// The delta kernel reads one 16-byte chunk a thread at DH = 64.
//
// DH = 256.  A 64 x 256 f32 accumulator is 128 registers a thread of a
// warpgroup, so each kernel runs two warpgroups a CTA that share a tile's
// logits by ROLE: warpgroup 0 computes s (and p = exp(s - lse), masked),
// warpgroup 1 the dO.V products dp (and ds = p (dp - delta) scale); p
// crosses to warpgroup 1 as f32 through shared memory (thread t of either
// warpgroup holds the same elements, stored at [x][t]: conflict-free).
// Each (query, key) pair's s and dp are computed once in each kernel, as
// at DH = 128: seven dh-long products a pair in all, where the DH = 256
// kernels before (dq one warpgroup, spilling; dk/dv one CTA a 128-column
// half, each recomputing s and dp over the whole head) ran nine.
// - dq (Dq256, flash_bwd_dq256_kernel): one CTA per (head, batch, 64-row
//   Q tile); warpgroup w owns columns 128 w .. 128 w + 127 of dQ (64
//   registers), and ds comes back to warpgroup 0 as bf16 register-A
//   fragments.  Each warpgroup keeps its operand of the logits as
//   register-A fragments for the whole walk (Q in warpgroup 0, dO in
//   warpgroup 1: 64 registers), so shared memory holds only the K ring
//   (three stages of 64 keys: a K tile feeds s of tile j + 1 and dQ of
//   tile j), the V ring (two stages), p (16 KB) and dS (8 KB): 189440
//   bytes.  s (or dp) of tile j + 1 runs on the tensor cores beside dQ +=
//   dS_j K_j, and p and ds of tile j + 1 form while dQ_j is in flight.
// - dk/dv (Dkv256, flash_bwd_dkv256_kernel): one CTA per (64-key tile, kv
//   head, batch); the roles split the products too: warpgroup 0
//   accumulates all of dV += P^T dO, warpgroup 1 all of dK += dS^T Q (two
//   128-column accumulators a thread each), so only p crosses.  K and V
//   stay in shared memory (64 KB) beside a two-stage ring of 64-query
//   blocks (Q, dO, lse and delta: 65 KB a stage) and p (16 KB): 216064
//   bytes of the 232448.  dK and dV of a key sum the items in the walk's
//   order, each 128 columns in 16-query steps in order, as before: the
//   bits are those of the kernels this one replaces.
// `flash_attention.resources()` prints all three instances.
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

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int SMEM_MAX = 232448;

// dq at DH 128: Q and dO (BQ rows), then three stages of K and two of V
// (64 keys): a K tile is read by two products one tile apart.  dQ is one
// 64 x DH accumulator a warpgroup
template <int DH>
struct Dq {
  static_assert(DH == 128, "dq at DH 64: Dq64; at DH 256: Dq256");
  static constexpr int BQ = 128, THREADS = 2 * BQ;
  static constexpr int BKV = 64, K_STAGES = 3;
  static constexpr int Q_BYTES = BQ * DH * 2, KV_BYTES = BKV * DH * 2;
  static constexpr int SMEM = 2 * Q_BYTES + (K_STAGES + 2) * KV_BYTES + 1024;
};

// dk/dv at DH 128: K and V (64 keys), then for each of the NWG warpgroups
// a two-stage ring of 64-query blocks (Q, dO, lse and delta); the final
// cross-warpgroup sum reuses the rings
template <int DH>
struct Dkv {
  static_assert(DH == 128, "dk/dv at DH 64: Dkv64; at DH 256: Dkv256");
  static constexpr int NWG = 2, THREADS = 128 * NWG;
  static constexpr int BKV = 64, BQ = 64;
  static constexpr int KV_BYTES = BKV * DH * 2, Q_BYTES = BQ * DH * 2;
  // Q and dO, lse and delta, rounded up to keep every tile 1024-aligned
  static constexpr int STAGE = (2 * Q_BYTES + 2 * BQ * 4 + 1023) / 1024 * 1024;
  static constexpr int SMEM = 2 * KV_BYTES + 2 * NWG * STAGE + 1024;
};
// dq at DH 64: NC consumer warpgroups of 64 query rows and one producer
// warpgroup; Q and dO (64 NC rows) once, then a ring of STAGES stages of a
// K and a V tile of 64 keys (a stage is released once dQ += dS K has read
// its K, one tile after s and dp read it); the barriers (Q/dO full, then
// full and empty of each stage) after the tiles
struct Dq64 {
  static constexpr int NC = 2, BQ = 64 * NC, BKV = 64, STAGES = 4;
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  static constexpr int Q_BYTES = BQ * 128, KV_BYTES = BKV * 128;
  // two buffers of Q and dO: an item's land while the last item's are read
  static constexpr int BAR_OFF = 4 * Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (4 + 2 * STAGES) + 1024;
};
// dk/dv at DH 64: two consumer warpgroups, each owning 64 keys (dK and dV
// of 64 x 64 each in registers: no cross-warpgroup sum), and one producer
// warpgroup; K and V of the CTA's 128 keys once, then a ring of RING
// stages of items (a 64-query block's Q, dO, lse and delta) that every
// consumer reads at its own pace; the barriers (K/V full, then full and
// empty of each stage) after the ring
struct Dkv64 {
  static constexpr int NWG = 2, THREADS = 128 * (NWG + 1), BKV = 64, BQ = 64;
  static constexpr int KEYS = NWG * BKV, RING = 5;
  // setmaxnreg: the producer's and consumers' registers within the CTA's
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  static constexpr int KV_BYTES = KEYS * 128, Q_BYTES = BQ * 128;
  static constexpr int STAGE = (2 * Q_BYTES + 2 * BQ * 4 + 1023) / 1024 * 1024;
  static constexpr int BAR_OFF = 2 * KV_BYTES + RING * STAGE;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * RING) + 1024;
};
// dq at DH 256: two warpgroups on one 64-row Q tile, each with its logit
// operand (Q or dO) in registers; three stages of K and two of V (64 keys,
// 32 KB each), then p (64 x 64 f32, warpgroup 0 -> 1) and dS (64 x 64
// bf16 fragments, 1 -> 0)
struct Dq256 {
  static constexpr int DH = 256, BQ = 64, BKV = 64, THREADS = 256;
  static constexpr int K_STAGES = 3, V_STAGES = 2, KV_BYTES = BKV * DH * 2;
  static constexpr int P_BYTES = BQ * BKV * 4, DS_BYTES = BQ * BKV * 2;
  static constexpr int SMEM = (K_STAGES + V_STAGES) * KV_BYTES + P_BYTES + DS_BYTES + 1024;
};
// dk/dv at DH 256: K and V (64 keys, 32 KB each), a two-stage ring of
// 64-query blocks (Q and dO, 32 KB each, lse and delta), then p^T (f32,
// warpgroup 0 -> 1)
struct Dkv256 {
  static constexpr int DH = 256, BKV = 64, BQ = 64, THREADS = 256;
  static constexpr int KV_BYTES = BKV * DH * 2, Q_BYTES = BQ * DH * 2;
  static constexpr int STAGE = (2 * Q_BYTES + 2 * BQ * 4 + 1023) / 1024 * 1024;
  static constexpr int P_BYTES = BKV * BQ * 4;
  static constexpr int SMEM = 2 * KV_BYTES + 2 * STAGE + P_BYTES + 1024;
};
static_assert(Dq64::SMEM <= SMEM_MAX && Dq<128>::SMEM <= SMEM_MAX && Dq256::SMEM == 189440,
              "dq shared memory");
static_assert(Dkv64::SMEM <= SMEM_MAX && Dkv<128>::SMEM <= SMEM_MAX && Dkv256::SMEM == 216064,
              "dk/dv shared memory");
static_assert(128 * Dq64::PRODUCER_REGS + 128 * Dq64::NC * Dq64::CONSUMER_REGS <=
                      launch_regs(Dq64::THREADS) * Dq64::THREADS &&
                  128 * Dkv64::PRODUCER_REGS + 256 * Dkv64::CONSUMER_REGS <=
                      launch_regs(Dkv64::THREADS) * Dkv64::THREADS,
              "the rebalanced registers fit the CTA's");
static_assert(Dkv<128>::STAGE == 33 * 1024, "the DH = 128 stage is unchanged");
static_assert(4 * Dkv<128>::STAGE >= 2 * 64 * 128 * 4, "the dK/dV sum fits in the rings");

// delta: CH neighbouring threads per (b, i, h) row of the (B, Sq, H, DH)
// tensors, the row's partial sums added by shuffles inside its group.  At
// DH = 64 eight threads a row, each reading one 16-byte chunk of dO and of
// O; at 128 and 256 a warp a row, DH / 32 elements a lane
template <int DH>
constexpr int DELTA_CH = DH == 64 ? 8 : 32;

template <int DH>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const __nv_bfloat16* __restrict__ dout,
                       const __nv_bfloat16* __restrict__ out,
                       const float* __restrict__ g_lse,
                       float* __restrict__ delta, int H, int Sq, long rows) {
  constexpr int CH = DELTA_CH<DH>, E = DH / CH;
  const long row = ((long)blockIdx.x * 256 + threadIdx.x) / CH;
  const int c = threadIdx.x % CH;
  float s = 0.f;
  if (row < rows) {
    const __nv_bfloat16* a = dout + row * DH + c * E;
    const __nv_bfloat16* o = out + row * DH + c * E;
    if constexpr (DH == 64) {
      const uint4 a8 = *reinterpret_cast<const uint4*>(a);
      const uint4 o8 = *reinterpret_cast<const uint4*>(o);
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a8);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o8);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 fa = __bfloat1622float2(a2[e]), fo = __bfloat1622float2(o2[e]);
        s += fa.x * fo.x;
        s += fa.y * fo.y;
      }
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) s += __bfloat162float(a[e]) * __bfloat162float(o[e]);
    }
  }
#pragma unroll
  for (int off = CH / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (row < rows && c == 0) {
    const int h = (int)(row % H);
    const long bi = row / H;
    const int i = (int)(bi % Sq);
    const long b = bi / Sq;
    const long idx = (b * H + h) * Sq + i;     // (B, H, Sq)
    delta[idx] = g_lse ? s - g_lse[idx] : s;
  }
}

// dq_ds for the dh-64 dq kernel, the mask a template argument: a tile that
// needs none carries no mask arithmetic
template <bool MASKED>
__device__ __forceinline__ void dq64_ds_body(float (&s)[32], const float (&dp)[32], int kv0,
                                             int row0, int col0, int lo, int hi, int causal,
                                             float c, const float (&nl2)[2],
                                             const float (&dl)[2], float scale) {
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    const int i = (x >> 1) & 1;
    float p = ex2(fmaf(s[x], c, nl2[i]));
    if (MASKED) {
      const int col = kv0 + 8 * (x >> 2) + col0 + (x & 1);
      const int row = row0 + 8 * i;
      const bool live = col >= lo && col < hi && (!causal || row >= col);
      p = live ? p : 0.f;   // selected, never exp of a masked logit
    }
    s[x] = p * (dp[x] - dl[i]) * scale;
  }
}

__device__ __forceinline__ void dq64_ds(float (&s)[32], const float (&dp)[32], bool masked,
                                        int kv0, int row0, int col0, int lo, int hi, int causal,
                                        float c, const float (&nl2)[2], const float (&dl)[2],
                                        float scale) {
  if (masked)
    dq64_ds_body<true>(s, dp, kv0, row0, col0, lo, hi, causal, c, nl2, dl, scale);
  else
    dq64_ds_body<false>(s, dp, kv0, row0, col0, lo, hi, causal, c, nl2, dl, scale);
}

// s = Q K^T and dp = dO V^T of one warpgroup's 64 rows against one tile of
// 64 keys, raw (unscaled) logits, issued and committed as one wgmma group
// (the first steps overwrite s and dp: no instruction but wgmma defines
// them, so ptxas keeps the products asynchronous)
template <int DH>
__device__ __forceinline__ void dq_scores(float (&s)[32], float (&dp)[32], uint32_t q_tile,
                                          uint32_t do_tile, uint32_t k_tile, uint32_t v_tile) {
  constexpr int BQ = Dq<DH>::BQ, BKV = Dq<DH>::BKV;
  fence_operands(s);
  fence_operands(dp);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_ss_n64(s, desc_kmajor(q_tile, BQ, kk), desc_kmajor(k_tile, BKV, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_ss_n64(dp, desc_kmajor(do_tile, BQ, kk), desc_kmajor(v_tile, BKV, kk), kk > 0);
  wgmma_commit();
  fence_operands(s);
  fence_operands(dp);
}

// dQ += dS K for one warpgroup: dS (64 x 64) as bf16 register A
// fragments, K (64 keys x DH) MN-major, one 64 x DH accumulator; issued and
// committed as one group
template <int DH>
__device__ __forceinline__ void ds_k_tile(float (&acc)[DH / 2], const uint32_t (&da)[16],
                                          uint32_t k_tile) {
  constexpr int BKV = Dq<DH>::BKV;
  fence_operands(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
    wgmma_rs(acc, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3],
             desc_mnmajor(k_tile, BKV, kk));
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

template <int DH>
__global__ void __launch_bounds__(Dq<DH>::THREADS, 1)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ kv_lo, const int* __restrict__ kv_hi,
                    bf16* __restrict__ dq, int H, int Hkv, int Sq, int Sk, int causal,
                    float scale) {
  using C = Dq<DH>;
  constexpr int DQ_BQ = C::BQ, DQ_BKV = C::BKV, DQ_K_STAGES = C::K_STAGES, OR = DH / 2;
  constexpr int THREADS = C::THREADS, DQ_Q_BYTES = C::Q_BYTES, DQ_KV_BYTES = C::KV_BYTES;
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
    load_tile<DQ_BKV, THREADS, DH>(sK + (t % DQ_K_STAGES) * DQ_KV_BYTES, kb, kv0, Sk,
                                   kv_stride, tid);
    load_tile<DQ_BKV, THREADS, DH>(sV + (t & 1) * DQ_KV_BYTES, vb, kv0, Sk, kv_stride, tid);
  };
  load_tile<DQ_BQ, THREADS, DH>(sQ, q + q_off, q0, Sq, q_stride, tid);
  load_tile<DQ_BQ, THREADS, DH>(sdO, dout + q_off, q0, Sq, q_stride, tid);
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

  float acc[OR], s[32], dp[32];
#pragma unroll
  for (int x = 0; x < OR; ++x) acc[x] = 0.f;
  uint32_t da[16];   // dS of the current tile as bf16 register A fragments

  if (n_tiles > 0) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    dq_scores<DH>(s, dp, sQw, sdOw, sK, sV);
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
    dq_scores<DH>(s, dp, sQw, sdOw, sK + ((j + 1) % DQ_K_STAGES) * DQ_KV_BYTES,
                  sV + ((j + 1) & 1) * DQ_KV_BYTES);
    ds_k_tile<DH>(acc, da, sK + (j % DQ_K_STAGES) * DQ_KV_BYTES);
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
    ds_k_tile<DH>(acc, da, sK + ((n_tiles - 1) % DQ_K_STAGES) * DQ_KV_BYTES);
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
    for (int jj = 0; jj < OR / 4; ++jj)
      *reinterpret_cast<uint32_t*>(drow + 8 * jj) =
          pack_bf16(acc[4 * jj + 2 * i], acc[4 * jj + 2 * i + 1]);
  }
}

// One item of the dk/dv walk for one warpgroup's 64 keys (K and V tiles
// sK, sV) against 64 queries (Q and dO tiles sQw, sdOw; their lse and
// delta lse_s, dl_s): s^T = K Q^T and dp^T = V dO^T as two groups, p^T
// forming while dp^T runs and ds^T while dV += P^T dO runs; p^T and ds^T
// round to bf16 and are the register A operands of dV += P^T dO and dK +=
// dS^T Q, dO and Q read MN-major from `col_off` on.  dK and dV are 64 x
// 2 NA accumulators (NA = 64: a 128-column slice; 32: the whole dh-64
// tile).  The mask only where `masked`; key0 and col0 are this thread's
// accumulator row and column.
template <int DH, int NA>
__device__ __forceinline__ void dkv_item(float (&dka)[NA], float (&dva)[NA], uint32_t sK,
                                         uint32_t sV, uint32_t sQw, uint32_t sdOw,
                                         uint32_t col_off, const float* lse_s, const float* dl_s,
                                         bool masked, int key0, int col0, int qw, int lo, int hi,
                                         int Sq, int causal, float scale) {
  const float sl2 = scale * LOG2E;
  // s^T and dp^T as two groups: p^T forms while dp^T runs, ds^T while
  // dV += P^T dO runs (no instruction but wgmma defines s or dp before
  // their first steps, so ptxas keeps the products asynchronous)
  float s[32], dp[32];
  fence_operands(s);
  fence_operands(dp);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_ss_n64(s, desc_kmajor(sK, 64, kk), desc_kmajor(sQw, 64, kk), kk > 0);
  wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_ss_n64(dp, desc_kmajor(sV, 64, kk), desc_kmajor(sdOw, 64, kk), kk > 0);
  wgmma_commit();
  fence_operands(s);
  fence_operands(dp);

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
  for (int kk = 0; kk < 64 / 16; ++kk)
    wgmma_rs(dva, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
             desc_mnmajor(sdOw + col_off, 64, kk));
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
  for (int kk = 0; kk < 64 / 16; ++kk)
    wgmma_rs(dka, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3],
             desc_mnmajor(sQw + col_off, 64, kk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(dva);
  fence_operands(dka);
}

template <int DH>
__global__ void __launch_bounds__(Dkv<DH>::THREADS, 1)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ kv_lo, const int* __restrict__ kv_hi,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Hkv, int Sq,
                     int Sk, int causal, float scale) {
  using C = Dkv<DH>;
  constexpr int NWG = C::NWG, THREADS = C::THREADS;
  constexpr int DKV_BKV = C::BKV, DKV_BQ = C::BQ, DKV_KV_BYTES = C::KV_BYTES;
  constexpr int DKV_Q_BYTES = C::Q_BYTES, DKV_STAGE = C::STAGE;
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
  // w, w + NWG, ... through its own ring, so two warpgroups drift apart
  // freely and one's exp and ds overlap the other's products
  const int n_it = rep * n_qb;
  const int n_mine = n_it > wg ? (n_it - wg + NWG - 1) / NWG : 0;
  const int t = tid & 127;
  const uint32_t ring = base + 2 * DKV_KV_BYTES + wg * 2 * DKV_STAGE;
  const float* ring_f = reinterpret_cast<const float*>(gbase + 2 * DKV_KV_BYTES +
                                                       wg * 2 * DKV_STAGE);

  const size_t q_stride = (size_t)H * DH, kv_stride = (size_t)Hkv * DH;
  auto block_q0 = [&](int i) { return q_begin + ((wg + NWG * i) % n_qb) * DKV_BQ; };
  auto load_block = [&](int i) {   // this warpgroup's i-th item into stage i & 1
    const int it = wg + NWG * i;
    const int hq = hk * rep + it / n_qb;
    const int qb0 = block_q0(i);
    const size_t q_off = ((size_t)b * Sq * H + hq) * DH;
    const uint32_t st = ring + (i & 1) * DKV_STAGE;
    load_tile<DKV_BQ, 128, DH>(st, q + q_off, qb0, Sq, q_stride, t);
    load_tile<DKV_BQ, 128, DH>(st + DKV_Q_BYTES, dout + q_off, qb0, Sq, q_stride, t);
    // lse (threads 0-63) and delta (64-127) of the block's queries
    const int c = t & (DKV_BQ - 1);
    const bool valid = qb0 + c < Sq;
    const size_t idx = ((size_t)b * H + hq) * Sq + (valid ? qb0 + c : 0);
    const float* src = t < DKV_BQ ? lse + idx : delta + idx;
    cp_async_4(st + 2 * DKV_Q_BYTES + (t >> 6) * DKV_BQ * 4 + c * 4, src, valid);
  };
  if (tile_live) {
    load_tile<DKV_BKV, THREADS, DH>(sK, k + ((size_t)b * Sk * Hkv + hk) * DH, kv0, Sk,
                                    kv_stride, tid);
    load_tile<DKV_BKV, THREADS, DH>(sV, v + ((size_t)b * Sk * Hkv + hk) * DH, kv0, Sk,
                                    kv_stride, tid);
  }
  if (n_mine > 0) load_block(0);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();   // K and V (copied by every warpgroup) are visible to all

  const int key0 = kv0 + warp * 16 + (lane >> 2);   // keys key0 and key0 + 8 (rows of s^T)
  const int col0 = 2 * (lane & 3);
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
      const bool masked = kv0 < lo || kv0 + DKV_BKV > hi || qw + 64 > Sq ||
                          (causal && kv0 + DKV_BKV - 1 > qw);
      dkv_item<DH>(dka, dva, sK, sV, sQw, sdOw, 0, lse_s, dl_s, masked, key0, col0, qw, lo, hi,
                   Sq, causal, scale);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // dK, dV = warpgroup 0's sums + warpgroup 1's, in that order, through
  // the (now free) rings; element x of thread t at [x][t], conflict-free
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

// dq at DH = 256: s (warpgroup 0, xa = Q) or dp (1, xa = dO) against one
// K-major K or V tile of 64 keys, raw (unscaled), one wgmma group (the
// first step overwrites)
__device__ __forceinline__ void dq256_scores(float (&sd)[32], const uint32_t (&xa)[64],
                                             uint32_t tile) {
  fence_operands(sd);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 16; ++kk)
    wgmma_rs_n64_kmajor(sd, xa[4 * kk], xa[4 * kk + 1], xa[4 * kk + 2], xa[4 * kk + 3],
                        desc_kmajor(tile, 64, kk), kk > 0);
  wgmma_commit();
  fence_operands(sd);
}

// dq at DH = 256: dQ += dS K on one warpgroup's 128 columns (k_cols: the K
// tile at those columns, read MN-major), the 16-key steps in order
__device__ __forceinline__ void dq256_ds_k(float (&acc)[64], const uint32_t (&da)[16],
                                           uint32_t k_cols) {
  fence_operands(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs(acc, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3],
             desc_mnmajor(k_cols, 64, kk));
  wgmma_commit();
  fence_operands(acc);
}

// dq at DH = 256, with s and dp of one tile done: warpgroup 0 forms p =
// exp(s scale - lse) (selected to 0 on masked logits, the mask only when
// `masked`) into xp; warpgroup 1 forms ds = p (dp - delta) scale and stores
// its bf16 register-A fragments into xds; element x of thread t at [x][t].
// Every thread of the CTA calls it (two barriers)
__device__ __forceinline__ void dq256_exchange(const float (&sd)[32], int wg, int t, float* xp,
                                               uint32_t* xds, bool masked, int kv0, int row0,
                                               int col0, int lo, int hi, int causal, float c,
                                               const float (&nl2)[2], const float (&dl)[2],
                                               float scale) {
  if (wg == 0) {
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int i = (x >> 1) & 1;
      float p = ex2(fmaf(sd[x], c, nl2[i]));
      if (masked) {
        const int col = kv0 + 8 * (x >> 2) + col0 + (x & 1);
        const int row = row0 + 8 * i;
        const bool live = col >= lo && col < hi && (!causal || row >= col);
        p = live ? p : 0.f;   // selected, never exp of a masked logit
      }
      xp[x * 128 + t] = p;
    }
  }
  __syncthreads();   // p is in shared memory
  if (wg == 1) {
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int i = r & 1;   // x = 2 r, 2 r + 1: row row0 + 8 ((x / 2) % 2)
      const float d0 = xp[(2 * r) * 128 + t] * (sd[2 * r] - dl[i]) * scale;
      const float d1 = xp[(2 * r + 1) * 128 + t] * (sd[2 * r + 1] - dl[i]) * scale;
      xds[r * 128 + t] = pack_bf16(d0, d1);
    }
  }
  __syncthreads();   // dS is in shared memory
}

// dq at DH = 256 (Dq256): one CTA of two warpgroups per (head, batch,
// 64-row Q tile), longest causal tiles first.  Warpgroup w owns columns
// 128 w .. 128 w + 127 of dQ (64 accumulators a thread).  The logits are
// shared by role: warpgroup 0 holds Q and computes s = Q K^T, warpgroup 1
// holds dO and computes dp = dO V^T, each with its operand as register-A
// fragments of its 16 k-steps (loaded once) against the K-major K or V
// tile.  Warpgroup 0 forms p = exp(s scale - lse), selected to 0 on masked
// logits, and hands it to warpgroup 1 as f32; warpgroup 1 forms ds = p (dp
// - delta) scale, rounds it to bf16 and hands its register-A fragments
// back.  Tile j: s / dp of tile j + 1 run beside dQ += dS_j K_j (K read
// MN-major at this warpgroup's columns, the 16-key steps in order, as the
// kernel this one replaces did), and p and ds of tile j + 1 form while that
// product is in flight.
__global__ void __launch_bounds__(Dq256::THREADS, 1)
flash_bwd_dq256_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       const int* __restrict__ kv_lo, const int* __restrict__ kv_hi,
                       bf16* __restrict__ dq, int H, int Hkv, int Sq, int Sk, int causal,
                       float scale) {
  using C = Dq256;
  constexpr int DH = C::DH, BQ = C::BQ, BKV = C::BKV, KV_BYTES = C::KV_BYTES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));   // generic view of base
  // tile t of K lives in stage t % 3 of the K ring, of V in stage t % 2
  const uint32_t sK = base, sV = sK + C::K_STAGES * KV_BYTES;
  float* xp = reinterpret_cast<float*>(gbase + (C::K_STAGES + C::V_STAGES) * KV_BYTES);
  uint32_t* xds = reinterpret_cast<uint32_t*>(xp + BQ * BKV);

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // longest causal tiles first
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127, warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int hk = h / (H / Hkv);

  const int lo = kv_lo ? max(kv_lo[b], 0) : 0;
  const int hi = kv_hi ? min(kv_hi[b], Sk) : Sk;
  const int kv_begin = (lo / BKV) * BKV;
  const int kv_end = causal ? min(hi, q0 + BQ) : hi;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV : 0;

  const size_t q_stride = (size_t)H * DH, kv_stride = (size_t)Hkv * DH;
  const size_t q_off = ((size_t)b * Sq * H + h) * DH;
  const bf16* kb = k + ((size_t)b * Sk * Hkv + hk) * DH;
  const bf16* vb = v + ((size_t)b * Sk * Hkv + hk) * DH;
  auto load_kv = [&](int tt) {
    const int kv0 = kv_begin + tt * BKV;
    load_tile<BKV, C::THREADS, DH>(sK + (tt % C::K_STAGES) * KV_BYTES, kb, kv0, Sk, kv_stride,
                                   tid);
    load_tile<BKV, C::THREADS, DH>(sV + (tt & 1) * KV_BYTES, vb, kv0, Sk, kv_stride, tid);
  };
  if (n_tiles > 0) load_kv(0);
  if (n_tiles > 1) load_kv(1);
  cp_async_commit();

  const int row0 = q0 + warp * 16 + (lane >> 2);   // rows row0 and row0 + 8
  const int col0 = 2 * (lane & 3);
  // this warpgroup's operand of the logits, Q or dO, as the register-A
  // fragments of its 16 k-steps (rows past Sq zero)
  uint32_t xa[64];
  {
    const bf16* src = (wg == 0 ? q : dout) + q_off;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + 8 * (i & 1);
        const int col = 16 * kk + 8 * (i >> 1) + col0;
        xa[4 * kk + i] =
            row < Sq ? *reinterpret_cast<const uint32_t*>(src + (size_t)row * q_stride + col)
                     : 0u;
      }
  }
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
  // keys or the tile's causal diagonal
  auto masked_at = [&](int kv0) {
    return kv0 < lo || kv0 + BKV > hi || (causal && kv0 + BKV - 1 > q0);
  };

  float acc[64], sd[32];   // dQ (this warpgroup's 128 columns); s or dp of a tile
#pragma unroll
  for (int x = 0; x < 64; ++x) acc[x] = 0.f;
  uint32_t da[16];         // dS of the current tile as bf16 register-A fragments
  const uint32_t col_off = wg * 2 * BKV * 128;   // this warpgroup's columns of K (MN-major)

  // s (warpgroup 0) or dp (1) of tile tt, and the K stage dQ reads tile tt
  // from (this warpgroup's columns, MN-major)
  auto score_tile = [&](int tt) {
    return wg == 0 ? sK + (tt % C::K_STAGES) * KV_BYTES : sV + (tt & 1) * KV_BYTES;
  };
  auto k_cols = [&](int tt) { return sK + (tt % C::K_STAGES) * KV_BYTES + col_off; };

  if (n_tiles > 0) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    dq256_scores(sd, xa, score_tile(0));
    wgmma_wait<0>();
    fence_operands(sd);
    dq256_exchange(sd, wg, t, xp, xds, masked_at(kv_begin), kv_begin, row0, col0, lo, hi,
                   causal, c, nl2, dl, scale);
#pragma unroll
    for (int r = 0; r < 16; ++r) da[r] = xds[r * 128 + t];
  }
  // Tile j: s / dp of tile j + 1 beside dQ += dS_j K_j; p and ds of tile
  // j + 1 while that product runs.  The last tile (dQ only) is peeled off.
  for (int j = 0; j + 1 < n_tiles; ++j) {
    // K/V of tile j + 1 have landed, and every thread is past tile j - 1:
    // K stage (j + 2) % 3 (K_{j-1}) and V stage j % 2 (V_j, read by dp_j)
    // are free for tile j + 2
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (j + 2 < n_tiles) load_kv(j + 2);
    cp_async_commit();
    dq256_scores(sd, xa, score_tile(j + 1));
    dq256_ds_k(acc, da, k_cols(j));
    wgmma_wait<1>();   // s / dp of tile j + 1 are done; dQ_j may still run
    fence_operands(sd);
    const int kv_next = kv_begin + (j + 1) * BKV;
    dq256_exchange(sd, wg, t, xp, xds, masked_at(kv_next), kv_next, row0, col0, lo, hi, causal,
                   c, nl2, dl, scale);
    wgmma_wait<0>();
    fence_operands(acc);
#pragma unroll
    for (int r = 0; r < 16; ++r) da[r] = xds[r * 128 + t];
  }
  if (n_tiles > 0) {
    dq256_ds_k(acc, da, k_cols(n_tiles - 1));
    wgmma_wait<0>();
    fence_operands(acc);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= Sq) continue;
    bf16* drow = dq + (((size_t)b * Sq + row) * H + h) * DH + wg * 128 + col0;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj)
      *reinterpret_cast<uint32_t*>(drow + 8 * jj) =
          pack_bf16(acc[4 * jj + 2 * i], acc[4 * jj + 2 * i + 1]);
  }
}

// dk/dv at DH = 256 (Dkv256): one CTA of two warpgroups per (64-key tile,
// kv head, batch) over the walk of the G query heads of the group and the
// live 64-query blocks (from the diagonal when causal), one two-stage ring
// of Q, dO, lse and delta shared by both.  The roles split the products:
// warpgroup 0 computes s^T = K Q^T, forms p^T (selected to 0 on masked
// logits), hands it to warpgroup 1 as f32 and accumulates all of dV += P^T
// dO; warpgroup 1 computes dp^T = V dO^T, forms ds^T = p^T (dp^T - delta)
// scale and accumulates all of dK += dS^T Q.  Each keeps its 64 x 256 sum
// as two 128-column accumulators (128 registers a thread) for the whole
// walk.  dO and Q are read MN-major; P^T and dS^T are register-A operands,
// the 16-query steps in order; every product is issued from one place by
// both warpgroups, on the operands of its role.
__global__ void __launch_bounds__(Dkv256::THREADS, 1)
flash_bwd_dkv256_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const int* __restrict__ kv_lo, const int* __restrict__ kv_hi,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Hkv, int Sq,
                        int Sk, int causal, float scale) {
  using C = Dkv256;
  constexpr int DH = C::DH, BKV = C::BKV, BQ = C::BQ, KV_BYTES = C::KV_BYTES;
  constexpr int Q_BYTES = C::Q_BYTES, STAGE = C::STAGE;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));   // generic view of base
  const uint32_t sK = base, sV = base + KV_BYTES, ring = base + 2 * KV_BYTES;
  const float* ring_f = reinterpret_cast<const float*>(gbase + 2 * KV_BYTES);
  float* xp = reinterpret_cast<float*>(gbase + 2 * KV_BYTES + 2 * STAGE);

  const int hk = blockIdx.x, b = blockIdx.y;
  const int kv0 = blockIdx.z * BKV;   // causal: the longest walks come first
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127, warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int rep = H / Hkv;

  const int lo = kv_lo ? max(kv_lo[b], 0) : 0;
  const int hi = kv_hi ? min(kv_hi[b], Sk) : Sk;
  // a key tile with no key inside [lo, hi) gets no live pair: dk, dv are 0
  const bool tile_live = kv0 < hi && kv0 + BKV > lo;
  // causal: query blocks wholly above this key tile's diagonal are dead
  const int q_begin = causal ? (kv0 / BQ) * BQ : 0;
  const int n_qb = tile_live && q_begin < Sq ? (Sq - q_begin + BQ - 1) / BQ : 0;
  const int n_it = rep * n_qb;   // the walk: (group head, query block)

  const size_t q_stride = (size_t)H * DH, kv_stride = (size_t)Hkv * DH;
  auto block_q0 = [&](int i) { return q_begin + (i % n_qb) * BQ; };
  auto load_item = [&](int i) {   // item i into stage i & 1, by all threads
    const int hq = hk * rep + i / n_qb;
    const int qb0 = block_q0(i);
    const size_t q_off = ((size_t)b * Sq * H + hq) * DH;
    const uint32_t st = ring + (i & 1) * STAGE;
    load_tile<BQ, C::THREADS, DH>(st, q + q_off, qb0, Sq, q_stride, tid);
    load_tile<BQ, C::THREADS, DH>(st + Q_BYTES, dout + q_off, qb0, Sq, q_stride, tid);
    if (tid < 2 * BQ) {   // lse (threads 0-63) and delta (64-127) of the block's queries
      const int cq = tid & (BQ - 1);
      const bool valid = qb0 + cq < Sq;
      const size_t idx = ((size_t)b * H + hq) * Sq + (valid ? qb0 + cq : 0);
      const float* src = tid < BQ ? lse + idx : delta + idx;
      cp_async_4(st + 2 * Q_BYTES + (tid >> 6) * BQ * 4 + cq * 4, src, valid);
    }
  };
  if (tile_live) {
    load_tile<BKV, C::THREADS, DH>(sK, k + ((size_t)b * Sk * Hkv + hk) * DH, kv0, Sk, kv_stride,
                                   tid);
    load_tile<BKV, C::THREADS, DH>(sV, v + ((size_t)b * Sk * Hkv + hk) * DH, kv0, Sk, kv_stride,
                                   tid);
  }
  if (n_it > 0) load_item(0);
  cp_async_commit();

  const int key0 = kv0 + warp * 16 + (lane >> 2);   // keys key0 and key0 + 8 (rows of s^T)
  const int col0 = 2 * (lane & 3);
  const float sl2 = scale * LOG2E;
  // dV (warpgroup 0) or dK (1) of the CTA's 64 keys: columns 128 hh ..
  float acc[2][64];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int x = 0; x < 64; ++x) acc[hh][x] = 0.f;

  for (int i = 0; i < n_it; ++i) {
    // item i has landed, and every thread is past item i - 1 (its products
    // done, its p read): stage (i + 1) & 1 is free for item i + 1, whose
    // copy runs beside this item's products
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (i + 1 < n_it) load_item(i + 1);
    cp_async_commit();
    const int qw = block_q0(i);   // this item's 64 queries
    if (causal && qw + BQ - 1 < kv0) continue;
    const uint32_t sQ = ring + (i & 1) * STAGE, sdO = sQ + Q_BYTES;
    const float* lse_s = ring_f + (i & 1) * (STAGE / 4) + 2 * Q_BYTES / 4;
    const float* dl_s = lse_s + BQ;
    const bool masked = kv0 < lo || kv0 + BKV > hi || qw + BQ > Sq ||
                        (causal && kv0 + BKV - 1 > qw);

    // s^T = K Q^T (warpgroup 0) or dp^T = V dO^T (1), one group
    float sd[32];
    uint32_t fa[16];   // P^T (warpgroup 0) or dS^T (1) as bf16 register-A fragments
    {
      const uint32_t a_tile = wg == 0 ? sK : sV, b_tile = wg == 0 ? sQ : sdO;
      fence_operands(sd);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        wgmma_ss_n64(sd, desc_kmajor(a_tile, BKV, kk), desc_kmajor(b_tile, BQ, kk), kk > 0);
      wgmma_commit();
      fence_operands(sd);
      wgmma_wait<0>();
      fence_operands(sd);
    }
    if (wg == 0) {
      // p^T = exp(s^T scale - lse), selected to 0 on masked logits, to
      // warpgroup 1 as f32 (element x of thread t at [x][t])
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 L = *reinterpret_cast<const float2*>(lse_s + 8 * jj + col0);
#pragma unroll
        for (int ie = 0; ie < 4; ++ie) {
          const int x = 4 * jj + ie, e = ie & 1;
          float p = ex2(fmaf(sd[x], sl2, -(e ? L.y : L.x) * LOG2E));
          if (masked) {
            const int key = key0 + 8 * (ie >> 1);
            const int qq = qw + 8 * jj + col0 + e;
            const bool live = key >= lo && key < hi && qq < Sq && (!causal || qq >= key);
            p = live ? p : 0.f;   // selected, never exp of a masked logit
          }
          sd[x] = p;
          xp[x * 128 + t] = p;
        }
      }
      named_barrier_arrive(1, C::THREADS);   // p^T is in shared memory
#pragma unroll
      for (int r = 0; r < 16; ++r) fa[r] = pack_bf16(sd[2 * r], sd[2 * r + 1]);
    } else {
      // ds^T = p^T (dp^T - delta) scale
      named_barrier_sync(1, C::THREADS);
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int x = 2 * r;   // queries 8 (x / 4) + col0 and + 1
        const float2 D = *reinterpret_cast<const float2*>(dl_s + 8 * (x >> 2) + col0);
        fa[r] = pack_bf16(xp[x * 128 + t] * (sd[x] - D.x) * scale,
                          xp[(x + 1) * 128 + t] * (sd[x + 1] - D.y) * scale);
      }
    }
    // dV += P^T dO (warpgroup 0) or dK += dS^T Q (1), all 256 columns
    const uint32_t b_cols = wg == 0 ? sdO : sQ;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) fence_operands(acc[hh]);
    wgmma_fence();
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs(acc[hh], fa[4 * kk], fa[4 * kk + 1], fa[4 * kk + 2], fa[4 * kk + 3],
                 desc_mnmajor(b_cols + hh * 2 * BQ * 128, BQ, kk));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) fence_operands(acc[hh]);
  }
  cp_async_wait<0>();

  bf16* out = wg == 0 ? dv : dk;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key >= Sk) continue;
    bf16* orow = out + (((size_t)b * Sk + key) * Hkv + hk) * DH + col0;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int jj = 0; jj < 16; ++jj)
        *reinterpret_cast<uint32_t*>(orow + 128 * hh + 8 * jj) =
            pack_bf16(acc[hh][4 * jj + 2 * i], acc[hh][4 * jj + 2 * i + 1]);
  }
}

// dq at DH 64: s = Q K^T and dp = dO V^T of one warpgroup's 64 rows
// against a 64-key tile, raw (unscaled), one wgmma group (the first steps
// overwrite s and dp)
__device__ __forceinline__ void dq64_scores(float (&s)[32], float (&dp)[32], uint32_t q_tile,
                                            uint32_t do_tile, uint32_t k_tile, uint32_t v_tile) {
  fence_operands(s);
  fence_operands(dp);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_n64(s, desc_kmajor(q_tile, 64, kk), desc_kmajor(k_tile, 64, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_n64(dp, desc_kmajor(do_tile, 64, kk), desc_kmajor(v_tile, 64, kk), kk > 0);
  wgmma_commit();
  fence_operands(s);
  fence_operands(dp);
}

// dq at DH 64: dQ += dS K, dS (64 x 64) as bf16 register A fragments, K
// (64 keys x 64) MN-major; one wgmma group
__device__ __forceinline__ void dq64_ds_k(float (&acc)[32], const uint32_t (&da)[16],
                                          uint32_t k_tile) {
  fence_operands(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_n64(acc, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3],
                 desc_mnmajor(k_tile, 64, kk));
  wgmma_commit();
  fence_operands(acc);
}

// this warp is done reading a stage: its lane 0 arrives at the stage's
// empty barrier (counting every consumer warp)
__device__ __forceinline__ void warp_release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// work item t of the dh-64 dq kernel's walk: its head, batch and first
// query row (causal: the longest Q tiles first; otherwise a (batch,
// head)'s Q tiles one after another, a GQA group's heads side by side, so
// that their K and V tiles come from L2)
__device__ __forceinline__ void dq64_item(int t, int n_qt, int B, int H, int causal, int& h,
                                          int& b, int& q0) {
  if (causal) {
    h = t % H;
    const int r = t / H;
    b = r % B;
    q0 = (n_qt - 1 - r / B) * Dq64::BQ;
  } else {
    q0 = (t % n_qt) * Dq64::BQ;
    const int r = t / n_qt;
    h = r % H;
    b = r / H;
  }
}

// dq at DH 64 (Dq64): one CTA an SM, each walking work items (head, batch,
// 128-row Q tile).  Warpgroup 0 is the producer (thread 0 issues every TMA
// load: an item's Q and dO once its consumers are done with the last
// one's, then its K and V tiles through the ring, which runs on across
// items); warpgroups 1 and 2 are consumers of 64 rows each, with dQ (32
// floats a thread) in registers.  Tile j: s and dp of tile j + 1 run on
// the tensor cores beside dQ += dS_j K_j, and tile j + 1's ds forms while
// that product is in flight; the stage of tile j is released once dQ_j
// has read its K.
__global__ void __launch_bounds__(Dq64::THREADS, 1)
flash_bwd_dq64_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const float* __restrict__ lse,
                      const float* __restrict__ delta, const int* __restrict__ kv_lo,
                      const int* __restrict__ kv_hi, bf16* __restrict__ dq, int B, int H,
                      int Hkv, int Sq, int Sk, int causal, float scale) {
  using C = Dq64;
  constexpr int BQ = C::BQ, BKV = C::BKV, STAGES = C::STAGES, KV_BYTES = C::KV_BYTES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  // buffer qb of Q and dO at base + 2 qb Q_BYTES (Q, then dO)
  const uint32_t sQ = base, sK = base + 4 * C::Q_BYTES, sV = sK + STAGES * KV_BYTES;
  // barriers: the two Q/dO buffers' full and empty; then each stage's
  // full, then its empty
  const uint32_t q_full = base + C::BAR_OFF, q_empty = q_full + 16;
  const uint32_t kv_full = q_empty + 16, kv_empty = kv_full + 8 * STAGES;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int n_qt = (Sq + BQ - 1) / BQ, n_items = n_qt * B * H, rep = H / Hkv;

  if (tid == 0) {
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(q_full + 8 * qb, 1);
      mbar_init(q_empty + 8 * qb, 4 * C::NC);   // every consumer warp
    }
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(kv_full + 8 * st, 1);
      mbar_init(kv_empty + 8 * st, 4 * C::NC);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- the producer
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (tid == 0) {
      int it = 0, n_done = 0;   // K/V tiles loaded, items loaded
      for (int k = 0;; ++k) {
        const int t = persistent_item(k, blockIdx.x, gridDim.x);
        if (t >= n_items) break;
        int h, b, q0;
        dq64_item(t, n_qt, B, H, causal, h, b, q0);
        const int lo = kv_lo ? max(kv_lo[b], 0) : 0;
        const int hi = kv_hi ? min(kv_hi[b], Sk) : Sk;
        const int kv_begin = (lo / BKV) * BKV;
        const int kv_end = causal ? min(hi, q0 + BQ) : hi;
        const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV : 0;
        if (n_tiles == 0) continue;
        const int qb = n_done & 1;   // buffer qb serves items qb, qb + 2, ...
        const uint32_t sq = sQ + 2 * qb * C::Q_BYTES;
        mbar_wait(q_empty + 8 * qb, ((n_done >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(q_full + 8 * qb, 2 * C::Q_BYTES);
        tma_load_4d(sq, &tq, q_full + 8 * qb, 0, h, q0, b);
        tma_load_4d(sq + C::Q_BYTES, &tdo, q_full + 8 * qb, 0, h, q0, b);
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const int st = it % STAGES;
          const int kv0 = kv_begin + j * BKV;
          mbar_wait(kv_empty + 8 * st, ((it / STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(kv_full + 8 * st, 2 * KV_BYTES);
          tma_load_4d(sK + st * KV_BYTES, &tk, kv_full + 8 * st, 0, h / rep, kv0, b);
          tma_load_4d(sV + st * KV_BYTES, &tv, kv_full + 8 * st, 0, h / rep, kv0, b);
        }
        ++n_done;
      }
    }
  } else {
    // ---- a consumer warpgroup: 64 query rows of each item
    setmaxnreg_inc<C::CONSUMER_REGS>();
    const int cw = wg - 1;
    const int col0 = 2 * (lane & 3);
    const float c = scale * LOG2E;
    int it = 0, n_done = 0;   // K/V tiles consumed, items consumed
    for (int k = 0;; ++k) {
      const int t = persistent_item(k, blockIdx.x, gridDim.x);
      if (t >= n_items) break;
      int h, b, q0;
      dq64_item(t, n_qt, B, H, causal, h, b, q0);
      const int lo = kv_lo ? max(kv_lo[b], 0) : 0;
      const int hi = kv_hi ? min(kv_hi[b], Sk) : Sk;
      const int kv_begin = (lo / BKV) * BKV;
      const int kv_end = causal ? min(hi, q0 + BQ) : hi;
      const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV : 0;
      const int wg_row0 = q0 + cw * 64;
      const int row0 = wg_row0 + warp * 16 + (lane >> 2);    // rows row0 and row0 + 8
      float nl2[2], dl[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + 8 * i;
        const size_t idx = ((size_t)b * H + h) * Sq + row;
        nl2[i] = row < Sq ? -lse[idx] * LOG2E : 0.f;
        dl[i] = row < Sq ? delta[idx] : 0.f;
      }
      // a tile needs the mask where it crosses a window edge, the end of
      // the keys or this warpgroup's causal diagonal
      auto masked_at = [&](int kv0) {
        return kv0 < lo || kv0 + BKV > hi || (causal && kv0 + BKV - 1 > wg_row0);
      };

      float acc[32], s[32], dp[32];
#pragma unroll
      for (int x = 0; x < 32; ++x) acc[x] = 0.f;
      uint32_t da[16];   // dS of the current tile as bf16 register A fragments

      if (n_tiles > 0) {
        const int qb = n_done & 1;
        const uint32_t sQw = sQ + 2 * qb * C::Q_BYTES + cw * 64 * 128;
        const uint32_t sdOw = sQw + C::Q_BYTES, q_free = q_empty + 8 * qb;
        mbar_wait(q_full + 8 * qb, (n_done >> 1) & 1);
        mbar_wait(kv_full + 8 * (it % STAGES), (it / STAGES) & 1);
        dq64_scores(s, dp, sQw, sdOw, sK + (it % STAGES) * KV_BYTES,
                    sV + (it % STAGES) * KV_BYTES);
        wgmma_wait<0>();
        fence_operands(s);
        fence_operands(dp);
        if (n_tiles == 1) warp_release(q_free, lane);   // Q and dO's last products
        dq64_ds(s, dp, masked_at(kv_begin), kv_begin, row0, col0, lo, hi, causal, c, nl2, dl,
              scale);
#pragma unroll
        for (int r = 0; r < 16; ++r) da[r] = pack_bf16(s[2 * r], s[2 * r + 1]);
        // Tile j: s and dp of tile j + 1 beside dQ += dS_j K_j; the last
        // tile (dQ += dS K only) is peeled off
        for (int j = 0; j + 1 < n_tiles; ++j) {
          const int i0 = it + j, i1 = i0 + 1;
          const int sn = i1 % STAGES, sj = i0 % STAGES;
          mbar_wait(kv_full + 8 * sn, (i1 / STAGES) & 1);
          dq64_scores(s, dp, sQw, sdOw, sK + sn * KV_BYTES, sV + sn * KV_BYTES);
          dq64_ds_k(acc, da, sK + sj * KV_BYTES);
          wgmma_wait<1>();   // s and dp of tile j + 1 are done; dS_j K_j may still run
          fence_operands(s);
          fence_operands(dp);
          if (j + 2 == n_tiles) warp_release(q_free, lane);   // Q and dO's last products
          const int kv_next = kv_begin + (j + 1) * BKV;
          dq64_ds(s, dp, masked_at(kv_next), kv_next, row0, col0, lo, hi, causal, c, nl2, dl,
                scale);
          wgmma_wait<0>();
          fence_operands(acc);
          warp_release(kv_empty + 8 * sj, lane);
#pragma unroll
          for (int r = 0; r < 16; ++r) da[r] = pack_bf16(s[2 * r], s[2 * r + 1]);
        }
        const int il = it + n_tiles - 1;
        dq64_ds_k(acc, da, sK + (il % STAGES) * KV_BYTES);
        wgmma_wait<0>();
        fence_operands(acc);
        warp_release(kv_empty + 8 * (il % STAGES), lane);
        it += n_tiles;
        ++n_done;
      }

#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + 8 * i;
        if (row >= Sq) continue;
        bf16* drow = dq + (((size_t)b * Sq + row) * H + h) * 64 + col0;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          *reinterpret_cast<uint32_t*>(drow + 8 * jj) =
              pack_bf16(acc[4 * jj + 2 * i], acc[4 * jj + 2 * i + 1]);
      }
    }
  }
}

// dk/dv at DH 64 (Dkv64): one CTA per work item (kv head, batch,
// 128-key tile), the longest causal walks first.  (A persistent walk
// cannot balance the key tiles that windows leave empty, and at long
// causal walks it was slower too: PERF.md.)  Warpgroup 0 is the
// producer: thread 0 loads K and V of the CTA's keys and each item's Q and
// dO blocks by TMA, and the producer's first warp copies the item's lse
// and delta (64 floats each, zero past Sq) by cp.async, each lane
// arriving at the stage's full barrier once its copies land.  Consumer
// warpgroup w owns keys kv0 + 64 w .. kv0 + 64 w + 63, its dK and dV in
// registers for the whole walk over the items (group head, live 64-query
// block, from the diagonal when causal), which it takes from the ring at
// its own pace: no warpgroup waits for another.  A key's dK and dV sum
// the items in the walk's order on every run, and nothing is summed
// across warpgroups.
__global__ void __launch_bounds__(Dkv64::THREADS, 1)
flash_bwd_dkv64_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const float* __restrict__ lse,
                       const float* __restrict__ delta, const int* __restrict__ kv_lo,
                       const int* __restrict__ kv_hi, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int H, int Hkv, int Sq, int Sk, int causal,
                       float scale) {
  using C = Dkv64;
  constexpr int BKV = C::BKV, BQ = C::BQ, KEYS = C::KEYS, RING = C::RING;
  constexpr int Q_BYTES = C::Q_BYTES, STAGE = C::STAGE;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));   // generic view of base
  // K and V of the CTA's keys (one KEYS-row tile each), then the ring
  const uint32_t sK = base, sV = base + C::KV_BYTES, ring = sV + C::KV_BYTES;
  const float* ring_f = reinterpret_cast<const float*>(gbase + 2 * C::KV_BYTES);
  // barriers: K and V's full; then each stage's full, then its empty
  const uint32_t kv_full = base + C::BAR_OFF;
  const uint32_t it_full = kv_full + 8, it_empty = it_full + 8 * RING;

  // causal: the key tile counts up slowest (the longest walks first), then
  // the batch, then the kv head
  const int hk = blockIdx.x, b = blockIdx.y, kv0 = blockIdx.z * KEYS;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int rep = H / Hkv;

  const int lo = kv_lo ? max(kv_lo[b], 0) : 0;
  const int hi = kv_hi ? min(kv_hi[b], Sk) : Sk;
  // a key range with no key inside [lo, hi) gets no live pair: dk, dv are
  // 0.  Causal: query blocks wholly above the CTA's diagonal are dead (kv0
  // is a multiple of BQ)
  const bool tile_live = kv0 < hi && kv0 + KEYS > lo;
  const int q_begin = causal ? kv0 : 0;
  const int n_qb = tile_live && q_begin < Sq ? (Sq - q_begin + BQ - 1) / BQ : 0;
  const int n_it = rep * n_qb;

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < RING; ++st) {
      mbar_init(it_full + 8 * st, 1 + 32);      // the TMA's arrival and 32 lanes' copies
      mbar_init(it_empty + 8 * st, 4 * C::NWG);    // every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- the producer: its first warp
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (warp == 0 && n_it > 0) {
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_full, 2 * C::KV_BYTES);
        tma_load_4d(sK, &tk, kv_full, 0, hk, kv0, b);
        tma_load_4d(sV, &tv, kv_full, 0, hk, kv0, b);
      }
      for (int i = 0; i < n_it; ++i) {   // item i: group head i / n_qb, block i % n_qb
        const int st = i % RING;
        const int hq = hk * rep + i / n_qb;
        const int qb0 = q_begin + (i % n_qb) * BQ;
        const uint32_t sq = ring + st * STAGE;
        mbar_wait(it_empty + 8 * st, ((i / RING) & 1) ^ 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(it_full + 8 * st, 2 * Q_BYTES);
          tma_load_4d(sq, &tq, it_full + 8 * st, 0, hq, qb0, b);
          tma_load_4d(sq + Q_BYTES, &tdo, it_full + 8 * st, 0, hq, qb0, b);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {   // lse (then delta) of queries lane, lane + 32
          const int c = lane + 32 * e;
          const bool valid = qb0 + c < Sq;
          const size_t idx = ((size_t)b * H + hq) * Sq + (valid ? qb0 + c : 0);
          cp_async_4(sq + 2 * Q_BYTES + c * 4, lse + idx, valid);
          cp_async_4(sq + 2 * Q_BYTES + BQ * 4 + c * 4, delta + idx, valid);
        }
        mbar_arrive_cp_async(it_full + 8 * st);
      }
    }
  } else {
    // ---- a consumer warpgroup: 64 keys
    setmaxnreg_inc<C::CONSUMER_REGS>();
    const int cw = wg - 1;
    const int kw0 = kv0 + cw * BKV;   // this warpgroup's 64 keys
    const bool wg_live = kw0 < hi && kw0 + BKV > lo;
    const int key0 = kw0 + warp * 16 + (lane >> 2);   // keys key0 and key0 + 8 (rows of s^T)
    const int col0 = 2 * (lane & 3);
    const uint32_t sKw = sK + cw * BKV * 128, sVw = sV + cw * BKV * 128;
    float dka[32], dva[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) dka[x] = dva[x] = 0.f;

    if (n_it > 0) mbar_wait(kv_full, 0);
    for (int i = 0; i < n_it; ++i) {
      const int st = i % RING;
      // every consumer waits for every item, live for it or not, so that
      // its arrival counts toward this item's release
      mbar_wait(it_full + 8 * st, (i / RING) & 1);
      const int qw = q_begin + (i % n_qb) * BQ;   // this item's 64 queries
      if (wg_live && !(causal && qw + BQ - 1 < kw0)) {
        const uint32_t sQw = ring + st * STAGE;
        const float* lse_s = ring_f + st * (STAGE / 4) + 2 * Q_BYTES / 4;
        const bool masked = kw0 < lo || kw0 + BKV > hi || qw + BQ > Sq ||
                            (causal && kw0 + BKV - 1 > qw);
        dkv_item<64>(dka, dva, sKw, sVw, sQw, sQw + Q_BYTES, 0, lse_s, lse_s + BQ, masked,
                     key0, col0, qw, lo, hi, Sq, causal, scale);
      }
      warp_release(it_empty + 8 * st, lane);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = key0 + 8 * i;
      if (key >= Sk) continue;
      const size_t off = (((size_t)b * Sk + key) * Hkv + hk) * 64 + col0;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        *reinterpret_cast<uint32_t*>(dk + off + 8 * jj) =
            pack_bf16(dka[4 * jj + 2 * i], dka[4 * jj + 2 * i + 1]);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * jj) =
            pack_bf16(dva[4 * jj + 2 * i], dva[4 * jj + 2 * i + 1]);
      }
    }
  }
}

template <int DH>
int delta_launch(const void* dout, const void* out, const void* g_lse, void* delta, int B,
                 int H, int Sq, void* stream) {
  const long rows = (long)B * Sq * H;
  const unsigned blocks = (unsigned)((rows * DELTA_CH<DH> + 255) / 256);
  flash_bwd_delta_kernel<DH><<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(dout), static_cast<const __nv_bfloat16*>(out),
      static_cast<const float*>(g_lse), static_cast<float*>(delta), H, Sq, rows);
  return (int)cudaGetLastError();
}

template <int DH>
int dq_launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, const void* kv_lo, const void* kv_hi, void* dq, int B, int H,
              int Hkv, int Sq, int Sk, int causal, float scale, void* stream) {
  using C = Dq<DH>;
  cudaFuncSetAttribute(flash_bwd_dq_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       C::SMEM);
  dim3 grid(H, B, (Sq + C::BQ - 1) / C::BQ);
  flash_bwd_dq_kernel<DH><<<grid, C::THREADS, C::SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(kv_lo),
      static_cast<const int*>(kv_hi), static_cast<bf16*>(dq), H, Hkv, Sq, Sk, causal, scale);
  return (int)cudaGetLastError();
}

template <int DH>
int dkv_launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, const void* kv_lo, const void* kv_hi, void* dk, void* dv,
               int B, int H, int Hkv, int Sq, int Sk, int causal, float scale, void* stream) {
  using C = Dkv<DH>;
  cudaFuncSetAttribute(flash_bwd_dkv_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       C::SMEM);
  dim3 grid(Hkv, B, (Sk + C::BKV - 1) / C::BKV);
  flash_bwd_dkv_kernel<DH><<<grid, C::THREADS, C::SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(kv_lo),
      static_cast<const int*>(kv_hi), static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Hkv,
      Sq, Sk, causal, scale);
  return (int)cudaGetLastError();
}

// the two dh-256 kernels, one CTA per 64-row Q tile or 64-key tile
int dq256_launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                 const void* delta, const void* kv_lo, const void* kv_hi, void* dq, int B, int H,
                 int Hkv, int Sq, int Sk, int causal, float scale, void* stream) {
  using C = Dq256;
  cudaFuncSetAttribute(flash_bwd_dq256_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       C::SMEM);
  dim3 grid(H, B, (Sq + C::BQ - 1) / C::BQ);
  flash_bwd_dq256_kernel<<<grid, C::THREADS, C::SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(kv_lo),
      static_cast<const int*>(kv_hi), static_cast<bf16*>(dq), H, Hkv, Sq, Sk, causal, scale);
  return (int)cudaGetLastError();
}

int dkv256_launch(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, const void* kv_lo, const void* kv_hi,
                  void* dk, void* dv, int B, int H, int Hkv, int Sq, int Sk, int causal,
                  float scale, void* stream) {
  using C = Dkv256;
  cudaFuncSetAttribute(flash_bwd_dkv256_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       C::SMEM);
  dim3 grid(Hkv, B, (Sk + C::BKV - 1) / C::BKV);
  flash_bwd_dkv256_kernel<<<grid, C::THREADS, C::SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(kv_lo),
      static_cast<const int*>(kv_hi), static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Hkv,
      Sq, Sk, causal, scale);
  return (int)cudaGetLastError();
}

// the dq kernel at dh 64: one CTA an SM (or a work item); the tensor maps
// are built here, on the host, each call
int dq64_launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                const void* delta, const void* kv_lo, const void* kv_hi, void* dq, int B, int H,
                int Hkv, int Sq, int Sk, int causal, float scale, void* stream) {
  using C = Dq64;
  CUtensorMap tq, tdo, tk, tv;
  if (!bf16_head64_map(&tq, q, B, Sq, H, C::BQ) || !bf16_head64_map(&tdo, dout, B, Sq, H, C::BQ) ||
      !bf16_head64_map(&tk, k, B, Sk, Hkv, C::BKV) || !bf16_head64_map(&tv, v, B, Sk, Hkv, C::BKV))
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(flash_bwd_dq64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       C::SMEM);
  const int n_items = (Sq + C::BQ - 1) / C::BQ * B * H;
  flash_bwd_dq64_kernel<<<max(min(n_items, sm_count()), 1), C::THREADS, C::SMEM,
                          static_cast<cudaStream_t>(stream)>>>(
      tq, tdo, tk, tv, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(kv_lo), static_cast<const int*>(kv_hi), static_cast<bf16*>(dq), B,
      H, Hkv, Sq, Sk, causal, scale);
  return (int)cudaGetLastError();
}

// the dk/dv kernel at dh 64: a CTA a 128-key tile
int dkv64_launch(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, const void* kv_lo, const void* kv_hi,
                 void* dk, void* dv, int B, int H, int Hkv, int Sq, int Sk, int causal,
                 float scale, void* stream) {
  using C = Dkv64;
  CUtensorMap tq, tdo, tk, tv;
  if (!bf16_head64_map(&tq, q, B, Sq, H, C::BQ) || !bf16_head64_map(&tdo, dout, B, Sq, H, C::BQ) ||
      !bf16_head64_map(&tk, k, B, Sk, Hkv, C::KEYS) ||
      !bf16_head64_map(&tv, v, B, Sk, Hkv, C::KEYS))
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(flash_bwd_dkv64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       C::SMEM);
  dim3 grid(Hkv, B, (Sk + C::KEYS - 1) / C::KEYS);
  flash_bwd_dkv64_kernel<<<grid, C::THREADS, C::SMEM, static_cast<cudaStream_t>(stream)>>>(
      tq, tdo, tk, tv, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(kv_lo), static_cast<const int*>(kv_hi), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, Hkv, Sq, Sk, causal, scale);
  return (int)cudaGetLastError();
}

// one kernel's six resource ints (see flash_bwd_resources)
int kernel_resources(const void* fn, int smem, int threads, int* r) {
  if (smem) cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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
int bwd_resources(int* res) {
  int err = kernel_resources((const void*)flash_bwd_delta_kernel<DH>, 0, 256, res);
  if (err) return err;
  if constexpr (DH == 256) {
    err = kernel_resources((const void*)flash_bwd_dq256_kernel, Dq256::SMEM, Dq256::THREADS,
                           res + 6);
    return err ? err
               : kernel_resources((const void*)flash_bwd_dkv256_kernel, Dkv256::SMEM,
                                  Dkv256::THREADS, res + 12);
  } else if constexpr (DH == 64) {
    err = kernel_resources((const void*)flash_bwd_dq64_kernel, Dq64::SMEM, Dq64::THREADS,
                           res + 6);
    return err ? err
               : kernel_resources((const void*)flash_bwd_dkv64_kernel, Dkv64::SMEM,
                                  Dkv64::THREADS, res + 12);
  } else {
    err = kernel_resources((const void*)flash_bwd_dq_kernel<DH>, Dq<DH>::SMEM, Dq<DH>::THREADS,
                           res + 6);
    return err ? err
               : kernel_resources((const void*)flash_bwd_dkv_kernel<DH>, Dkv<DH>::SMEM,
                                  Dkv<DH>::THREADS, res + 12);
  }
}

}  // namespace

extern "C" {

// dout/out (B, Sq, H, DH) bf16 with DH 64, 128 or 256; g_lse (B, H, Sq) f32
// or null; delta (B, H, Sq) f32.  Returns cudaGetLastError() (or
// cudaErrorInvalidValue for another DH).
int flash_bwd_delta_launch(const void* dout, const void* out, const void* g_lse,
                           void* delta, int B, int H, int Sq, int DH, void* stream) {
  if (DH == 64) return delta_launch<64>(dout, out, g_lse, delta, B, H, Sq, stream);
  if (DH == 128) return delta_launch<128>(dout, out, g_lse, delta, B, H, Sq, stream);
  if (DH == 256) return delta_launch<256>(dout, out, g_lse, delta, B, H, Sq, stream);
  return (int)cudaErrorInvalidValue;
}

// q/dout (B, Sq, H, DH) bf16; k/v (B, Sk, Hkv, DH) bf16; lse/delta
// (B, H, Sq) f32; kv_lo/kv_hi (B,) int32 or null; dq (B, Sq, H, DH) bf16.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for another DH or
// where the dh-64 kernels' tensor maps are refused (q, k, v or dout not
// 16-byte aligned).
int flash_bwd_dq_launch(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, const void* kv_lo,
                        const void* kv_hi, void* dq, int B, int H, int Hkv, int Sq, int Sk,
                        int DH, int causal, float scale, void* stream) {
  if (DH == 64)
    return dq64_launch(q, k, v, dout, lse, delta, kv_lo, kv_hi, dq, B, H, Hkv, Sq, Sk, causal,
                       scale, stream);
  if (DH == 128)
    return dq_launch<128>(q, k, v, dout, lse, delta, kv_lo, kv_hi, dq, B, H, Hkv, Sq, Sk,
                          causal, scale, stream);
  if (DH == 256)
    return dq256_launch(q, k, v, dout, lse, delta, kv_lo, kv_hi, dq, B, H, Hkv, Sq, Sk, causal,
                        scale, stream);
  return (int)cudaErrorInvalidValue;
}

// as above; dk/dv (B, Sk, Hkv, DH) bf16, summed over the G = H / Hkv
// query heads of each kv head.
int flash_bwd_dkv_launch(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, const void* kv_lo,
                         const void* kv_hi, void* dk, void* dv, int B, int H, int Hkv, int Sq,
                         int Sk, int DH, int causal, float scale, void* stream) {
  if (DH == 64)
    return dkv64_launch(q, k, v, dout, lse, delta, kv_lo, kv_hi, dk, dv, B, H, Hkv, Sq, Sk,
                        causal, scale, stream);
  if (DH == 128)
    return dkv_launch<128>(q, k, v, dout, lse, delta, kv_lo, kv_hi, dk, dv, B, H, Hkv, Sq, Sk,
                           causal, scale, stream);
  if (DH == 256)
    return dkv256_launch(q, k, v, dout, lse, delta, kv_lo, kv_hi, dk, dv, B, H, Hkv, Sq, Sk,
                         causal, scale, stream);
  return (int)cudaErrorInvalidValue;
}

// The three kernels' resources (delta, dq, dk/dv) at DH 128, 256, then 64,
// six ints each: registers per thread (at launch; the dh-64 kernels
// rebalance them, see flash_bwd64_regs), static shared bytes, dynamic
// shared bytes, local (spill) bytes per thread, threads per CTA, CTAs per
// SM.  Returns the first CUDA error.
int flash_bwd_resources(int* res) {
  int err = bwd_resources<128>(res);
  if (!err) err = bwd_resources<256>(res + 18);
  return err ? err : bwd_resources<64>(res + 36);
}

// The dh-64 dq and dk/dv kernels' registers a thread after setmaxnreg:
// dq's producer and consumers, then the dk/dv kernel's.
int flash_bwd64_regs(int* r) {
  r[0] = Dq64::PRODUCER_REGS;
  r[1] = Dq64::CONSUMER_REGS;
  r[2] = Dkv64::PRODUCER_REGS;
  r[3] = Dkv64::CONSUMER_REGS;
  return 0;
}

}  // extern "C"
