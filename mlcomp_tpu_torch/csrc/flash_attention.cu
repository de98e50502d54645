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
// There is no producer warp at DH 128 and 256: all 256 threads issue the
// copies, so none holds registers the products need (up to 255 a thread,
// one CTA per SM) and no register rebalancing is required.
//
// Head dims.  The kernel is a template on the head dim DH, instantiated at
// 128 (the tiles above) and 256; DH = 64 has a kernel of its own
// (`flash_fwd64_kernel`, below).  The wrapper passes bf16 heads of 64 or
// less to the dh-64 kernel (d < 64 zero-pads to 64), 64 < d <= 128 to 128
// and 128 < d <= 256 to 256.  The TPU wrapper pads every head to its 128
// lanes; Hopper has no such constraint, and at dh 64 padding doubled every
// product and byte and added a copy an operand.  At
// DH = 256 the 128-key tiles do not fit (Q and two stages of K and V would
// take 320 KB of shared memory against 227 KB, and a 64 x 256 O beside a
// 64 x 128 S would spill): K/V tiles shrink to 64 keys (a 64 KB Q tile and
// two stages of 32 KB K and V tiles, 193 KB), S to 32 registers (m64n64),
// and O is two 64 x 128 accumulators, each a P V product against one half
// of the V tile.
//
// DH = 64.  What bounds it: at dh 64 a 128-key tile costs a warpgroup as
// many exp2 on the SFU (16 a clock an SM) as its two products take on the
// tensor cores, and the softmax's other f32 instructions as many again, so
// the card's rate needs the softmax hidden under the products.  Probes of
// this kernel at 1 x 32768 (PERF.md): without the softmax 2.79 ms
// against 6.98 (the products alone near 0.8 of the bound); without the
// exp2 or the P V product or with every CTA reading one K/V tile, 3-7%
// faster: the softmax's instructions hold it, not the loads or the SFU.
// The instance before this one (cp.async by all threads, a CTA-wide
// barrier every 64 keys, each warpgroup waiting for its own products
// before its softmax) reached 27% of the bound there.  The design,
// FlashAttention-3's schedule:
// - warp specialisation: a CTA is two consumer warpgroups of 64 query rows
//   (128 rows, which BERT's 128 and ViT's 196 keys waste little of) and
//   one producer warpgroup, of which one thread issues every load.  The
//   producer gives its registers away (setmaxnreg.dec to 40) and the
//   consumers take them (setmaxnreg.inc to 232), so S (64 x 128: 64
//   floats), P (32 registers of bf16 pairs) and O (32 floats) live at
//   once without a spill;
// - persistent: one CTA an SM walks its share of the Q tiles (tma.cuh),
//   the longest causal ones first, so an item's loads run beside the last
//   item's products and stores (BERT and ViT are a few tiles an item);
// - loads by TMA (tma.cuh): Q into one of two buffers, then K and V tiles
//   of 128 keys into rings of three stages each, 128-byte swizzled as
//   `desc_kmajor` / `desc_mnmajor` read them; rows past S arrive
//   zero-filled.  Each stage has a full mbarrier (the TMA's bytes) and an
//   empty one (an arrival from every consumer warp once its products have
//   read the stage): K_j is released as soon as S_j is done, V_j once P_j
//   V_j is.  There is no CTA-wide barrier after the barriers'
//   initialisation;
// - inside a warpgroup, tile j issues S_{j+1} = Q K_{j+1}^T and O += P_j
//   V_j back to back, waits for S_{j+1} alone and runs its softmax while
//   P_j V_j is on the tensor cores; O is rescaled once P_j V_j retires;
// - between warpgroups, two named barriers order the product issues ping-
//   pong: warpgroup w issues after the other has issued its own, so one's
//   softmax runs beside the other's products;
// - the mask is a template argument of the softmax (`softmax_tile64`): a
//   runtime test inside the unrolled loop left its arithmetic on every
//   element of every tile (7.70-7.79 ms at 1 x 32768 against 5.43-5.50).
// Tried and dropped (PERF.md): three consumer warpgroups (160 registers a
// thread: spills, slower), 64-key tiles, one CTA a Q tile (slower at BERT
// and ViT), two or four stages (no change), a quarter of the exp2 on the
// FMA pipe by a polynomial (1% faster at 1 x 32768, 4-11% slower at ViT
// and 8 x 1024); in the instance before this one
// copy-completed mbarriers with every thread still copying and the
// CTA-wide barrier kept (slower, 24 bytes of spill).
//
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

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// the tiles of one head dim (128 or 256): query rows (64 a warpgroup) and
// keys a tile, S accumulators a thread, O accumulators (ON columns each),
// shared memory
template <int DH>
struct Fwd {
  static_assert(DH == 128 || DH == 256, "the forward at DH 64: Fwd64");
  static constexpr int BQ = 128, THREADS = 2 * BQ;
  static constexpr int BKV = DH == 128 ? 128 : 64;
  static constexpr int NS = BKV / 2;          // S (64 x BKV) floats a thread
  static constexpr int ON = 128;
  static constexpr int NO = DH / ON;          // O accumulators of 64 x ON
  static constexpr int Q_BYTES = BQ * DH * 2;
  static constexpr int KV_BYTES = BKV * DH * 2;
  // Q, then two stages of K and of V; 1024 bytes of slack to align the base
  static constexpr int SMEM_BYTES = Q_BYTES + 4 * KV_BYTES + 1024;
};
// the forward at DH 64: NC = 2 consumer warpgroups of 64 query rows and
// one producer warpgroup, one CTA an SM walking its share of the Q tiles;
// two Q buffers (an item's Q lands while the last item's is still read);
// K and V tiles of BKV keys in rings of STAGES; the barriers (the Q
// buffers' full and empty, then full and empty of each K and V stage)
// after the tiles
struct Fwd64 {
  static constexpr int NC = 2, BQ = 64 * NC, BKV = 128, STAGES = 3;
  static constexpr int NS = BKV / 2;   // S (64 x BKV) floats a thread
  static constexpr int THREADS = 128 * (NC + 1);
  // setmaxnreg: the producer's and consumers' registers within the CTA's
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  static constexpr int Q_BYTES = BQ * 128, KV_BYTES = BKV * 128;
  static constexpr int BAR_OFF = 2 * Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int SMEM_BYTES = BAR_OFF + 8 * (4 + 4 * STAGES) + 1024;
};
static_assert(Fwd64::SMEM_BYTES <= 232448, "shared memory of one CTA");
static_assert(128 * Fwd64::PRODUCER_REGS + 128 * Fwd64::NC * Fwd64::CONSUMER_REGS <=
                  launch_regs(Fwd64::THREADS) * Fwd64::THREADS,
              "the rebalanced registers fit the CTA's");
static_assert(Fwd<128>::SMEM_BYTES <= 232448 && Fwd<256>::SMEM_BYTES <= 232448,
              "shared memory of one CTA");

// S = Q K^T for one warpgroup's 64 rows and one tile of BKV keys, raw
// (unscaled) logits, issued and committed as one wgmma group
// (the first step overwrites s: no instruction but wgmma defines it, so
// ptxas keeps the products asynchronous)
template <int DH>
__device__ __forceinline__ void qk_tile(float (&s)[Fwd<DH>::NS], uint32_t q_tile,
                                        uint32_t k_tile) {
  fence_operands(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_ss(s, desc_kmajor(q_tile, Fwd<DH>::BQ, kk), desc_kmajor(k_tile, Fwd<DH>::BKV, kk),
             kk > 0);
  wgmma_commit();
  fence_operands(s);
}

// O += P V for one warpgroup: P (64 x BKV) as bf16 register A fragments,
// V (BKV keys x DH) MN-major, one 64 x ON accumulator an ON-column slice
// (ON / 64 column blocks of the tile); issued and committed as one wgmma
// group
template <int DH>
__device__ __forceinline__ void pv_tile(float (&o)[Fwd<DH>::NO][Fwd<DH>::ON / 2],
                                        const uint32_t (&pa)[Fwd<DH>::NS / 2],
                                        uint32_t v_tile) {
  constexpr int BKV = Fwd<DH>::BKV, ON = Fwd<DH>::ON;
#pragma unroll
  for (int hh = 0; hh < Fwd<DH>::NO; ++hh) fence_operands(o[hh]);
  wgmma_fence();
#pragma unroll
  for (int hh = 0; hh < Fwd<DH>::NO; ++hh)
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      wgmma_rs(o[hh], pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
               desc_mnmajor(v_tile + hh * (ON / 64) * BKV * 128, BKV, kk));
  wgmma_commit();
#pragma unroll
  for (int hh = 0; hh < Fwd<DH>::NO; ++hh) fence_operands(o[hh]);
}

// The online softmax of one tile of raw logits, in place: masks (only when
// `masked`), moves the running max m (raw units) and sum l, returns each
// row's rescale factor in alpha and leaves p = exp((s - m) * scale) in s,
// selected to 0 on masked logits
template <int NS>
__device__ __forceinline__ void softmax_tile(float (&s)[NS], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool masked, int kv0, int row0,
                                             int col0, int lo, int hi, int causal, float c) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int x = 0; x < NS; ++x) {
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
  for (int x = 0; x < NS; ++x) {
    const int i = (x >> 1) & 1;
    float p = ex2(fmaf(s[x], c, mneg[i]));
    if (masked) p = s[x] > NEG_INF / 2 ? p : 0.f;   // selected, never exp of a mask
    s[x] = p;
    ps[i] += p;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + ps[i];
}

// softmax_tile for the dh-64 forward: the same arithmetic, but the mask is
// a template argument, so that a tile that needs none carries no mask
// arithmetic (in softmax_tile's loop the runtime test leaves it on every
// element: the dh-64 forward at 1 x 32768 took 7.70-7.79 ms with it,
// 5.43-5.50 without, PERF.md), and each row's maximum and sum run as
// CH partial chains (the 8-column group k goes to chain k % CH), added at
// the end, so that the dependent chains are CH times shorter
template <int NS, int CH, bool MASKED>
__device__ __forceinline__ void softmax_tile64_body(float (&s)[NS], float (&m)[2], float (&l)[2],
                                                    float (&alpha)[2], int kv0, int row0,
                                                    int col0, int lo, int hi, int causal,
                                                    float c) {
  float mx[CH][2], ps[CH][2];
#pragma unroll
  for (int k = 0; k < CH; ++k)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[k][i] = m[i];
      ps[k][i] = 0.f;
    }
#pragma unroll
  for (int x = 0; x < NS; ++x) {
    if (MASKED) {
      const int col = kv0 + 8 * (x >> 2) + col0 + (x & 1);
      const int row = row0 + 8 * ((x >> 1) & 1);
      const bool live = col >= lo && col < hi && (!causal || row >= col);
      s[x] = live ? s[x] : NEG_INF;
    }
    float& mk = mx[(x >> 2) % CH][(x >> 1) & 1];
    mk = fmaxf(mk, s[x]);
  }
  float mneg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float r = mx[0][i];
#pragma unroll
    for (int k = 1; k < CH; ++k) r = fmaxf(r, mx[k][i]);
    r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 1));
    r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 2));
    alpha[i] = ex2((m[i] - r) * c);
    m[i] = r;
    mneg[i] = -r * c;
  }
#pragma unroll
  for (int x = 0; x < NS; ++x) {
    const int i = (x >> 1) & 1;
    float p = ex2(fmaf(s[x], c, mneg[i]));
    if (MASKED) p = s[x] > NEG_INF / 2 ? p : 0.f;   // selected, never exp of a mask
    s[x] = p;
    ps[(x >> 2) % CH][i] += p;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float t = ps[0][i];
#pragma unroll
    for (int k = 1; k < CH; ++k) t += ps[k][i];
    l[i] = l[i] * alpha[i] + t;
  }
}

template <int NS>
__device__ __forceinline__ void softmax_tile64(float (&s)[NS], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], bool masked, int kv0,
                                               int row0, int col0, int lo, int hi, int causal,
                                               float c) {
  constexpr int CH = 4;
  if (masked)
    softmax_tile64_body<NS, CH, true>(s, m, l, alpha, kv0, row0, col0, lo, hi, causal, c);
  else
    softmax_tile64_body<NS, CH, false>(s, m, l, alpha, kv0, row0, col0, lo, hi, causal, c);
}

template <int DH>
__global__ void __launch_bounds__(Fwd<DH>::THREADS, 1)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ kv_lo,
                 const int* __restrict__ kv_hi, bf16* __restrict__ out,
                 float* __restrict__ lse, int H, int Hkv, int Sq, int Sk, int causal,
                 float scale) {
  using C = Fwd<DH>;
  constexpr int BQ = C::BQ, THREADS = C::THREADS, BKV = C::BKV, NS = C::NS, NO = C::NO;
  constexpr int OR = C::ON / 2;
  constexpr int Q_BYTES = C::Q_BYTES, KV_BYTES = C::KV_BYTES;
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
  load_tile<BQ, THREADS, DH>(sQ, q + ((size_t)b * Sq * H + h) * DH, q0, Sq, q_stride, tid);
  if (n_tiles > 0) {
    load_tile<BKV, THREADS, DH>(sK, kb, kv_begin, Sk, kv_stride, tid);
    load_tile<BKV, THREADS, DH>(sV, vb, kv_begin, Sk, kv_stride, tid);
  }
  if (n_tiles > 1)
    load_tile<BKV, THREADS, DH>(sK + KV_BYTES, kb, kv_begin + BKV, Sk, kv_stride, tid);
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

  float o[NO][OR], s[NS];
#pragma unroll
  for (int hh = 0; hh < NO; ++hh)
#pragma unroll
    for (int x = 0; x < OR; ++x) o[hh][x] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];
  uint32_t pa[NS / 2];   // P of the current tile as bf16 register A fragments

  if (n_tiles > 0) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    qk_tile<DH>(s, sQw, sK);
    wgmma_wait<0>();
    fence_operands(s);
    softmax_tile<NS>(s, m, l, alpha, masked_at(kv_begin), kv_begin, row0, col0, lo, hi,
                     causal, c);
#pragma unroll
    for (int r = 0; r < NS / 2; ++r) pa[r] = pack_bf16(s[2 * r], s[2 * r + 1]);
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
      load_tile<BKV, THREADS, DH>(sK + (j & 1) * KV_BYTES, kb, kv_next + BKV, Sk, kv_stride,
                                  tid);
    load_tile<BKV, THREADS, DH>(sV + ((j + 1) & 1) * KV_BYTES, vb, kv_next, Sk, kv_stride,
                                tid);
    cp_async_commit();

    qk_tile<DH>(s, sQw, sK + ((j + 1) & 1) * KV_BYTES);
    pv_tile<DH>(o, pa, sV + (j & 1) * KV_BYTES);
    wgmma_wait<0>();
    fence_operands(s);
#pragma unroll
    for (int hh = 0; hh < NO; ++hh) fence_operands(o[hh]);
    softmax_tile<NS>(s, m, l, alpha, masked_at(kv_next), kv_next, row0, col0, lo, hi, causal,
                     c);
#pragma unroll
    for (int hh = 0; hh < NO; ++hh) {
#pragma unroll
      for (int x = 0; x < OR; ++x) o[hh][x] *= alpha[(x >> 1) & 1];
      fence_operands(o[hh]);
    }
#pragma unroll
    for (int r = 0; r < NS / 2; ++r) pa[r] = pack_bf16(s[2 * r], s[2 * r + 1]);
  }
  if (n_tiles > 0) {
    cp_async_wait<0>();   // V of the last tile
    fence_proxy_async();
    __syncthreads();
    pv_tile<DH>(o, pa, sV + ((n_tiles - 1) & 1) * KV_BYTES);
    wgmma_wait<0>();
#pragma unroll
    for (int hh = 0; hh < NO; ++hh) fence_operands(o[hh]);
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
    for (int hh = 0; hh < NO; ++hh)
#pragma unroll
      for (int jj = 0; jj < OR / 4; ++jj) {
        const uint32_t pr =
            pack_bf16(o[hh][4 * jj + 2 * i] * inv, o[hh][4 * jj + 2 * i + 1] * inv);
        *reinterpret_cast<uint32_t*>(orow + 2 * OR * hh + 8 * jj) = pr;
      }
    // m is in raw logit units: lse = m * scale + log(l), and -1e30 + log(1)
    // for a row that saw no live key
    const float ms = m[i] > NEG_INF / 2 ? m[i] * scale : NEG_INF;
    if ((lane & 3) == 0) lse[((size_t)b * H + h) * Sq + row] = ms + logf(ls);
  }
}

// S = Q K^T at DH 64 for one warpgroup's 64 rows and a 128-key tile, raw
// logits, one wgmma group (the first step overwrites s)
__device__ __forceinline__ void qk_tile64(float (&s)[64], uint32_t q_tile, uint32_t k_tile) {
  fence_operands(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_n128(s, desc_kmajor(q_tile, 64, kk), desc_kmajor(k_tile, 128, kk), kk > 0);
  wgmma_commit();
  fence_operands(s);
}

// O += P V at DH 64: P (64 x 128) as bf16 register A fragments, V (128
// keys x 64) MN-major; one wgmma group
__device__ __forceinline__ void pv_tile64(float (&o)[32], const uint32_t (&pa)[32],
                                          uint32_t v_tile) {
  fence_operands(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_rs_n64(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                 desc_mnmajor(v_tile, 128, kk));
  wgmma_commit();
  fence_operands(o);
}

// work item t of the dh-64 forward's walk: its head, batch and first query
// row.  Causal: the longest Q tiles first (the tile counts down slowest,
// then the batch, then the head), as the other instances' grids order
// them; otherwise a (batch, head)'s Q tiles one after another and a GQA
// group's heads side by side, so that their K and V tiles come from L2
__device__ __forceinline__ void fwd64_item(int t, int n_qt, int B, int H, int causal, int& h,
                                           int& b, int& q0) {
  constexpr int BQ = Fwd64::BQ;
  if (causal) {
    h = t % H;
    const int r = t / H;
    b = r % B;
    q0 = (n_qt - 1 - r / B) * BQ;
  } else {
    q0 = (t % n_qt) * BQ;
    const int r = t / n_qt;
    h = r % H;
    b = r / H;
  }
}

// The forward at DH 64 (Fwd64, see "DH = 64" above): one CTA an SM, each
// walking its work items (head, batch, 128-row Q tile) in
// `persistent_item`'s order.  Warpgroup 0 is the producer (thread 0 issues
// every TMA load: an item's Q into the Q buffer its consumers freed two
// items before, then its K and V tiles through the rings, which run on
// across items), warpgroups 1 and 2 the consumers, consumer w owning rows
// 64 w .. 64 w + 63 of a tile: the next item's loads run beside this
// item's last products and its stores.
__global__ void __launch_bounds__(Fwd64::THREADS, 1)
flash_fwd64_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const int* __restrict__ kv_lo,
                   const int* __restrict__ kv_hi, bf16* __restrict__ out,
                   float* __restrict__ lse, int B, int H, int Hkv, int Sq, int Sk, int causal,
                   float scale) {
  using C = Fwd64;
  constexpr int NC = C::NC, BQ = C::BQ, BKV = C::BKV, STAGES = C::STAGES, NS = C::NS;
  constexpr int KV_BYTES = C::KV_BYTES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base, sK = base + 2 * C::Q_BYTES, sV = sK + STAGES * KV_BYTES;
  // barriers: the two Q buffers' full and empty; then K full, K empty, V
  // full, V empty (STAGES each)
  const uint32_t q_full = base + C::BAR_OFF, q_empty = q_full + 16;
  const uint32_t k_full = q_empty + 16, k_empty = k_full + 8 * STAGES;
  const uint32_t v_full = k_empty + 8 * STAGES, v_empty = v_full + 8 * STAGES;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int n_qt = (Sq + BQ - 1) / BQ, n_items = n_qt * B * H, rep = H / Hkv;

  if (tid == 0) {
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(q_full + 8 * qb, 1);
      mbar_init(q_empty + 8 * qb, 4 * NC);   // every consumer warp
    }
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(k_empty + 8 * st, 4 * NC);
      mbar_init(v_empty + 8 * st, 4 * NC);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- the producer: each item's Q, then its K_t and V_t as stages free up
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (tid == 0) {
      int it = 0, n_done = 0;   // K/V tiles loaded, items loaded
      for (int k = 0;; ++k) {
        const int t = persistent_item(k, blockIdx.x, gridDim.x);
        if (t >= n_items) break;
        int h, b, q0;
        fwd64_item(t, n_qt, B, H, causal, h, b, q0);
        const int lo = kv_lo ? max(kv_lo[b], 0) : 0;
        const int hi = kv_hi ? min(kv_hi[b], Sk) : Sk;
        const int kv_begin = (lo / BKV) * BKV;
        const int kv_end = causal ? min(hi, q0 + BQ) : hi;
        const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV : 0;
        if (n_tiles == 0) continue;
        const int qb = n_done & 1;   // Q buffer qb serves items qb, qb + 2, ...
        mbar_wait(q_empty + 8 * qb, ((n_done >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(q_full + 8 * qb, C::Q_BYTES);
        tma_load_4d(sQ + qb * C::Q_BYTES, &tq, q_full + 8 * qb, 0, h, q0, b);
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const int st = it % STAGES;
          const uint32_t free_parity = ((it / STAGES) & 1) ^ 1;
          const int kv0 = kv_begin + j * BKV;
          mbar_wait(k_empty + 8 * st, free_parity);
          mbar_arrive_expect_tx(k_full + 8 * st, KV_BYTES);
          tma_load_4d(sK + st * KV_BYTES, &tk, k_full + 8 * st, 0, h / rep, kv0, b);
          mbar_wait(v_empty + 8 * st, free_parity);
          mbar_arrive_expect_tx(v_full + 8 * st, KV_BYTES);
          tma_load_4d(sV + st * KV_BYTES, &tv, v_full + 8 * st, 0, h / rep, kv0, b);
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
    // this warp is done reading a stage
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // the product issues alternate between the consumers: consumer cw
    // waits at barrier 1 + cw for the other's pass, issues, and passes
    auto my_turn = [&] {
      named_barrier_sync(1 + cw, 256);
    };
    auto pass_turn = [&] {
      named_barrier_arrive(1 + (cw + 1) % NC, 256);
    };
    if (cw == NC - 1) pass_turn();   // consumer 0 issues first

    int it = 0, n_done = 0;   // K/V tiles consumed, items consumed
    for (int k = 0;; ++k) {
      const int t = persistent_item(k, blockIdx.x, gridDim.x);
      if (t >= n_items) break;
      int h, b, q0;
      fwd64_item(t, n_qt, B, H, causal, h, b, q0);
      const int lo = kv_lo ? max(kv_lo[b], 0) : 0;
      const int hi = kv_hi ? min(kv_hi[b], Sk) : Sk;
      const int kv_begin = (lo / BKV) * BKV;
      const int kv_end = causal ? min(hi, q0 + BQ) : hi;
      const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV : 0;
      const int wg_row0 = q0 + cw * 64;
      const int row0 = wg_row0 + warp * 16 + (lane >> 2);    // rows row0 and row0 + 8
      // a tile needs the mask where it crosses a window edge, the end of
      // the keys or this warpgroup's causal diagonal
      auto masked_at = [&](int kv0) {
        return kv0 < lo || kv0 + BKV > hi || (causal && kv0 + BKV - 1 > wg_row0);
      };

      float o[32], s[NS];
#pragma unroll
      for (int x = 0; x < 32; ++x) o[x] = 0.f;
      float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];
      uint32_t pa[NS / 2];   // P of the current tile as bf16 register A fragments

      if (n_tiles > 0) {
        const int qb = n_done & 1;
        const uint32_t sQw = sQ + qb * C::Q_BYTES + cw * 64 * 128, q_free = q_empty + 8 * qb;
        mbar_wait(q_full + 8 * qb, (n_done >> 1) & 1);
        mbar_wait(k_full + 8 * (it % STAGES), (it / STAGES) & 1);
        my_turn();
        qk_tile64(s, sQw, sK + (it % STAGES) * KV_BYTES);
        pass_turn();
        wgmma_wait<0>();
        fence_operands(s);
        release(k_empty + 8 * (it % STAGES));
        if (n_tiles == 1) release(q_free);   // S_0 was Q's last product
        softmax_tile64<NS>(s, m, l, alpha, masked_at(kv_begin), kv_begin,
                                             row0, col0, lo, hi, causal, c);
#pragma unroll
        for (int r = 0; r < NS / 2; ++r) pa[r] = pack_bf16(s[2 * r], s[2 * r + 1]);

        // Tile j: S_{j+1} and O += P_j V_j issue back to back; tile j + 1's
        // softmax runs while P_j V_j is on the tensor cores.  The last
        // tile (O += P V only) is peeled off.
        for (int j = 0; j + 1 < n_tiles; ++j) {
          const int i0 = it + j, i1 = i0 + 1;
          const int sn = i1 % STAGES, sj = i0 % STAGES;
          mbar_wait(k_full + 8 * sn, (i1 / STAGES) & 1);
          mbar_wait(v_full + 8 * sj, (i0 / STAGES) & 1);
          my_turn();
          qk_tile64(s, sQw, sK + sn * KV_BYTES);
          pv_tile64(o, pa, sV + sj * KV_BYTES);
          pass_turn();
          wgmma_wait<1>();   // S_{j+1} is done; P_j V_j may still run
          fence_operands(s);
          release(k_empty + 8 * sn);
          if (j + 2 == n_tiles) release(q_free);   // S_{n-1} was Q's last product
          const int kv_next = kv_begin + (j + 1) * BKV;
          softmax_tile64<NS>(s, m, l, alpha, masked_at(kv_next), kv_next,
                                               row0, col0, lo, hi, causal, c);
          wgmma_wait<0>();
          fence_operands(o);
          release(v_empty + 8 * sj);
#pragma unroll
          for (int x = 0; x < 32; ++x) o[x] *= alpha[(x >> 1) & 1];
          fence_operands(o);
#pragma unroll
          for (int r = 0; r < NS / 2; ++r) pa[r] = pack_bf16(s[2 * r], s[2 * r + 1]);
        }
        const int il = it + n_tiles - 1, sl = il % STAGES;
        mbar_wait(v_full + 8 * sl, (il / STAGES) & 1);
        my_turn();
        pv_tile64(o, pa, sV + sl * KV_BYTES);
        pass_turn();
        wgmma_wait<0>();
        fence_operands(o);
        release(v_empty + 8 * sl);
        it += n_tiles;
        ++n_done;
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
        bf16* orow = out + (((size_t)b * Sq + row) * H + h) * 64 + col0;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          *reinterpret_cast<uint32_t*>(orow + 8 * jj) =
              pack_bf16(o[4 * jj + 2 * i] * inv, o[4 * jj + 2 * i + 1] * inv);
        // m is in raw logit units: lse = m * scale + log(l), and -1e30 +
        // log(1) for a row that saw no live key
        const float ms = m[i] > NEG_INF / 2 ? m[i] * scale : NEG_INF;
        if ((lane & 3) == 0) lse[((size_t)b * H + h) * Sq + row] = ms + logf(ls);
      }
    }
    if (cw == 0) my_turn();   // the last consumer's last pass
  }
}

template <int DH>
int fwd_launch(const void* q, const void* k, const void* v, const void* kv_lo,
               const void* kv_hi, void* out, void* lse, int B, int H, int Hkv, int Sq, int Sk,
               int causal, float scale, void* stream) {
  using C = Fwd<DH>;
  constexpr int SMEM = C::SMEM_BYTES;
  cudaFuncSetAttribute(flash_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  dim3 grid(H, B, (Sq + C::BQ - 1) / C::BQ);
  flash_fwd_kernel<DH><<<grid, C::THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(kv_lo), static_cast<const int*>(kv_hi),
      static_cast<bf16*>(out), static_cast<float*>(lse), H, Hkv, Sq, Sk, causal, scale);
  return (int)cudaGetLastError();
}

// the dh-64 forward: one CTA an SM (or an item) walking the work items;
// the tensor maps are built here, on the host, each call
int fwd64_launch(const void* q, const void* k, const void* v, const void* kv_lo,
                 const void* kv_hi, void* out, void* lse, int B, int H, int Hkv, int Sq, int Sk,
                 int causal, float scale, void* stream) {
  using C = Fwd64;
  CUtensorMap tq, tk, tv;
  if (!bf16_head64_map(&tq, q, B, Sq, H, C::BQ) || !bf16_head64_map(&tk, k, B, Sk, Hkv, C::BKV) ||
      !bf16_head64_map(&tv, v, B, Sk, Hkv, C::BKV))
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(flash_fwd64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       C::SMEM_BYTES);
  const int n_items = (Sq + C::BQ - 1) / C::BQ * B * H;
  flash_fwd64_kernel<<<max(min(n_items, sm_count()), 1), C::THREADS, C::SMEM_BYTES,
                       static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<const int*>(kv_lo), static_cast<const int*>(kv_hi),
      static_cast<bf16*>(out), static_cast<float*>(lse), B, H, Hkv, Sq, Sk, causal, scale);
  return (int)cudaGetLastError();
}

// one kernel's six resource ints (see flash_fwd_resources)
int kernel_resources(const void* fn, int smem, int threads, int* r) {
  cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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

}  // namespace

extern "C" {

// q (B, Sq, H, DH) bf16; k/v (B, Sk, Hkv, DH) bf16 with DH 64, 128 or 256;
// kv_lo/kv_hi (B,) int32 or null; out (B, Sq, H, DH) bf16; lse (B, H, Sq)
// f32.  causal needs Sq == Sk.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for another DH or where the dh-64 kernel's tensor
// maps are refused (q, k or v not 16-byte aligned).
int flash_fwd_launch(const void* q, const void* k, const void* v,
                     const void* kv_lo, const void* kv_hi, void* out, void* lse,
                     int B, int H, int Hkv, int Sq, int Sk, int DH, int causal,
                     float scale, void* stream) {
  if (DH == 64)
    return fwd64_launch(q, k, v, kv_lo, kv_hi, out, lse, B, H, Hkv, Sq, Sk, causal, scale,
                        stream);
  if (DH == 128)
    return fwd_launch<128>(q, k, v, kv_lo, kv_hi, out, lse, B, H, Hkv, Sq, Sk, causal, scale,
                           stream);
  if (DH == 256)
    return fwd_launch<256>(q, k, v, kv_lo, kv_hi, out, lse, B, H, Hkv, Sq, Sk, causal, scale,
                           stream);
  return (int)cudaErrorInvalidValue;
}

// The forward kernel's resources at DH 128, 256, then 64, six ints each:
// registers per thread (at launch; the dh-64 kernel rebalances them, see
// flash_fwd64_regs), static shared bytes, dynamic shared bytes, local
// (spill) bytes per thread, threads per CTA, CTAs per SM.  Returns the
// first CUDA error.
int flash_fwd_resources(int* res) {
  int err = kernel_resources((const void*)flash_fwd_kernel<128>, Fwd<128>::SMEM_BYTES,
                             Fwd<128>::THREADS, res);
  if (!err)
    err = kernel_resources((const void*)flash_fwd_kernel<256>, Fwd<256>::SMEM_BYTES,
                           Fwd<256>::THREADS, res + 6);
  return err ? err
             : kernel_resources((const void*)flash_fwd64_kernel, Fwd64::SMEM_BYTES,
                                Fwd64::THREADS, res + 12);
}

// The dh-64 forward's registers a thread after setmaxnreg: the producer
// warpgroup's, then the consumers'.
int flash_fwd64_regs(int* r) {
  r[0] = Fwd64::PRODUCER_REGS;
  r[1] = Fwd64::CONSUMER_REGS;
  return 0;
}

}  // extern "C"
