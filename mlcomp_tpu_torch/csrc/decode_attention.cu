// Flash decode over an int8 KV cache: one query per row (B3) and S chunk
// queries per row (B4), over a dense cache or through a page table (B6,
// B7): two kernel bodies, one for a single query (B3, B6) and one on the
// tensor cores for chunks (B4, B7), each serving both layouts.
//
// Replaces four Pallas kernels of mlcomp_tpu/ops/pallas/decode_attention.py
// (all built on `_flash_block_update` and `_flash_finalize`):
//   - `_kernel` (`decode_attention`): q (B, H, dh), one query per row;
//   - `_kernel_chunk` (`decode_attention_chunk`, decode_attention.py:323):
//     q (B, S, H, dh), query j of row b attends [kv_start[b], kv_stop0[b] + j);
//   - `_paged_kernel` (`paged_decode_attention`, :957) and
//     `_paged_kernel_chunk` (`paged_decode_attention_chunk`, :1169): the
//     same two through a (B, MP) page table over (P, Hkv, T, dh) int8
//     pages and (P, Hkv, 1, T) bf16 scale pages.
//
//     out[b, j, h, :] = softmax_i(q[b, j, h] . k8[b, hkv, i] * scale * ks[b, hkv, i])
//                       @ (v8[b, hkv, i] * vs[b, hkv, i])   for i in [lo_b, stop0_b + j)
//
// What bounds it on an H100: bytes.  Each (row, KV head) reads the int8 K/V
// of its live window once and does a few FLOPs per byte.  A decode step
// (B3) reads the whole live window of every row: at 8 rows x 16 KV heads
// of dh 128 and windows of ~370 slots, ~12 MB, ~4 us at 3.35 TB/s.  An
// admission chunk (B4, q (1, 256, 16, 128) against a 768-slot cache) reads
// ~0.13 MB of K/V per head and does ~0.8 GFLOP in all: microseconds of
// work, so at that shape launch latency and the CTA's serial block loop
// bound it.
//
// The design: a query ROW is one (query j, group head g) pair, r = j * G
// + g with G = H / Hkv, so the G heads sharing a KV head sit side by side.
// Two bodies, picked by the wrapper's `chunk_plan`:
//
// - `attend_split_kernel` (S = 1: B3, B6, and a one-query chunk, which
//   equals the single-query decode bit for bit: it is the same launch).
//   Each window is cut into NS contiguous shares of the 32-slot blocks
//   that meet it (the plan's `shares`, 1-8, from the cache length alone),
//   merged in share order: that cut and that order are all a row's bits
//   depend on, never the batch.  A thread-block cluster of C CTAs (the
//   plan's `cluster`, C dividing NS) takes the R <= 8 rows of one (batch
//   row, KV head), CTA rank c computing shares c NS/C .. (c + 1) NS/C - 1
//   one after another: C only places the shares, so that one lone request
//   (16 (row, head) pairs) still spreads over the card while a decode step
//   of many rows needs no cluster.  Inside a CTA each of its 4
//   warps takes every 4th block of the share and runs its own online
//   softmax over them with no CTA-wide barrier: a cp.async ring of raw
//   int8 K and V blocks per warp (two stages, bytes in flight from the
//   kernel's first cycles), slot addresses and scales resolved one ring
//   ahead in registers, the page table read once per page of the share
//   into shared memory; q . k one slot a lane, p V four head dims a lane,
//   both on the CUDA cores (at G = 1 a KV head has one query row: nothing
//   to fill a tensor core with), int8 converted to f32 by a byte permute
//   and one subtraction.  At the end of a share its warps' (m, l, acc)
//   merge in warp order into the share's partial, stored into rank 0's
//   shared memory (distributed shared memory); rank 0 merges the NS
//   partials in share order.  No atomics, no second launch.
// - `attend_tc_kernel` (S > 1: B4, B7): tiles of 64 rows on the tensor
//   cores (wgmma.cuh).  The (1, 256) admission chunk is 4 tiles x 16 heads
//   = 64 CTAs, each reading its K/V window once per 64 rows.  A CTA is two
//   warpgroups.  The producer brings each block of 64 slots' raw int8 K
//   and V by cp.async (two blocks ahead), converts them to bf16 (exact)
//   into one of two buffers of 128-byte-swizzled tiles, K and V alike one
//   slot a row, with the block's scales beside them, and hands the buffer
//   over by a named barrier.  The consumer runs S = Q K^T as a wgmma
//   m64n64k16 (Q and K K-major), the online softmax on the accumulator
//   layout (exp on the SFU; the mask only on blocks that cross a window
//   edge or a causal stop), rounds p * vs to bf16 in registers as the A
//   operand of O += P V (V read MN-major, the transpose bit), keeps O
//   (64 x dh, f32) in registers, and hands the buffer back.  Conversion of
//   block n + 1 thus runs beside the products and softmax of block n.  Head
//   dims 128 and 256 are template instances.  Slot addresses (a page-table
//   read) and scales run ahead of the copies in registers, so no read
//   stalls the block loop.
//
// Paging is addressing only.  Slot i of (row b, KV head h) lives at
// (b * Hkv + h) * L + i in the dense cache and at
// (table[b, i / T] * Hkv + h) * T + i % T in the pages, for values and
// scales alike.  Both bodies resolve these addresses only for slots inside
// the live range (table columns past the window are never read; slots
// outside it are zero-filled in both layouts), then run the same loads,
// reductions and roundings as the dense case: paged equals dense bit for
// bit on the same bytes, for any T.  The TPU kernel's page DMA schedules
// are VMEM plumbing and have no counterpart here.
//
// Arithmetic follows the TPU kernel, in its order: logits are (q . k) *
// scale * ks with q in bf16, k int8 (exact) and f32 sums; masked slots are
// -1e30; p = exp(s - m_new), forced to 0 while the row has seen no live
// slot; the V scale folds into p, which rounds to bf16 before it multiplies
// V; l sums the unscaled p; the end divides by l, and l == 0 (an empty
// window) gives 0.  The bodies sum in other orders than the plain version
// (the single-query one also rounds p * vs against its share's running
// max; the card check is the 2^-7 (|ref| + ref_abs) rule); neither uses
// atomics, so a rerun gives the same bits.
// A masked slot's p * vs is SELECTED to 0, never multiplied: a masked
// slot inside a live block may load whatever its page holds (a retired
// row's writes, a freed page's old bytes), and 0 x a non-finite scale
// would poison the sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "wgmma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// ---- S = 1: the single-query body (B3, B6, and a one-query chunk) --------

constexpr int SPLIT_WARPS = 4;   // the merge reads a row's four (m, l) as one float4
constexpr int SPLIT_THREADS = 32 * SPLIT_WARPS;
constexpr int SPLIT_SLOTS = 32;   // slots a warp takes at a time: one a lane
constexpr int MAX_CLUSTER = 8;

// shared memory (bytes): each warp's ring of two stages of (32 raw int8 K
// rows | 32 raw int8 V rows) | q (R x DH f32) | each warp's running max and
// sum per row (2 x R x 4 f32) | each share's merged partial, acc (R x DH
// f32) then (m, l, -, -) per row (R x 4 f32), filled in rank 0 | the
// share's page ids (paged only)
template <int DH>
struct SplitSmem {
  static constexpr int STAGES = 2;
  static constexpr int STAGE = 2 * SPLIT_SLOTS * DH;
  static constexpr int RING = SPLIT_WARPS * STAGES * STAGE;
  // one rank's merged partial, in floats
  __host__ __device__ static constexpr int part(int rows) { return rows * (DH + 4); }
  static constexpr int bytes(int rows, int shares, int pages) {
    return RING + rows * DH * 4 + 2 * SPLIT_WARPS * rows * 4 + shares * part(rows) * 4 +
           pages * 4;
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// four int8 values (the bytes of w, lowest first) -> exact f32: byte b + 128
// becomes the low mantissa byte of 2^23 (a byte permute), and a subtraction
// takes 2^23 + 128 away
__device__ __forceinline__ void f32x4_of_int8(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
}

// the split arrive and wait of a cluster barrier (every thread of every
// CTA), and a 16-byte store into CTA `rank`'s shared memory at the address
// `addr` has in this CTA's
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void st_cluster_f4(uint32_t addr, uint32_t rank, float4 v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(remote), "f"(v.x),
               "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// 16-byte chunk c of raw K row r sits at chunk (c & ~7) | ((c ^ r) & 7) of
// the row: the 8 lanes of a quarter warp, each reading chunk c of its own
// row, then meet distinct banks
__device__ __forceinline__ int k_chunk(int c, int r) { return (c & ~7) | ((c ^ r) & 7); }

// grid (tiles x cluster, Hkv, B), launched as clusters of (cluster, 1, 1):
// the blocks that meet the window [kv_start, min(kv_stop0, L)) of a (batch
// row, KV head) are cut into `shares` contiguous shares, and CTA rank c of
// its cluster computes shares c * shares / cluster onwards, one after
// another, for the R query rows r0 .. r0 + R - 1 of that KV head (rows
// past G are computed on zero q and never stored).  Operands as `launch`
// (S = 1).
template <int DH, int R>
__global__ void __launch_bounds__(SPLIT_THREADS)
attend_split_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k8,
                    const __nv_bfloat16* __restrict__ ks, const int8_t* __restrict__ v8,
                    const __nv_bfloat16* __restrict__ vs, const int* __restrict__ kv_start,
                    const int* __restrict__ kv_stop0, const int* __restrict__ table,
                    __nv_bfloat16* __restrict__ out, int H, int Hkv, int L, int MP, int T,
                    float scale, int shares) {
  using namespace hopper;
  using Sm = SplitSmem<DH>;
  constexpr int STAGES = Sm::STAGES;
  constexpr int CH = DH / 16;       // 16-byte chunks a slot row
  constexpr int NV = DH / 128;      // 4-dim groups a lane owns in P V
  constexpr int QPT = R * DH / SPLIT_THREADS;   // q values a thread stages
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + Sm::RING);
  float* ml_m = qs + R * DH;                 // [row][warp]
  float* ml_l = ml_m + R * SPLIT_WARPS;
  float* cpart = ml_l + R * SPLIT_WARPS;     // [share][Sm::part(R)]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = (int)cluster_rank(), ranks = (int)cluster_size();
  const int per_cta = shares / ranks;        // shares this CTA computes
  int* pg = reinterpret_cast<int*>(cpart + shares * Sm::part(R));
  // every CTA of the cluster has started before any writes into another's
  // shared memory: this arrive's wait comes before the first merge
  if (ranks > 1) cluster_arrive_relaxed();
  const int r0 = (blockIdx.x / ranks) * R;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int rows = min(R, G - r0);
  // q first (rows past G read row r0 and are zeroed when staged)
  __nv_bfloat16 qv[QPT];
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int i = tid + k * SPLIT_THREADS, r = i / DH;
    qv[k] = q[((size_t)b * H + hk * G + r0 + (r < rows ? r : 0)) * DH + i % DH];
  }

  // the blocks that meet the window, from the window alone
  const int lo = max(kv_start[b], 0);
  const int hi = min(kv_stop0[b], L);
  const int kb0 = lo / SPLIT_SLOTS;
  const int nblk = hi > lo ? (hi + SPLIT_SLOTS - 1) / SPLIT_SLOTS - kb0 : 0;
  const size_t dense_base = ((size_t)b * Hkv + hk) * L;
  unsigned char* ring = smem + warp * STAGES * Sm::STAGE;
  const uint32_t ring_s = smem_u32(ring);
  for (int si = 0; si < per_cta; ++si) {
    // share sh of those blocks, the same cut at every cluster size
    const int sh = rank * per_cta + si;
    const int c0 = kb0 + sh * nblk / shares, c1 = kb0 + (sh + 1) * nblk / shares;
    // the live slots of the share, and (paged) its pages, read once each
    const int s_lo = max(c0 * SPLIT_SLOTS, lo), s_hi = min(c1 * SPLIT_SLOTS, hi);
    const int p0 = table != nullptr && s_hi > s_lo ? s_lo / T : 0;
    if (table != nullptr) {
      const int np = s_hi > s_lo ? (s_hi - 1) / T - p0 + 1 : 0;
      for (int i = tid; i < np; i += SPLIT_THREADS) pg[i] = __ldg(table + (size_t)b * MP + p0 + i);
      __syncthreads();
    }
    // the cache row of slot i (values and scales alike), -1 outside the share
    auto resolve = [&](int i) -> int {
      if (i < s_lo || i >= s_hi) return -1;
      if (table == nullptr) return (int)(dense_base + i);
      const int p = i / T;
      return (pg[p - p0] * Hkv + hk) * T + (i - p * T);
    };

    // this warp's blocks: c0 + warp, c0 + warp + 4, ...; block n of the warp
    // goes to stage n % STAGES of its ring
    const int nw = c1 - c0 > warp ? (c1 - c0 - warp + SPLIT_WARPS - 1) / SPLIT_WARPS : 0;
    // issue block n's K and V rows (lane l resolved slot l; rows outside the
    // share zero-filled) and load its scales for this lane's slot, kept raw
    // until the block is computed (a slot off the window loads row 0's and
    // is selected away then), so that nothing here waits for a load
    auto issue = [&](int n, __nv_bfloat16& ksv, __nv_bfloat16& vsv) {
      if (n >= nw) return;
      const int a = resolve((c0 + warp + n * SPLIT_WARPS) * SPLIT_SLOTS + lane);
      const uint32_t kd = ring_s + (n % STAGES) * Sm::STAGE, vd = kd + SPLIT_SLOTS * DH;
#pragma unroll
      for (int it = 0; it < CH; ++it) {
        const int u = lane + 32 * it, r = u / CH, c = u % CH;
        const int ra = __shfl_sync(0xffffffffu, a, r);
        const bool valid = ra >= 0;
        const size_t off = valid ? (size_t)ra * DH + c * 16 : 0;
        cp_async_16(kd + r * DH + k_chunk(c, r) * 16, k8 + off, valid);
        cp_async_16(vd + r * DH + c * 16, v8 + off, valid);
      }
      ksv = ks[a >= 0 ? a : 0];
      vsv = vs[a >= 0 ? a : 0];
    };

    __nv_bfloat16 ksr[STAGES], vsr[STAGES];   // scales of blocks n .. n + STAGES - 1
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      issue(s, ksr[s], vsr[s]);
      cp_async_commit();
    }
    if (si == 0) {
#pragma unroll
      for (int k = 0; k < QPT; ++k) {
        const int i = tid + k * SPLIT_THREADS;
        qs[i] = i / DH < rows ? __bfloat162float(qv[k]) : 0.f;
      }
    }
    __syncthreads();

    float m[R], l[R], acc[R][4 * NV];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m[r] = NEG_INF;
      l[r] = 0.f;
#pragma unroll
      for (int e = 0; e < 4 * NV; ++e) acc[r][e] = 0.f;
    }

    for (int n = 0; n < nw; ++n) {
      // block n has landed for every lane, and every lane is done with block
      // n - 1, whose stage takes block n + STAGES - 1: asking for every block
      // at the start only delays the first (measured on an H100)
      cp_async_wait<STAGES - 2>();
      __syncwarp();
      issue(n + STAGES - 1, ksr[STAGES - 1], vsr[STAGES - 1]);
      cp_async_commit();
      const unsigned char* kst = ring + (n % STAGES) * Sm::STAGE;
      const unsigned char* vst = kst + SPLIT_SLOTS * DH;
      const int slot = (c0 + warp + n * SPLIT_WARPS) * SPLIT_SLOTS + lane;
      const bool live = slot >= lo && slot < hi;

      // q . k, one slot a lane: NP independent sums a row (head dims 4v ..
      // 4v + 3 of every 16 into sum v % NP), so that the FMA chains overlap,
      // added in a fixed order at the end
      constexpr int NP = R >= 4 ? 1 : 4 / R;
      float part[R][NP];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int i = 0; i < NP; ++i) part[r][i] = 0.f;
#pragma unroll 4
      for (int c = 0; c < CH; ++c) {
        const uint4 w = *reinterpret_cast<const uint4*>(kst + lane * DH + k_chunk(c, lane) * 16);
        float kf[16];
        f32x4_of_int8(w.x, kf);
        f32x4_of_int8(w.y, kf + 4);
        f32x4_of_int8(w.z, kf + 8);
        f32x4_of_int8(w.w, kf + 12);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4* qr = reinterpret_cast<const float4*>(qs + r * DH + c * 16);
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const float4 qv = qr[v];
            float& d = part[r][v % NP];
            d = fmaf(qv.x, kf[4 * v], d);
            d = fmaf(qv.y, kf[4 * v + 1], d);
            d = fmaf(qv.z, kf[4 * v + 2], d);
            d = fmaf(qv.w, kf[4 * v + 3], d);
          }
        }
      }
      float dot[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if constexpr (NP == 4) {
          dot[r] = (part[r][0] + part[r][1]) + (part[r][2] + part[r][3]);
        } else if constexpr (NP == 2) {
          dot[r] = part[r][0] + part[r][1];
        } else {
          dot[r] = part[r][0];
        }
      }

      // the warp's online softmax: logits (q . k) * scale * ks, -1e30 off the
      // window; p zero while the row has seen no live slot; p * vs selected
      // to 0 off the window and rounded to bf16; l of the unscaled p, kept
      // per lane and summed once at the end
      float pv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float s = live ? (dot[r] * scale) * __bfloat162float(ksr[0]) : NEG_INF;
        const float m_new = fmaxf(m[r], warp_max(s));
        const float p = m_new > NEG_INF / 2 ? expf(s - m_new) : 0.f;
        const float alpha = expf(m[r] - m_new);
        m[r] = m_new;
        l[r] = alpha * l[r] + p;
        pv[r] = live ? __bfloat162float(__float2bfloat16(p * __bfloat162float(vsr[0]))) : 0.f;
#pragma unroll
        for (int e = 0; e < 4 * NV; ++e) acc[r][e] *= alpha;
      }

      // p V: this lane's head dims 4 lane .. 4 lane + 3 (+ 128 at dh 256),
      // the block's slots in order
#pragma unroll 4
      for (int j = 0; j < SPLIT_SLOTS; ++j) {
        float pj[R];
#pragma unroll
        for (int r = 0; r < R; ++r) pj[r] = __shfl_sync(0xffffffffu, pv[r], j);
#pragma unroll
        for (int h = 0; h < NV; ++h) {
          float vf[4];
          f32x4_of_int8(*reinterpret_cast<const uint32_t*>(vst + j * DH + 128 * h + 4 * lane), vf);
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[r][4 * h + e] = fmaf(pj[r], vf[e], acc[r][4 * h + e]);
        }
      }
#pragma unroll
      for (int s = 0; s < STAGES - 1; ++s) {
        ksr[s] = ksr[s + 1];
        vsr[s] = vsr[s + 1];
      }
    }
    cp_async_wait<0>();   // no copy lands in the ring after this
    __syncwarp();

    // this warp's partial: (m, l) per row beside the other warps', acc (R x
    // DH f32) over its own ring
    float* part = reinterpret_cast<float*>(ring);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float lr = warp_sum(l[r]);
      if (lane == 0) {
        ml_m[r * SPLIT_WARPS + warp] = m[r];
        ml_l[r * SPLIT_WARPS + warp] = lr;
      }
#pragma unroll
      for (int h = 0; h < NV; ++h)
        *reinterpret_cast<float4*>(part + r * DH + 128 * h + 4 * lane) =
            make_float4(acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2], acc[r][4 * h + 3]);
    }

    // The merge: m = max m_i, l = sum e^(m_i - m) l_i, acc = sum e^(m_i - m)
    // acc_i, first over the share's warps in order, stored into the share's
    // slot of rank 0's shared memory (distributed shared memory: stores, so
    // no round trip), then, after one cluster barrier, over the shares in
    // order by rank 0, which writes the output.  An empty share (m -1e30,
    // l 0, acc 0) adds 0; an empty window gives l == 0 and so 0.
    __syncthreads();
    if (si == 0 && ranks > 1) cluster_wait();
    const uint32_t mine = smem_u32(cpart + sh * Sm::part(R));
    for (int u = tid; u < rows * (DH / 4); u += SPLIT_THREADS) {
      const int r = u / (DH / 4), d = 4 * (u % (DH / 4));
      const float4 mm = *reinterpret_cast<const float4*>(ml_m + r * SPLIT_WARPS);
      const float4 ll = *reinterpret_cast<const float4*>(ml_l + r * SPLIT_WARPS);
      const float mw[4] = {mm.x, mm.y, mm.z, mm.w}, lw[4] = {ll.x, ll.y, ll.z, ll.w};
      const float mc = fmaxf(fmaxf(mw[0], mw[1]), fmaxf(mw[2], mw[3]));
      float lc = 0.f;
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < SPLIT_WARPS; ++w) {
        const float f = expf(mw[w] - mc);
        const float4 a = *reinterpret_cast<const float4*>(
            smem + w * STAGES * Sm::STAGE + (r * DH + d) * 4);
        lc += f * lw[w];
        o.x += f * a.x;
        o.y += f * a.y;
        o.z += f * a.z;
        o.w += f * a.w;
      }
      st_cluster_f4(mine + (r * DH + d) * 4, 0, o);
      if (d == 0) st_cluster_f4(mine + (R * DH + 4 * r) * 4, 0, make_float4(mc, lc, 0.f, 0.f));
    }
    // the next share reuses the ring, the warps' (m, l) and the page ids
    __syncthreads();
  }
  if (ranks > 1) {
    cluster_sync();
  } else {
    __syncthreads();
  }
  if (rank != 0) return;
  for (int u = tid; u < rows * (DH / 4); u += SPLIT_THREADS) {
    const int r = u / (DH / 4), d = 4 * (u % (DH / 4));
    float mx = NEG_INF;
    for (int p = 0; p < shares; ++p) mx = fmaxf(mx, cpart[p * Sm::part(R) + R * DH + 4 * r]);
    float ls = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p = 0; p < shares; ++p) {
      const float* pp = cpart + p * Sm::part(R);
      const float f = expf(pp[R * DH + 4 * r] - mx);
      const float4 a = *reinterpret_cast<const float4*>(pp + r * DH + d);
      ls += f * pp[R * DH + 4 * r + 1];
      o.x += f * a.x;
      o.y += f * a.y;
      o.z += f * a.z;
      o.w += f * a.w;
    }
    const float inv = ls == 0.f ? 1.f : ls;
    *reinterpret_cast<uint2*>(out + ((size_t)b * H + hk * G + r0 + r) * DH + d) =
        make_uint2(pack_bf16(o.x / inv, o.y / inv), pack_bf16(o.z / inv, o.w / inv));
  }
}

// ---- S > 1: the tensor-core body (B4, B7) --------------------------------

constexpr int TC_ROWS = 64;      // query rows per CTA: wgmma's M
constexpr int TC_BKV = 64;       // slots per KV block
constexpr int TC_THREADS = 256;  // a consumer warpgroup, then a producer one
constexpr float LOG2E = 1.4426950408889634f;
// named barriers (0 is __syncthreads): BAR_FULL + u, block n's bf16 K/V and
// scales are in buffer u = n % 2; BAR_FULL + 2 + u, the consumer is done
// with buffer u
constexpr int BAR_FULL = 1;

// shared memory (bytes): Q (64 x DH bf16) | two buffers of K and V (64 x DH
// bf16 each) | two stages of raw int8 K and V (64 x DH each) | two blocks of
// f32 ks and vs (64 each) | 1024 of slack to align the swizzled tiles
template <int DH>
struct TcSmem {
  static constexpr int Q = TC_ROWS * DH * 2;
  static constexpr int KV = TC_BKV * DH * 2;    // one bf16 tile
  static constexpr int RAW = 2 * TC_BKV * DH;   // one stage: int8 K and V
  static constexpr int SC = 2 * TC_BKV * 4;     // one block's ks and vs
  static constexpr int BYTES = Q + 4 * KV + 2 * RAW + 2 * SC + 1024;
};

// 16-byte int8 chunk c of raw slot row r sits at chunk
// (c & ~7) | ((c ^ r ^ (c / 8 * 4)) & 7) of its row: the producer's copies
// and conversion reads then meet no bank conflict
__device__ __forceinline__ int raw_chunk(int c, int r) {
  return (c & ~7) | ((c ^ r ^ ((c >> 3) << 2)) & 7);
}

// The online softmax of one block on the accumulator layout, in place:
// element x of s is row ra + 8 ((x / 2) % 2), slot j0 + 8 (x / 4) + col0 +
// x % 2.  Logits (q . k) * scale * ks, selected to -1e30 on masked slots
// (MASKED: a block that crosses a window edge or a causal stop); moves the
// running max m and sum l (of the unscaled p), returns each row's rescale
// factor in alpha and leaves p * vs, rounded to bf16, as register A
// fragments in pa.  exp runs on the SFU as 2^(x log2 e); everything is
// computed for every slot and then selected, so the code has no branch.
template <bool MASKED>
__device__ __forceinline__ void chunk_softmax(float (&s)[32], uint32_t (&pa)[16], float (&m)[2],
                                              float (&l)[2], float (&alpha)[2],
                                              const float* kss, const float* vss, float scale,
                                              int j0, int col0, int lo, const int (&hi_r)[2]) {
  using namespace hopper;
  auto live = [&](int i, int col) { return j0 + col >= lo && j0 + col < hi_r[i]; };
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    const int i = (x >> 1) & 1, col = 8 * (x >> 2) + col0 + (x & 1);
    float v = (s[x] * scale) * kss[col];
    if (MASKED) v = live(i, col) ? v : NEG_INF;
    s[x] = v;
    mx[i] = fmaxf(mx[i], v);
  }
  float mneg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    alpha[i] = ex2((m[i] - mx[i]) * LOG2E);
    m[i] = mx[i];
    mneg[i] = -mx[i] * LOG2E;
  }
  float ps[2] = {0.f, 0.f};
#pragma unroll
  for (int x = 0; x < 32; x += 2) {
    const int i = (x >> 1) & 1;
    float pv[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * (x >> 2) + col0 + e;
      float p = ex2(fmaf(s[x + e], LOG2E, mneg[i]));
      pv[e] = p * vss[col];
      if (MASKED) {
        // 0 on a masked slot (never exp of a mask: the row may have seen no
        // live slot yet), and p * vs selected, whatever a page's scale holds
        const bool on = live(i, col);
        p = on ? p : 0.f;
        pv[e] = on ? pv[e] : 0.f;
      }
      ps[i] += p;
    }
    pa[x >> 1] = pack_bf16(pv[0], pv[1]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = alpha[i] * l[i] + ps[i];
}

// grid (ceil(S * G / 64), Hkv, B), 256 threads.  Operands as `launch` takes them.
// Warpgroup 0 consumes: its products, online softmax and output rows.
// Warpgroup 1 produces, one block ahead, into two buffers: thread t copies
// (cp.async, two blocks ahead), converts and scales slot row t / 2 of each
// block, head dims of half t % 2 (and the K scale when t is even, the V
// scale when odd).
template <int DH>
__global__ void __launch_bounds__(TC_THREADS, 1)
attend_tc_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k8,
                 const __nv_bfloat16* __restrict__ ks, const int8_t* __restrict__ v8,
                 const __nv_bfloat16* __restrict__ vs, const int* __restrict__ kv_start,
                 const int* __restrict__ kv_stop0, const int* __restrict__ table,
                 __nv_bfloat16* __restrict__ out, int S, int H, int Hkv, int L, int MP, int T,
                 float scale) {
  using namespace hopper;
  using Sm = TcSmem<DH>;
  constexpr int CH = DH / 16;     // 16-byte int8 chunks per slot row
  constexpr int NO = DH / 128;    // 128-wide output accumulators
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw0 = smem_u32(smem_raw);
  const uint32_t base = (raw0 + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw0);   // the same bytes, generic
  // buffer u: K tile at sBuf + 2u KV, V tile at sBuf + (2u + 1) KV
  const uint32_t sQ = base, sBuf = sQ + Sm::Q, sRaw = sBuf + 4 * Sm::KV;
  float* sc = reinterpret_cast<float*>(gbase + (sRaw - base) + 2 * Sm::RAW);

  const int G = H / Hkv;
  const int rows = S * G;
  const int r0 = blockIdx.x * TC_ROWS;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const bool producer = tid >= 128;

  const int lo = max(kv_start[b], 0);
  const int stop0 = kv_stop0[b];
  const int hi_cta = min(stop0 + (min(r0 + TC_ROWS, rows) - 1) / G, L);
  const int hi_min = min(stop0 + r0 / G, L);     // the tile's first row's stop
  const int kv_begin = (lo / TC_BKV) * TC_BKV;
  const int nblk = hi_cta > lo ? (hi_cta - kv_begin + TC_BKV - 1) / TC_BKV : 0;

  // the producer's slot row and half
  const int cr = (tid & 127) >> 1, ch = tid & 1;
  const size_t dense_base = ((size_t)b * Hkv + hk) * L;
  // the cache row of this thread's slot of block n, -1 outside the tile's
  // live range (zero-filled; its table column is never read)
  auto resolve = [&](int n) -> long long {
    const int i = kv_begin + n * TC_BKV + cr;
    if (n >= nblk || i < lo || i >= hi_cta) return -1;
    if (table == nullptr) return (long long)(dense_base + i);
    return ((long long)__ldg(table + (size_t)b * MP + i / T) * Hkv + hk) * T + i % T;
  };
  // this thread's chunks, in an order that keeps a quarter warp's
  // conversion stores on distinct banks
  auto chunk = [&](int u) { return ch * (CH / 2) + (u ^ (ch << 1)); };
  auto issue_kv = [&](int n, long long a) {
    const uint32_t rk = sRaw + (n & 1) * Sm::RAW, rv = rk + TC_BKV * DH;
    const bool valid = a >= 0;
    const int8_t* kp = valid ? k8 + a * DH : k8;
    const int8_t* vp = valid ? v8 + a * DH : v8;
#pragma unroll
    for (int u = 0; u < CH / 2; ++u) {
      const int c = chunk(u);
      const uint32_t off = cr * DH + raw_chunk(c, cr) * 16;
      cp_async_16(rk + off, kp + (valid ? c * 16 : 0), valid);
      cp_async_16(rv + off, vp + (valid ? c * 16 : 0), valid);
    }
  };
  auto load_scale = [&](long long a) -> float {
    return a >= 0 ? __bfloat162float((ch ? vs : ks)[a]) : 0.f;
  };

  // Q rows r0 .. r0 + 63 (row r = j G + g is head hk G + g of query j) by
  // all threads (group 0); the producer's blocks 0 and 1 (groups 1, 2) fly
  // beside it
#pragma unroll
  for (int it = 0; it < TC_ROWS * (DH / 8) / TC_THREADS; ++it) {
    const int i = tid + it * TC_THREADS;
    const int r = i / (DH / 8), c = i % (DH / 8);
    const int row = r0 + r;
    const bool valid = row < rows;
    const int j = row / G, g = row - j * G;
    const __nv_bfloat16* src = valid ? q + (((size_t)b * S + j) * H + hk * G + g) * DH + c * 8 : q;
    cp_async_16(sQ + (c >> 3) * TC_ROWS * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4), src, valid);
  }
  cp_async_commit();
  float sc_n = 0.f, sc_n1 = 0.f;   // the producer's scales of blocks n, n + 1
  long long a_next = -1;           // its slot's cache row in block n + 2
  if (producer) {
    const long long a0 = resolve(0), a1 = resolve(1);
    issue_kv(0, a0);
    cp_async_commit();
    issue_kv(1, a1);
    cp_async_commit();
    sc_n = load_scale(a0);
    sc_n1 = load_scale(a1);
    a_next = resolve(2);
    cp_async_wait<2>();
  } else {
    cp_async_wait<0>();
  }
  fence_proxy_async();
  __syncthreads();

  if (producer) {
    for (int n = 0; n < nblk; ++n) {
      // the consumer is done with buffer n % 2 (block n - 2); this thread's
      // copies of block n have landed
      if (n >= 2) named_barrier_sync(BAR_FULL + 2 + (n & 1), 2 * 128);
      cp_async_wait<1>();
      // int8 -> bf16 into the swizzled K and V tiles of buffer n % 2 (one
      // slot a row, head dims 64 c .. 64 c + 63 in column block c): every
      // read first, so that no store waits on the next read
      const unsigned char* rk = gbase + (sRaw - base) + (n & 1) * Sm::RAW + cr * DH;
      uint4 w[2][CH / 2];
#pragma unroll
      for (int kv = 0; kv < 2; ++kv)
#pragma unroll
        for (int u = 0; u < CH / 2; ++u)
          w[kv][u] = *reinterpret_cast<const uint4*>(rk + kv * TC_BKV * DH +
                                                     raw_chunk(chunk(u), cr) * 16);
#pragma unroll
      for (int kv = 0; kv < 2; ++kv) {
        unsigned char* tile = gbase + (sBuf - base) + (2 * (n & 1) + kv) * Sm::KV + cr * 128;
#pragma unroll
        for (int u = 0; u < CH / 2; ++u) {
          const int c = chunk(u);
          const uint4 x = w[kv][u];
          const uint4 lo4 = make_uint4(bf16x2_of_int8(x.x, 0x4140), bf16x2_of_int8(x.x, 0x4342),
                                       bf16x2_of_int8(x.y, 0x4140), bf16x2_of_int8(x.y, 0x4342));
          const uint4 hi4 = make_uint4(bf16x2_of_int8(x.z, 0x4140), bf16x2_of_int8(x.z, 0x4342),
                                       bf16x2_of_int8(x.w, 0x4140), bf16x2_of_int8(x.w, 0x4342));
          // 8-dim chunks 2c and 2c + 1: column block c / 4, chunk (2c) % 8 (+1)
          unsigned char* line = tile + (c >> 2) * TC_BKV * 128;
          *reinterpret_cast<uint4*>(line + ((((2 * c) & 7) ^ (cr & 7)) << 4)) = lo4;
          *reinterpret_cast<uint4*>(line + ((((2 * c + 1) & 7) ^ (cr & 7)) << 4)) = hi4;
        }
      }
      sc[(n & 1) * 2 * TC_BKV + ch * TC_BKV + cr] = sc_n;
      fence_proxy_async();
      named_barrier_arrive(BAR_FULL + (n & 1), 2 * 128);
      // then the stage just read (its bytes are in registers) takes block
      // n + 2: issued after the hand-off, whose fence would otherwise wait
      // for these copies and the scale's load
      issue_kv(n + 2, a_next);
      cp_async_commit();
      sc_n = sc_n1;
      sc_n1 = load_scale(a_next);
      a_next = resolve(n + 3);
    }
    cp_async_wait<0>();   // no copy outlives the CTA
    return;
  }

  // ---- consumer: accumulator element x of thread (warp w, lane) is row
  // 16 w + lane / 4 + 8 ((x / 2) % 2), column 8 (x / 4) + 2 (lane % 4) + x % 2
  const int warp = tid >> 5, lane = tid & 31;
  const int ra = r0 + warp * 16 + (lane >> 2);
  int hi_r[2];   // causal stops of this thread's rows (0 past the chunk)
#pragma unroll
  for (int i = 0; i < 2; ++i) hi_r[i] = ra + 8 * i < rows ? min(stop0 + (ra + 8 * i) / G, L) : 0;
  const int col0 = 2 * (lane & 3);
  float o[NO][64], s[32];
#pragma unroll
  for (int k = 0; k < NO; ++k)
#pragma unroll
    for (int x = 0; x < 64; ++x) o[k][x] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int n = 0; n < nblk; ++n) {
    named_barrier_sync(BAR_FULL + (n & 1), 2 * 128);
    const uint32_t sK = sBuf + 2 * (n & 1) * Sm::KV, sV = sK + Sm::KV;
    // S = Q K^T (the first step overwrites s: no instruction but wgmma
    // defines it, so ptxas keeps the products asynchronous)
    fence_operands(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss_n64(s, desc_kmajor(sQ, TC_ROWS, kk), desc_kmajor(sK, TC_BKV, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s);

    // a block inside every valid row's window skips the mask (rows past
    // the chunk are never stored)
    const int j0 = kv_begin + n * TC_BKV;
    const float* kss = sc + (n & 1) * 2 * TC_BKV;
    uint32_t pa[16];   // p * vs of this block as bf16 register A fragments
    float alpha[2];
    if (j0 < lo || j0 + TC_BKV > hi_min)
      chunk_softmax<true>(s, pa, m, l, alpha, kss, kss + TC_BKV, scale, j0, col0, lo, hi_r);
    else
      chunk_softmax<false>(s, pa, m, l, alpha, kss, kss + TC_BKV, scale, j0, col0, lo, hi_r);
#pragma unroll
    for (int k = 0; k < NO; ++k)
#pragma unroll
      for (int x = 0; x < 64; ++x) o[k][x] *= alpha[(x >> 1) & 1];

    // O += P V: 16 slots a step, V MN-major; output dims 128 k .. + 127
    // are column blocks 2k and 2k + 1 of the V tile
#pragma unroll
    for (int k = 0; k < NO; ++k) fence_operands(o[k]);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < NO; ++k)
#pragma unroll
      for (int kk = 0; kk < TC_BKV / 16; ++kk)
        wgmma_rs_n128(o[k], pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                      desc_mnmajor(sV + 2 * k * TC_BKV * 128, TC_BKV, kk));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int k = 0; k < NO; ++k) fence_operands(o[k]);
    // buffer n % 2 is free for block n + 2
    if (n + 2 < nblk) named_barrier_arrive(BAR_FULL + 2 + (n & 1), 2 * 128);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = ra + 8 * i;
    if (row >= rows) continue;
    const int j = row / G, g = row - j * G;
    const float ls = (l[i] == 0.f) ? 1.f : l[i];
    __nv_bfloat16* orow = out + (((size_t)b * S + j) * H + hk * G + g) * DH + col0;
#pragma unroll
    for (int k = 0; k < NO; ++k)
#pragma unroll
      for (int jj = 0; jj < 16; ++jj)
        *reinterpret_cast<uint32_t*>(orow + 128 * k + 8 * jj) =
            pack_bf16(o[k][4 * jj + 2 * i] / ls, o[k][4 * jj + 2 * i + 1] / ls);
  }
}

// the dynamic shared memory a kernel may ask for, set once per kernel and
// device (a per-call cudaFuncSetAttribute costs host time on every launch)
constexpr int SMEM_LIMIT = 232448;

cudaError_t allow_smem_once(const void* kernel, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_acq_rel);
  return err;
}

// the pages a share can span: ceil(ceil(L / 32) / shares) blocks
int split_pages(int L, int MP, int T, int shares) {
  const int blocks = (L + SPLIT_SLOTS - 1) / SPLIT_SLOTS;
  const int share = (blocks + shares - 1) / shares * SPLIT_SLOTS;
  const int pages = (share + T - 1) / T + 1;
  return pages < MP ? pages : MP;
}

template <int DH, int R>
cudaError_t launch_split(int cluster, int shares, cudaStream_t st, const void* q, const void* k8,
                         const void* ks, const void* v8, const void* vs, const void* kv_start,
                         const void* kv_stop0, const void* table, void* out, int B, int H,
                         int Hkv, int L, int MP, int T, float scale) {
  static std::atomic<unsigned long long> ready{0};
  auto kernel = attend_split_kernel<DH, R>;
  cudaError_t err = allow_smem_once((const void*)kernel, ready);
  if (err != cudaSuccess) return err;
  const int tiles = (H / Hkv + R - 1) / R;
  const int pages = table != nullptr ? split_pages(L, MP, T, shares) : 0;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * cluster, Hkv, B);
  cfg.blockDim = dim3(SPLIT_THREADS);
  cfg.dynamicSmemBytes = SplitSmem<DH>::bytes(R, shares, pages);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k8),
      static_cast<const __nv_bfloat16*>(ks), static_cast<const int8_t*>(v8),
      static_cast<const __nv_bfloat16*>(vs), static_cast<const int*>(kv_start),
      static_cast<const int*>(kv_stop0), static_cast<const int*>(table),
      static_cast<__nv_bfloat16*>(out), H, Hkv, L, MP, T, scale, shares);
}

// rows per CTA: G rounded up to 1, 2, 4 or 8 (above 8, tiles of 8)
template <int DH>
cudaError_t launch_split_rows(int cluster, int shares, cudaStream_t st, const void* q,
                              const void* k8, const void* ks, const void* v8, const void* vs,
                              const void* kv_start, const void* kv_stop0, const void* table,
                              void* out, int B, int H, int Hkv, int L, int MP, int T,
                              float scale) {
  const int G = H / Hkv;
  if (G <= 1)
    return launch_split<DH, 1>(cluster, shares, st, q, k8, ks, v8, vs, kv_start, kv_stop0,
                               table, out, B, H, Hkv, L, MP, T, scale);
  if (G <= 2)
    return launch_split<DH, 2>(cluster, shares, st, q, k8, ks, v8, vs, kv_start, kv_stop0,
                               table, out, B, H, Hkv, L, MP, T, scale);
  if (G <= 4)
    return launch_split<DH, 4>(cluster, shares, st, q, k8, ks, v8, vs, kv_start, kv_stop0,
                               table, out, B, H, Hkv, L, MP, T, scale);
  return launch_split<DH, 8>(cluster, shares, st, q, k8, ks, v8, vs, kv_start, kv_stop0, table,
                             out, B, H, Hkv, L, MP, T, scale);
}

template <int DH>
void launch_tc(dim3 grid, cudaStream_t st, const void* q, const void* k8, const void* ks,
               const void* v8, const void* vs, const void* kv_start, const void* kv_stop0,
               const void* table, void* out, int S, int H, int Hkv, int L, int MP, int T,
               float scale) {
  cudaFuncSetAttribute(attend_tc_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       TcSmem<DH>::BYTES);
  attend_tc_kernel<DH><<<grid, TC_THREADS, TcSmem<DH>::BYTES, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k8),
      static_cast<const __nv_bfloat16*>(ks), static_cast<const int8_t*>(v8),
      static_cast<const __nv_bfloat16*>(vs), static_cast<const int*>(kv_start),
      static_cast<const int*>(kv_stop0), static_cast<const int*>(table),
      static_cast<__nv_bfloat16*>(out), S, H, Hkv, L, MP, T, scale);
}

// `cluster` picks the body: 0 the tensor-core one (64-row tiles, dh 128 or
// 256, any S); 1, 2, 4 or 8 the single-query one (S = 1), each window cut
// into `shares` shares (1-8, a multiple of the cluster) placed over a
// cluster of that many CTAs
int launch(int cluster, int shares, const void* q, const void* k8, const void* ks, const void* v8,
           const void* vs, const void* kv_start, const void* kv_stop0, const void* table,
           void* out, int B, int S, int H, int Hkv, int L, int dh, int MP, int T, float scale,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh != 128 && dh != 256) return (int)cudaErrorInvalidValue;
  if (cluster == 0) {
    dim3 grid((S * (H / Hkv) + TC_ROWS - 1) / TC_ROWS, Hkv, B);
    if (dh == 128) {
      launch_tc<128>(grid, st, q, k8, ks, v8, vs, kv_start, kv_stop0, table, out, S, H, Hkv, L,
                     MP, T, scale);
    } else {
      launch_tc<256>(grid, st, q, k8, ks, v8, vs, kv_start, kv_stop0, table, out, S, H, Hkv, L,
                     MP, T, scale);
    }
    return (int)cudaGetLastError();
  }
  if (S != 1 || cluster < 1 || cluster > MAX_CLUSTER || (cluster & (cluster - 1)) ||
      shares < cluster || shares > MAX_CLUSTER || shares % cluster)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      dh == 128 ? launch_split_rows<128>(cluster, shares, st, q, k8, ks, v8, vs, kv_start,
                                         kv_stop0, table, out, B, H, Hkv, L, MP, T, scale)
                : launch_split_rows<256>(cluster, shares, st, q, k8, ks, v8, vs, kv_start,
                                         kv_stop0, table, out, B, H, Hkv, L, MP, T, scale);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, S, H, dh) bf16, query j attending [kv_start, kv_stop0 + j);
// k8/v8 (B, Hkv, L, dh) int8; ks/vs (B, Hkv, 1, L) bf16; kv_start/kv_stop0
// (B,) int32; out (B, S, H, dh) bf16; dh 128 or 256; `cluster` and
// `shares` as `launch` (cluster 0: the tensor-core body; 1-8: the
// single-query body, S = 1).  Returns cudaGetLastError().
int decode_attention_chunk_launch(int cluster, int shares, const void* q, const void* k8,
                                  const void* ks, const void* v8, const void* vs,
                                  const void* kv_start, const void* kv_stop0,
                                  void* out, int B, int S, int H, int Hkv, int L,
                                  int dh, float scale, void* stream) {
  return launch(cluster, shares, q, k8, ks, v8, vs, kv_start, kv_stop0, nullptr, out, B, S, H,
                Hkv, L, dh, 0, 1, scale, stream);
}

// The same through a page table: k8/v8 pages (P, Hkv, T, dh) int8, ks/vs
// pages (P, Hkv, 1, T) bf16, table (B, MP) int32 of physical page ids;
// the cache length is MP * T.  Returns cudaGetLastError().
int paged_decode_attention_chunk_launch(int cluster, int shares, const void* q, const void* k8,
                                        const void* ks, const void* v8, const void* vs,
                                        const void* kv_start, const void* kv_stop0,
                                        const void* table, void* out, int B, int S, int H,
                                        int Hkv, int MP, int T, int dh, float scale,
                                        void* stream) {
  return launch(cluster, shares, q, k8, ks, v8, vs, kv_start, kv_stop0, table, out, B, S, H,
                Hkv, MP * T, dh, MP, T, scale, stream);
}

// Resources of the single-query body (dh 128 at G = 1 and G = 4, dh 256 at
// G = 2; dense, so no page ids) and of the tensor-core body at dh 128 and
// 256, six ints each: registers per thread, static shared bytes, dynamic
// shared bytes, local (spill) bytes per thread, threads per CTA, CTAs per
// SM.  Returns the first CUDA error.
int decode_attention_resources(int* res) {
  static std::atomic<unsigned long long> r1{0}, r4{0}, r2{0};
  const void* fns[5] = {(const void*)attend_split_kernel<128, 1>,
                        (const void*)attend_split_kernel<128, 4>,
                        (const void*)attend_split_kernel<256, 2>,
                        (const void*)attend_tc_kernel<128>, (const void*)attend_tc_kernel<256>};
  const int threads[5] = {SPLIT_THREADS, SPLIT_THREADS, SPLIT_THREADS, TC_THREADS, TC_THREADS};
  const int smem[5] = {SplitSmem<128>::bytes(1, 4, 0), SplitSmem<128>::bytes(4, 4, 0),
                       SplitSmem<256>::bytes(2, 4, 0), TcSmem<128>::BYTES, TcSmem<256>::BYTES};
  std::atomic<unsigned long long>* ready[3] = {&r1, &r4, &r2};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = allow_smem_once(fns[i], *ready[i]);
    if (err != cudaSuccess) return (int)err;
  }
  cudaFuncSetAttribute(attend_tc_kernel<128>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       TcSmem<128>::BYTES);
  cudaFuncSetAttribute(attend_tc_kernel<256>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       TcSmem<256>::BYTES);
  for (int i = 0; i < 5; ++i) {
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
