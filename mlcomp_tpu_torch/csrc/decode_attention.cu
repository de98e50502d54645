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
// What bounds it on an H100: bytes.  Each CTA reads the int8 K/V of its
// row's live window once and does a few FLOPs per byte.  A decode step
// (B3) reads the whole live window of every row; an admission chunk (B4,
// q (1, 256, 16, 128) against a 768-slot cache) reads ~0.13 MB of K/V
// per head and does ~0.8 GFLOP in all: microseconds of work, so at that
// shape launch latency and the CTA's serial block loop bound it.
//
// The design: a query ROW is one (query j, group head g) pair, r = j * G +
// g with G = H / Hkv, so the G heads sharing a KV head sit side by side.  A
// CTA takes a tile of rows of one (batch row, KV head) and walks only the KV
// blocks that intersect the tile's live range [kv_start, max stop).  Each
// row keeps its own online softmax (m, l, acc) in f32 and its own causal
// stop.  The query tiles are a grid axis, so ONE launch covers any S: the
// TPU sweeps 32 queries per pallas_call because of VMEM, which is no
// contract of the result, since each query's window and arithmetic do not
// depend on the tile it rides in.  Two bodies, picked by the wrapper's
// `chunk_plan`:
//
// - `attend_kernel` (S = 1: B3, B6, and a one-query chunk): tiles of up to
//   8 rows, 128 slots of K and V at a time staged through shared memory
//   with 16-byte loads, products on the CUDA cores (one thread a slot for
//   q . k, one a head dim for p . v).  At B = 8, Hkv = 16 a decode step is
//   128 CTAs on 132 SMs.  A one-query chunk equals the single-query decode
//   bit for bit: it is the same launch.
// - `attend_tc_kernel` (S > 1: B4, B7): tiles of 64 rows on the tensor
//   cores (wgmma.cuh).  The (1, 256) admission chunk is 4 tiles x 16 heads
//   = 64 CTAs, each reading its K/V window once per 64 rows (the CUDA-core
//   body read it once per 8: 512 CTAs).  A CTA is two warpgroups.  The
//   producer brings each block of 64 slots' raw int8 K and V by cp.async
//   (two blocks ahead), converts them to bf16 (exact) into one of two
//   buffers of 128-byte-swizzled tiles, K and V alike one slot a row, with
//   the block's scales beside them, and hands the buffer over by a named
//   barrier.  The consumer runs S = Q K^T as a wgmma m64n64k16 (Q and K
//   K-major), the online softmax on the accumulator layout (exp on the
//   SFU; the mask only on blocks that cross a window edge or a causal
//   stop), rounds p * vs to bf16 in registers as the A operand of O += P V
//   (V read MN-major, the transpose bit), keeps O (64 x dh, f32) in
//   registers, and hands the buffer back.  Conversion of block n + 1 thus
//   runs beside the products and softmax of block n.  Head dims 128 and 256
//   are template instances.  Slot addresses (a page-table read) and scales
//   run ahead of the copies in registers, so no read stalls the block loop.
//
// Paging is addressing only.  Slot i of (row b, KV head h) lives at
// (b * Hkv + h) * L + i in the dense cache and at
// (table[b, i / T] * Hkv + h) * T + i % T in the pages, for values and
// scales alike.  Each block first resolves its slots' addresses (one
// table read per slot, only for slots inside the tile's live range, so
// table columns past the window are never read; slots outside it are
// zero-filled in both layouts), then runs the same loads, reductions and
// roundings as the dense case: paged equals dense bit for bit on the same
// bytes, for any T.  The TPU kernel's page DMA schedules are VMEM plumbing
// and have no counterpart here.
//
// Arithmetic follows the TPU kernel, in its order: logits are (q . k) *
// scale * ks with q in bf16, k int8 (exact in bf16) and f32 sums; masked
// slots are -1e30; p = exp(s - m_new), forced to 0 while the row has seen
// no live slot; the V scale folds into p, which rounds to bf16 before it
// multiplies V; l sums the unscaled p; the end divides by l, and l == 0
// (an empty window) gives 0.  The two bodies sum in different orders (the
// card check is the 2^-7 (|ref| + ref_abs) rule); neither uses atomics,
// so a rerun gives the same bits.
// A masked slot's p * vs is SELECTED to 0, never multiplied: a masked
// slot inside a live block still loads whatever its page holds (a retired
// row's writes, a freed page's old bytes), and 0 x a non-finite scale
// would poison the sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int BLK = 128;          // slots per staged block (one per thread)
constexpr int MAX_R = 8;          // query rows per CTA
constexpr int MAX_DH = 256;
constexpr float NEG_INF = -1e30f;

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

// smem layout (bytes, all 16-aligned): qs R*dh f32 | kb BLK*(dh+16) i8 |
// vb BLK*dh i8 | ksc BLK f32 | vsc BLK f32 | pv R*BLK f32 | red 2*4 f32 |
// addr BLK i64
//
// q (B, S, H, dh); out (B, S, H, dh); grid (tiles of MAX_R rows, Hkv, B).
// table == nullptr: k8/v8 (B, Hkv, L, dh), ks/vs (B, Hkv, 1, L).
// Otherwise table (B, MP) int32, k8/v8 (P, Hkv, T, dh), ks/vs
// (P, Hkv, 1, T), and L = MP * T.
__global__ void __launch_bounds__(THREADS)
attend_kernel(const __nv_bfloat16* __restrict__ q,
              const int8_t* __restrict__ k8,
              const __nv_bfloat16* __restrict__ ks,
              const int8_t* __restrict__ v8,
              const __nv_bfloat16* __restrict__ vs,
              const int* __restrict__ kv_start,
              const int* __restrict__ kv_stop0,
              const int* __restrict__ table,
              __nv_bfloat16* __restrict__ out,
              int S, int H, int Hkv, int L, int dh, int MP, int T, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / Hkv;
  const int kstride = dh + 16;     // padded K rows: conflict-free 16 B reads
  float* qs = reinterpret_cast<float*>(smem);
  int8_t* kb = reinterpret_cast<int8_t*>(qs + MAX_R * dh);
  int8_t* vb = kb + BLK * kstride;
  float* ksc = reinterpret_cast<float*>(vb + BLK * dh);
  float* vsc = ksc + BLK;
  float* pv = vsc + BLK;
  float* red = pv + MAX_R * BLK;
  long long* addr = reinterpret_cast<long long*>(red + 8);  // slot -> row index

  const int r0 = blockIdx.x * MAX_R;           // first row of this tile
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int R = min(MAX_R, S * G - r0);        // rows in this tile
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;

  const int lo = max(kv_start[b], 0);
  const int stop0 = kv_stop0[b];
  int hi[MAX_R];
  int hi_max = 0;
#pragma unroll
  for (int r = 0; r < MAX_R; ++r) {
    hi[r] = (r < R) ? min(stop0 + (r0 + r) / G, L) : 0;
    hi_max = max(hi_max, hi[r]);
  }

  for (int i = t; i < R * dh; i += THREADS) {
    const int row = r0 + i / dh;
    const int j = row / G, g = row - (row / G) * G;
    qs[i] = __bfloat162float(q[(((size_t)b * S + j) * H + hk * G + g) * dh + i % dh]);
  }

  const size_t row_base = ((size_t)b * Hkv + hk) * L;  // slot 0 of this (b, hkv)
  const int ndim = dh / THREADS;                       // output dims per thread
  float acc[MAX_R][MAX_DH / THREADS];
  float m[MAX_R], l[MAX_R];
#pragma unroll
  for (int r = 0; r < MAX_R; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_DH / THREADS; ++i) acc[r][i] = 0.f;
  }

  for (int j0 = (lo / BLK) * BLK; j0 < hi_max; j0 += BLK) {
    __syncthreads();  // the previous block's smem reads are done
    {
      // this block's slot addresses (rows of dh values, and scale indices)
      const int i = j0 + t;
      const bool in = i < hi_max;
      long long a = -1;
      if (in) {
        a = table == nullptr
                ? (long long)(row_base + i)
                : ((long long)table[(size_t)b * MP + i / T] * Hkv + hk) * T + i % T;
      }
      addr[t] = a;
      ksc[t] = in ? __bfloat162float(ks[a]) : 0.f;
      vsc[t] = in ? __bfloat162float(vs[a]) : 0.f;
    }
    __syncthreads();
    const int vec = dh / 16;
    for (int i = t; i < BLK * vec; i += THREADS) {
      const int j = i / vec;
      const int c = (i - j * vec) * 16;
      int4 kv = make_int4(0, 0, 0, 0), vv = make_int4(0, 0, 0, 0);
      const long long a = addr[j];
      if (a >= 0) {
        kv = __ldg(reinterpret_cast<const int4*>(k8 + a * dh + c));
        vv = __ldg(reinterpret_cast<const int4*>(v8 + a * dh + c));
      }
      *reinterpret_cast<int4*>(kb + j * kstride + c) = kv;
      *reinterpret_cast<int4*>(vb + j * dh + c) = vv;
    }
    __syncthreads();

    const int slot = j0 + t;
    float alpha[MAX_R];
#pragma unroll
    for (int r = 0; r < MAX_R; ++r) {
      if (r >= R) break;
      const bool live = slot >= lo && slot < hi[r];
      float dot = 0.f;
      const float* qr = qs + r * dh;
      for (int d = 0; d < dh; d += 16) {
        const int4 raw = *reinterpret_cast<const int4*>(kb + t * kstride + d);
        const int8_t* kk = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int e = 0; e < 16; ++e) dot = fmaf(qr[d + e], (float)kk[e], dot);
      }
      float s = (dot * scale) * ksc[t];
      s = live ? s : NEG_INF;
      // block max over the 128 slots
      float bm = warp_max(s);
      if (lane == 0) red[warp] = bm;
      __syncthreads();
      bm = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
      const float m_new = fmaxf(m[r], bm);
      const float p = (m_new > NEG_INF / 2) ? expf(s - m_new) : 0.f;
      float bs = warp_sum(p);
      if (lane == 0) red[4 + warp] = bs;
      __syncthreads();
      bs = (red[4] + red[5]) + (red[6] + red[7]);
      alpha[r] = expf(m[r] - m_new);
      l[r] = alpha[r] * l[r] + bs;
      m[r] = m_new;
      pv[r * BLK + t] = live ? __bfloat162float(__float2bfloat16(p * vsc[t])) : 0.f;
      __syncthreads();  // red is reused by the next row; pv complete
    }
#pragma unroll
    for (int r = 0; r < MAX_R; ++r) {
      if (r >= R) break;
      const float* pr = pv + r * BLK;
#pragma unroll
      for (int i = 0; i < MAX_DH / THREADS; ++i) {
        if (i >= ndim) break;
        const int d = t + i * THREADS;
        float dv = 0.f;
        for (int j = 0; j < BLK; ++j) dv = fmaf(pr[j], (float)vb[j * dh + d], dv);
        acc[r][i] = acc[r][i] * alpha[r] + dv;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < MAX_R; ++r) {
    if (r >= R) break;
    const int row = r0 + r;
    const int j = row / G, g = row - (row / G) * G;
    const float lr = (l[r] == 0.f) ? 1.f : l[r];
#pragma unroll
    for (int i = 0; i < MAX_DH / THREADS; ++i) {
      if (i >= ndim) break;
      const int d = t + i * THREADS;
      out[(((size_t)b * S + j) * H + hk * G + g) * dh + d] = __float2bfloat16(acc[r][i] / lr);
    }
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

// grid (ceil(S * G / 64), Hkv, B), 256 threads.  Operands as attend_kernel.
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

int attend_smem(int dh) {
  return MAX_R * dh * 4 + BLK * (dh + 16) + BLK * dh + 2 * BLK * 4 + MAX_R * BLK * 4 + 8 * 4 +
         BLK * 8;
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

// `tc` picks the body: 0 the CUDA-core one (8-row tiles), 1 the tensor-core
// one (64-row tiles, dh 128 or 256)
int launch(int tc, const void* q, const void* k8, const void* ks, const void* v8,
           const void* vs, const void* kv_start, const void* kv_stop0, const void* table,
           void* out, int B, int S, int H, int Hkv, int L, int dh, int MP, int T, float scale,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = S * (H / Hkv);
  if (tc) {
    dim3 grid((rows + TC_ROWS - 1) / TC_ROWS, Hkv, B);
    if (dh == 128) {
      launch_tc<128>(grid, st, q, k8, ks, v8, vs, kv_start, kv_stop0, table, out, S, H, Hkv, L,
                     MP, T, scale);
    } else if (dh == 256) {
      launch_tc<256>(grid, st, q, k8, ks, v8, vs, kv_start, kv_stop0, table, out, S, H, Hkv, L,
                     MP, T, scale);
    } else {
      return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
  }
  const int smem = attend_smem(dh);
  cudaFuncSetAttribute(attend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid((rows + MAX_R - 1) / MAX_R, Hkv, B);
  attend_kernel<<<grid, THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k8),
      static_cast<const __nv_bfloat16*>(ks), static_cast<const int8_t*>(v8),
      static_cast<const __nv_bfloat16*>(vs), static_cast<const int*>(kv_start),
      static_cast<const int*>(kv_stop0), static_cast<const int*>(table),
      static_cast<__nv_bfloat16*>(out), S, H, Hkv, L, dh, MP, T, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, S, H, dh) bf16, query j attending [kv_start, kv_stop0 + j);
// k8/v8 (B, Hkv, L, dh) int8; ks/vs (B, Hkv, 1, L) bf16; kv_start/kv_stop0
// (B,) int32; out (B, S, H, dh) bf16; dh 128 or 256; `tc` as `launch`.
// The single-query decode is S = 1 on the CUDA-core body.  Returns
// cudaGetLastError().
int decode_attention_chunk_launch(int tc, const void* q, const void* k8, const void* ks,
                                  const void* v8, const void* vs,
                                  const void* kv_start, const void* kv_stop0,
                                  void* out, int B, int S, int H, int Hkv, int L,
                                  int dh, float scale, void* stream) {
  return launch(tc, q, k8, ks, v8, vs, kv_start, kv_stop0, nullptr, out, B, S, H, Hkv, L, dh,
                0, 1, scale, stream);
}

// The same through a page table: k8/v8 pages (P, Hkv, T, dh) int8, ks/vs
// pages (P, Hkv, 1, T) bf16, table (B, MP) int32 of physical page ids;
// the cache length is MP * T.  Returns cudaGetLastError().
int paged_decode_attention_chunk_launch(int tc, const void* q, const void* k8, const void* ks,
                                        const void* v8, const void* vs,
                                        const void* kv_start, const void* kv_stop0,
                                        const void* table, void* out, int B, int S, int H,
                                        int Hkv, int MP, int T, int dh, float scale,
                                        void* stream) {
  return launch(tc, q, k8, ks, v8, vs, kv_start, kv_stop0, table, out, B, S, H, Hkv, MP * T,
                dh, MP, T, scale, stream);
}

// Resources of the CUDA-core body (at dh 128) and of the tensor-core body
// at dh 128 and 256, six ints each: registers per thread, static shared
// bytes, dynamic shared bytes, local (spill) bytes per thread, threads per
// CTA, CTAs per SM.  Returns the first CUDA error.
int decode_attention_resources(int* res) {
  cudaFuncSetAttribute(attend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       attend_smem(128));
  cudaFuncSetAttribute(attend_tc_kernel<128>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       TcSmem<128>::BYTES);
  cudaFuncSetAttribute(attend_tc_kernel<256>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       TcSmem<256>::BYTES);
  const void* fns[3] = {(const void*)attend_kernel, (const void*)attend_tc_kernel<128>,
                        (const void*)attend_tc_kernel<256>};
  const int threads[3] = {THREADS, TC_THREADS, TC_THREADS};
  const int smem[3] = {attend_smem(128), TcSmem<128>::BYTES, TcSmem<256>::BYTES};
  for (int i = 0; i < 3; ++i) {
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
