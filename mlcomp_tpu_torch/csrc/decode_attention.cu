// Flash decode over an int8 KV cache: one query per row (B3) and S chunk
// queries per row (B4), over a dense cache or through a page table (B6,
// B7), one kernel body for all four.
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
// The design: a query ROW is one (query j, group head g) pair, r = j * G + g
// with G = H / Hkv, so the G heads sharing a KV head sit side by side.  One
// CTA takes a tile of up to 8 such rows of one (batch row, KV head) and
// walks only the KV blocks that intersect the tile's live range
// [kv_start, max stop), staging 128 slots of K and V at a time through
// shared memory with 16-byte loads.  Each row keeps its own online softmax
// (m, l, acc) in f32 and its own causal stop; a block past a row's stop
// leaves that row unchanged.  The query tiles are a grid axis, so ONE
// launch covers any S: the TPU sweeps 32 queries per pallas_call because
// of VMEM, which is no contract of the result, since each query's window
// and arithmetic do not depend on the tile it rides in.  B3 is the S = 1
// case of the same kernel (one tile of G rows), so a one-query chunk
// equals the single-query decode bit for bit.  At B = 8, Hkv = 16 a decode
// step is 128 CTAs on 132 SMs; the admission chunk is 32 tiles x 16 heads
// = 512 CTAs.
//
// Paging is addressing only.  Slot i of (row b, KV head h) lives at
// (b * Hkv + h) * L + i in the dense cache and at
// (table[b, i / T] * Hkv + h) * T + i % T in the pages, for values and
// scales alike.  Each block first resolves its 128 slots' addresses into
// shared memory (one table read per slot, only for slots below the tile's
// stop, so table columns past the window are never read), then runs the
// same loads, reductions and roundings as the dense case: paged equals
// dense bit for bit on the same bytes, for any T.  The TPU kernel's page
// DMA schedules are VMEM plumbing and have no counterpart here.
//
// Arithmetic follows the TPU kernel, in its order: logits are (q . k) *
// scale * ks with q in bf16, k int8 (exact in bf16) and f32 sums; masked
// slots are -1e30; p = exp(s - m_new), forced to 0 while the row has seen
// no live slot; the V scale folds into p, which rounds to bf16 before it
// multiplies V; the end divides by l, and l == 0 (an empty window) gives 0.
// A masked slot's p * vs is SELECTED to 0, never multiplied: a masked
// slot inside a live block still loads whatever its page holds (a retired
// row's writes, a freed page's old bytes), and 0 x a non-finite scale
// would poison the sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

int launch(const void* q, const void* k8, const void* ks, const void* v8, const void* vs,
           const void* kv_start, const void* kv_stop0, const void* table, void* out, int B,
           int S, int H, int Hkv, int L, int dh, int MP, int T, float scale, void* stream) {
  const int smem = MAX_R * dh * 4 + BLK * (dh + 16) + BLK * dh + 2 * BLK * 4 +
                   MAX_R * BLK * 4 + 8 * 4 + BLK * 8;
  cudaFuncSetAttribute(attend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int rows = S * (H / Hkv);
  dim3 grid((rows + MAX_R - 1) / MAX_R, Hkv, B);
  attend_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
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
// (B,) int32; out (B, S, H, dh) bf16; dh 128 or 256.  The single-query
// decode is S = 1.  Returns cudaGetLastError().
int decode_attention_chunk_launch(const void* q, const void* k8, const void* ks,
                                  const void* v8, const void* vs,
                                  const void* kv_start, const void* kv_stop0,
                                  void* out, int B, int S, int H, int Hkv, int L,
                                  int dh, float scale, void* stream) {
  return launch(q, k8, ks, v8, vs, kv_start, kv_stop0, nullptr, out, B, S, H, Hkv, L, dh,
                0, 1, scale, stream);
}

// The same through a page table: k8/v8 pages (P, Hkv, T, dh) int8, ks/vs
// pages (P, Hkv, 1, T) bf16, table (B, MP) int32 of physical page ids;
// the cache length is MP * T.  Returns cudaGetLastError().
int paged_decode_attention_chunk_launch(const void* q, const void* k8, const void* ks,
                                        const void* v8, const void* vs,
                                        const void* kv_start, const void* kv_stop0,
                                        const void* table, void* out, int B, int S, int H,
                                        int Hkv, int MP, int T, int dh, float scale,
                                        void* stream) {
  return launch(q, k8, ks, v8, vs, kv_start, kv_stop0, table, out, B, S, H, Hkv, MP * T,
                dh, MP, T, scale, stream);
}

}  // extern "C"
