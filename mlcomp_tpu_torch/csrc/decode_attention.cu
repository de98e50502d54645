// Single-query flash decode over an int8 KV cache.
//
// Replaces the Pallas kernel `_kernel` (with `_flash_block_update` and
// `_flash_finalize`) of mlcomp_tpu/ops/pallas/decode_attention.py, launched
// by `decode_attention`:
//
//     out[b, h, :] = softmax_j(q[b, h] . k8[b, hkv, j] * scale * ks[b, hkv, j])
//                    @ (v8[b, hkv, j] * vs[b, hkv, j])     for j in [lo_b, hi_b)
//
// What bounds it on an H100: the int8 K/V bytes of each row's live window,
// read once per generated token; the arithmetic is a few FLOPs per byte.
// The design: one CTA per (batch row, KV head) holds the G = H / Hkv query
// heads of its group, so each shared KV head is read once; the CTA walks
// only the blocks that intersect [kv_start, kv_stop) (dead blocks are never
// read: the not-yet-generated tail of the buffer costs nothing), staging
// 128 slots of K and V at a time through shared memory with 16-byte loads,
// and keeps the online softmax (m, l, acc) in f32.  At B = 8 and Hkv = 16
// that is 128 CTAs on 132 SMs; a batch of 1 leaves most SMs idle and will
// need the KV axis split across CTAs (a later change).
//
// Arithmetic follows the TPU kernel, in its order: logits are (q . k) *
// scale * ks with q in bf16, k int8 (exact in bf16) and f32 sums; masked
// slots are -1e30; p = exp(s - m_new), forced to 0 while the row has seen
// no live slot; the V scale folds into p, which rounds to bf16 before it
// multiplies V; the end divides by l, and l == 0 (an empty window) gives 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int BLK = 128;          // slots per staged block (one per thread)
constexpr int MAX_G = 8;          // query heads per KV head
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

// smem layout (bytes, all 16-aligned): qs G*dh f32 | kb BLK*(dh+16) i8 |
// vb BLK*dh i8 | ksc BLK f32 | vsc BLK f32 | pv G*BLK f32 | red 2*4 f32
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q,
                        const int8_t* __restrict__ k8,
                        const __nv_bfloat16* __restrict__ ks,
                        const int8_t* __restrict__ v8,
                        const __nv_bfloat16* __restrict__ vs,
                        const int* __restrict__ kv_start,
                        const int* __restrict__ kv_stop,
                        __nv_bfloat16* __restrict__ out,
                        int H, int Hkv, int L, int dh, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / Hkv;
  const int kstride = dh + 16;     // padded K rows: conflict-free 16 B reads
  float* qs = reinterpret_cast<float*>(smem);
  int8_t* kb = reinterpret_cast<int8_t*>(qs + G * dh);
  int8_t* vb = kb + BLK * kstride;
  float* ksc = reinterpret_cast<float*>(vb + BLK * dh);
  float* vsc = ksc + BLK;
  float* pv = vsc + BLK;
  float* red = pv + G * BLK;

  const int b = blockIdx.y;
  const int hk = blockIdx.x;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;

  const int lo = max(kv_start[b], 0);
  const int hi = min(kv_stop[b], L);

  for (int i = t; i < G * dh; i += THREADS)
    qs[i] = __bfloat162float(q[((size_t)b * H + hk * G) * dh + i]);

  const size_t row_base = ((size_t)b * Hkv + hk) * L;  // slot 0 of this (b, hkv)
  const int ndim = dh / THREADS;                       // output dims per thread
  float acc[MAX_G][MAX_DH / THREADS];
  float m[MAX_G], l[MAX_G];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_DH / THREADS; ++i) acc[g][i] = 0.f;
  }

  for (int j0 = (lo / BLK) * BLK; j0 < hi; j0 += BLK) {
    __syncthreads();  // the previous block's smem reads are done
    const int vec = dh / 16;
    for (int i = t; i < BLK * vec; i += THREADS) {
      const int j = i / vec;
      const int c = (i - j * vec) * 16;
      int4 kv = make_int4(0, 0, 0, 0), vv = make_int4(0, 0, 0, 0);
      if (j0 + j < hi) {
        kv = __ldg(reinterpret_cast<const int4*>(k8 + (row_base + j0 + j) * dh + c));
        vv = __ldg(reinterpret_cast<const int4*>(v8 + (row_base + j0 + j) * dh + c));
      }
      *reinterpret_cast<int4*>(kb + j * kstride + c) = kv;
      *reinterpret_cast<int4*>(vb + j * dh + c) = vv;
    }
    {
      const bool in = j0 + t < hi;
      ksc[t] = in ? __bfloat162float(ks[row_base + j0 + t]) : 0.f;
      vsc[t] = in ? __bfloat162float(vs[row_base + j0 + t]) : 0.f;
    }
    __syncthreads();

    const int slot = j0 + t;
    const bool live = slot >= lo && slot < hi;
    float alpha[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g >= G) break;
      float dot = 0.f;
      const float* qg = qs + g * dh;
      for (int d = 0; d < dh; d += 16) {
        const int4 raw = *reinterpret_cast<const int4*>(kb + t * kstride + d);
        const int8_t* kk = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int e = 0; e < 16; ++e) dot = fmaf(qg[d + e], (float)kk[e], dot);
      }
      float s = (dot * scale) * ksc[t];
      s = live ? s : NEG_INF;
      // block max over the 128 slots
      float bm = warp_max(s);
      if (lane == 0) red[warp] = bm;
      __syncthreads();
      bm = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
      const float m_new = fmaxf(m[g], bm);
      const float p = (m_new > NEG_INF / 2) ? expf(s - m_new) : 0.f;
      float bs = warp_sum(p);
      if (lane == 0) red[4 + warp] = bs;
      __syncthreads();
      bs = (red[4] + red[5]) + (red[6] + red[7]);
      alpha[g] = expf(m[g] - m_new);
      l[g] = alpha[g] * l[g] + bs;
      m[g] = m_new;
      pv[g * BLK + t] = __bfloat162float(__float2bfloat16(p * vsc[t]));
      __syncthreads();  // red is reused by the next head; pv complete
    }
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g >= G) break;
      const float* pg = pv + g * BLK;
#pragma unroll
      for (int i = 0; i < MAX_DH / THREADS; ++i) {
        if (i >= ndim) break;
        const int d = t + i * THREADS;
        float dv = 0.f;
        for (int j = 0; j < BLK; ++j) dv = fmaf(pg[j], (float)vb[j * dh + d], dv);
        acc[g][i] = acc[g][i] * alpha[g] + dv;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    if (g >= G) break;
    const float lg = (l[g] == 0.f) ? 1.f : l[g];
#pragma unroll
    for (int i = 0; i < MAX_DH / THREADS; ++i) {
      if (i >= ndim) break;
      const int d = t + i * THREADS;
      out[((size_t)b * H + hk * G + g) * dh + d] = __float2bfloat16(acc[g][i] / lg);
    }
  }
}

}  // namespace

extern "C" {

int decode_attention_smem_bytes(int G, int dh) {
  return G * dh * 4 + BLK * (dh + 16) + BLK * dh + 2 * BLK * 4 + G * BLK * 4 + 8 * 4;
}

// q (B, H, dh) bf16; k8/v8 (B, Hkv, L, dh) int8; ks/vs (B, Hkv, 1, L)
// bf16; kv_start/kv_stop (B,) int32; out (B, H, dh) bf16.  dh is 128 or
// 256; H / Hkv <= 8.  Returns cudaGetLastError().
int decode_attention_launch(const void* q, const void* k8, const void* ks,
                            const void* v8, const void* vs,
                            const void* kv_start, const void* kv_stop,
                            void* out, int B, int H, int Hkv, int L, int dh,
                            float scale, void* stream) {
  const int smem = decode_attention_smem_bytes(H / Hkv, dh);
  cudaFuncSetAttribute(decode_attention_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid(Hkv, B);
  decode_attention_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k8),
      static_cast<const __nv_bfloat16*>(ks), static_cast<const int8_t*>(v8),
      static_cast<const __nv_bfloat16*>(vs), static_cast<const int*>(kv_start),
      static_cast<const int*>(kv_stop), static_cast<__nv_bfloat16*>(out), H,
      Hkv, L, dh, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
