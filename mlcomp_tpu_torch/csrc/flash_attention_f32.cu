// Flash attention on f32 inputs, forward and backward (delta, dq, dk/dv),
// causal and/or bounded by per-row key windows [kv_lo, kv_hi), with GQA,
// at head dims 64, 128 and 256 (the wrapper zero-pads smaller heads, as for
// bf16).
//
// Replaces the same Pallas kernels as flash_attention.cu and
// flash_attention_bwd.cu (mlcomp_tpu/ops/pallas/flash_attention.py:
// `_fwd_kernel` :291, `_fwd_kernel_tri` :435, `_fwd_kernel_bsched` :507;
// `_dq_kernel` / `_dkv_kernel` :639 / :676, `_dq_kernel_tri` /
// `_dkv_kernel_tri` :738 / :761, `_dq_kernel_bsched` / `_dkv_kernel_bsched`
// :787 / :813) when they run on f32 inputs.  The TPU kernel then computes
// in f32 throughout: f32 products (`_dot` :86, `preferred_element_type`
// f32), an f32 softmax, and p kept in f32 before P V (`p.astype(v.dtype)`
// is a no-op).
//
// Products: Hopper's tensor cores in 3xTF32 (all but dp, below).  One
// TF32 pass keeps 10 mantissa bits and misses f32 tolerances, so every
// operand element x is split into big = cvt.rna.tf32(x) and small =
// cvt.rna.tf32(x - big), and each product accumulates small_a big_b +
// big_a small_b and then big_a big_b (the small x small term, ~2^-22
// relative, is the only one dropped), as CUTLASS's OpMultiplyAddFastF32
// does, on mma.sync.m16n8k8.tf32.  The split happens as each fragment is
// loaded from shared memory: the tiles land by cp.async exactly as they
// are in device memory, one plane, and the split's three instructions an
// element overlap the tensor cores' three products.
//
// What bounds it on an H100 (each of the four kernels): operations, at the
// card's 495 TFLOP/s of TF32 over the three passes (165 TFLOP/s of f32
// products; 67 TFLOP/s of FFMA for dp: 4 x dh operations per live pair
// forward, 10 x dh backward, 2 x dh of it dp, against 4 x 3 x dh bytes of
// Q/K/V rows).  The design:
// - mma.sync, not wgmma: wgmma reads a TF32 B operand K-major only, and
//   P V, dS K, P^T dO and dS^T Q would each need a transposed copy of a
//   tile.  mma.sync fragments load in any layout: every tile is row-major
//   at a pitch of DH + 4 floats, which makes both fragment patterns (the
//   head dim as the reduction, and the rows as the reduction) hit 32
//   banks.  A product whose A operand is an accumulator (P V, dS K, P^T dO,
//   dS^T Q) takes the accumulator's registers as they are, reading the
//   reduction's eight rows in the order 0, 2, 4, 6, 1, 3, 5, 7 and loading
//   B's rows in that order (`load_b_kn`).
// - the tensor cores' f32 accumulation truncates: each product sums a
//   short chain of mma.sync (two 8-deep steps of a logit tile, or one
//   streamed tile's share of O, dQ, dK or dV: 6 or 12) into a fresh partial
//   and adds it to its sum with a round-to-nearest add (on an H100 the
//   forward's largest error over its 2^-16 limit fell from 0.29 to 0.05 at
//   the causal 1 x 2048 case with 16 heads of 128).
// - a warp owns 16 rows (forward, dq) or 16 keys (dk/dv); the streamed
//   side arrives through a two-stage cp.async ring of 16-byte copies, the
//   next tile landing under the current tile's products, one
//   __syncthreads a tile.
// - forward: 64-row Q tiles, 32-key tiles; at dh 256 two warps share a
//   row block by columns (O's 256 columns would be 128 registers a
//   thread): each computes q.k over its half of the head dim, the halves
//   meet in shared memory and both warps run the same softmax.
// - dp (dO v^T) is the one product on the CUDA cores (FFMA, register-
//   tiled with 16-byte reads, `product_ffma`): ds = p (dp - delta)
//   cancels, and the 3xTF32 product's error, which scales with
//   sum_d |dO_d v_d|, broke the 2^-16 rule on an H100 at keys with few
//   live queries.
// - dq: 64-row Q tiles streaming 32 keys a tile (16 at dh 256), two warps
//   a row block by role: one computes dp and hands it over through shared
//   memory, the other s and p, dS and all of dQ (one CTA an SM: dQ's
//   registers).
// - dk/dv: 64-key tiles streaming 32 (dh 64) or 16 queries a tile; two
//   warps a key block by role: one computes s^T and p^T and owns all of
//   dV, the other dp^T and owns all of dK, p^T crossing through shared
//   memory.
// Semantics are the bf16 kernels': logits masked to -1e30; p selected to 0
// on masked logits, so a row whose causal-and-window key set is empty
// outputs 0 with lse -1e30 and gets zero gradients; the output divides by
// l (l == 0 gives 0).  No atomics: every sum runs in one fixed order, and
// the same inputs give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using hopper::cp_async_16;
using hopper::cp_async_4;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::named_barrier_arrive;
using hopper::named_barrier_sync;
using hopper::smem_u32;

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---- 3xTF32 products on mma.sync.m16n8k8 (PTX ISA fragment layouts, lane
// l, g = l / 4, t = l % 4): A (16 x 8) a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); B (8 x 8) b0 (k t, n g), b1 (k t + 4, n g); C (16 x 8)
// c0 (g, 2 t), c1 (g, 2 t + 1), c2 (g + 8, 2 t), c3 (g + 8, 2 t + 1).

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both TF32
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

template <int N>
struct Frag {
  uint32_t big[N], small[N];
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32: small_a big_b, big_a small_b, then big_a big_b
__device__ __forceinline__ void mma3(float (&d)[4], const Frag<4>& a, const Frag<2>& b) {
  mma_tf32(d, a.small, b.big);
  mma_tf32(d, a.big, b.small);
  mma_tf32(d, a.big, b.big);
}

// the A fragment at s[0][0] of a row-major tile of pitch P (rows are A's
// rows, columns its reduction)
template <int P>
__device__ __forceinline__ Frag<4> load_a(const float* s, int g, int t) {
  Frag<4> f;
  split(s[g * P + t], f.big[0], f.small[0]);
  split(s[(g + 8) * P + t], f.big[1], f.small[1]);
  split(s[g * P + t + 4], f.big[2], f.small[2]);
  split(s[(g + 8) * P + t + 4], f.big[3], f.small[3]);
  return f;
}

// the A fragment of an accumulator's eight columns c[0..3] (one n-tile of a
// C fragment), the reduction's rows in the order 0, 2, 4, 6, 1, 3, 5, 7
__device__ __forceinline__ Frag<4> a_of_acc(const float (&c)[4]) {
  Frag<4> f;
  split(c[0], f.big[0], f.small[0]);
  split(c[2], f.big[1], f.small[1]);
  split(c[1], f.big[2], f.small[2]);
  split(c[3], f.big[3], f.small[3]);
  return f;
}

// the B fragment at s[0][0] of a row-major tile whose rows are B's columns
// (B(k, n) = s[n][k]: the head dim as the reduction)
template <int P>
__device__ __forceinline__ Frag<2> load_b_nk(const float* s, int g, int t) {
  Frag<2> f;
  split(s[g * P + t], f.big[0], f.small[0]);
  split(s[g * P + t + 4], f.big[1], f.small[1]);
  return f;
}

// the B fragment at s[0][0] of a row-major tile whose rows are the
// reduction (B(k, n) = s[k][n]), the rows in a_of_acc's order
template <int P>
__device__ __forceinline__ Frag<2> load_b_kn(const float* s, int g, int t) {
  Frag<2> f;
  split(s[2 * t * P + g], f.big[0], f.small[0]);
  split(s[(2 * t + 1) * P + g], f.big[1], f.small[1]);
  return f;
}

// The tensor cores' f32 accumulation truncates, so a long chain of
// products into one accumulator loses up to 2^-24 of its value at each
// step.  The products below sum a short chain into a fresh partial and add
// the partial to their f32 sum with an ordinary (round-to-nearest) add.

// x (16 x 8 NT) += A B over DEPTH: A's rows from `a` (pitch P), B(k, n) =
// b[n][k] (the head dim as the reduction)
template <int P, int NT, int DEPTH>
__device__ __forceinline__ void product_nk(float (&x)[NT][4], const float* a, const float* b,
                                           int g, int t) {
#pragma unroll 2
  for (int k0 = 0; k0 < DEPTH / 8; k0 += 2) {
    float part[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.f;
#pragma unroll
    for (int kk = k0; kk < k0 + 2; ++kk) {
      const Frag<4> fa = load_a<P>(a + 8 * kk, g, t);
#pragma unroll
      for (int n = 0; n < NT; ++n) mma3(part[n], fa, load_b_nk<P>(b + 8 * n * P + 8 * kk, g, t));
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) x[n][r] += part[n][r];
  }
}

// acc (16 x 8 ON) += X B over X's 8 NT columns: X an accumulator-layout
// tile (p or dS), B(k, n) = b[k][n] (the tile's rows as the reduction);
// each 8-column block of acc takes the tile's sum as one partial
template <int P, int NT, int ON>
__device__ __forceinline__ void product_kn(float (&acc)[ON][4], const float (&x)[NT][4],
                                           const float* b, int g, int t) {
  Frag<4> fa[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) fa[j] = a_of_acc(x[j]);
#pragma unroll
  for (int n = 0; n < ON; ++n) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j) mma3(part, fa[j], load_b_kn<P>(b + 8 * j * P + 8 * n, g, t));
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[n][r] += part[r];
  }
}

// x (16 x 8 NT) += A B^T over DEPTH on the CUDA cores (FFMA), in the C
// fragment layout: thread (g, t) sums rows g and g + 8 of `a` (pitch P)
// against rows 8 n + 2 t and 8 n + 2 t + 1 of `b`, four head dims a step
// (16-byte reads: a's rows broadcast to the quad, the four rows of b that
// a quarter warp reads on distinct banks), each sum in order over the head
// dim.  dp (dO v^T) runs here: dp - delta cancels, and the rule it is held
// to (2^-16 of p (|dp| + |delta|)) leaves no room for the 3xTF32 product's
// error, which scales with sum_d |dO_d v_d|
template <int P, int NT, int DEPTH>
__device__ __forceinline__ void product_ffma(float (&x)[NT][4], const float* a, const float* b,
                                             int g, int t) {
#pragma unroll 2
  for (int d = 0; d < DEPTH; d += 4) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + g * P + d);
    const float4 a1 = *reinterpret_cast<const float4*>(a + (g + 8) * P + d);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float4 y = *reinterpret_cast<const float4*>(b + (8 * n + 2 * t + c) * P + d);
        float& lo = x[n][c];
        float& hi = x[n][2 + c];
        lo = fmaf(a0.x, y.x, lo);
        lo = fmaf(a0.y, y.y, lo);
        lo = fmaf(a0.z, y.z, lo);
        lo = fmaf(a0.w, y.w, lo);
        hi = fmaf(a1.x, y.x, hi);
        hi = fmaf(a1.y, y.y, hi);
        hi = fmaf(a1.z, y.z, hi);
        hi = fmaf(a1.w, y.w, hi);
      }
  }
}

// rows [row0, row0 + ROWS) of a (n_rows x DH) f32 matrix with a row stride
// of `stride` floats into shared memory at pitch DH + 4, one 16-byte
// cp.async a chunk; rows past n_rows are zero-filled
template <int ROWS, int DH, int THREADS>
__device__ __forceinline__ void copy_rows(float* dst, const float* src, int row0, int n_rows,
                                          size_t stride) {
  constexpr int CH = DH / 4;
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const bool ok = row0 + r < n_rows;
    cp_async_16(smem_u32(dst + r * (DH + 4) + 4 * c),
                src + (size_t)(ok ? row0 + r : 0) * stride + 4 * c, ok);
  }
}

// ---------------------------------------------------------------- forward

template <int DH>
struct Fwd {
  static constexpr int WC = DH == 256 ? 2 : 1;   // warps sharing a row block by columns
  static constexpr int WARPS = 4 * WC, THREADS = 32 * WARPS;
  static constexpr int BQ = 64, BK = 32, P = DH + 4, NT = BK / 8;
  static constexpr int KD = DH / WC;              // a warp's share of the head dim
  static constexpr int SMEM = (BQ * P + 4 * BK * P + (WC > 1 ? WARPS * NT * 128 : 0)) * 4;
};

// one CTA per (head, batch, 64-row Q tile); warp w owns rows 16 (w % 4) ..
// and columns (w / 4) KD ..
template <int DH>
__global__ void __launch_bounds__(Fwd<DH>::THREADS)
f32_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const int* __restrict__ kv_lo,
               const int* __restrict__ kv_hi, float* __restrict__ out,
               float* __restrict__ lse, int H, int Hkv, int Sq, int Sk, int causal,
               float scale) {
  using C = Fwd<DH>;
  constexpr int P = C::P, BQ = C::BQ, BK = C::BK, NT = C::NT, KD = C::KD, ON = KD / 8;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                    // (BQ, P)
  float* sKV = sQ + BQ * P;            // stage s: K (BK, P) at 2 s BK P, V after it
  float* sX = sKV + 4 * BK * P;        // dh 256: each warp's share of the logits

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // longest causal tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp % 4, wc = warp / 4;
  const int hk = h / (H / Hkv);
  const int lo = kv_lo ? max(kv_lo[b], 0) : 0;
  const int hi = kv_hi ? min(kv_hi[b], Sk) : Sk;
  const int kv_begin = (lo / BK) * BK;
  const int kv_end = causal ? min(hi, q0 + BQ) : hi;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BK - 1) / BK : 0;

  const size_t q_stride = (size_t)H * DH, kv_stride = (size_t)Hkv * DH;
  const float* kb = k + ((size_t)b * Sk * Hkv + hk) * DH;
  const float* vb = v + ((size_t)b * Sk * Hkv + hk) * DH;
  copy_rows<BQ, DH, C::THREADS>(sQ, q + ((size_t)b * Sq * H + h) * DH, q0, Sq, q_stride);
  if (n_tiles) {
    copy_rows<BK, DH, C::THREADS>(sKV, kb, kv_begin, Sk, kv_stride);
    copy_rows<BK, DH, C::THREADS>(sKV + BK * P, vb, kv_begin, Sk, kv_stride);
  }
  cp_async_commit();

  const int row_a = q0 + 16 * wr + g;   // this thread's rows: row_a, row_a + 8
  float o[ON][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < ON; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int kv0 = kv_begin + it * BK;
    cp_async_wait<0>();
    __syncthreads();   // tile it has landed; every warp is done with tile it - 1
    if (it + 1 < n_tiles) {
      float* nxt = sKV + ((it + 1) & 1) * 2 * BK * P;
      copy_rows<BK, DH, C::THREADS>(nxt, kb, kv0 + BK, Sk, kv_stride);
      copy_rows<BK, DH, C::THREADS>(nxt + BK * P, vb, kv0 + BK, Sk, kv_stride);
    }
    cp_async_commit();
    const float* sK = sKV + (it & 1) * 2 * BK * P;
    const float* sV = sK + BK * P;

    // s = q k^T over this warp's share of the head dim
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    product_nk<P, NT, KD>(s, sQ + 16 * wr * P + wc * KD, sK + wc * KD, g, t);
    if constexpr (C::WC == 2) {
      // the two shares meet: both warps hold lo + hi (IEEE addition commutes)
      float* mine = sX + warp * NT * 128;
      const float* other = sX + (warp ^ 4) * NT * 128;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) mine[(4 * n + r) * 32 + lane] = s[n][r];
      named_barrier_sync(1 + wr, 64);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) s[n][r] += other[(4 * n + r) * 32 + lane];
    }

    // online softmax over rows row_a (r < 2) and row_a + 8 (r >= 2)
    uint32_t live_bits = 0;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = row_a + 8 * (r >> 1), col = kv0 + 8 * n + 2 * t + (r & 1);
        const bool live = col >= lo && col < hi && (!causal || row >= col);
        live_bits |= (uint32_t)live << (4 * n + r);
        s[n][r] = live ? s[n][r] * scale : NEG_INF;
        mx[r >> 1] = fmaxf(mx[r >> 1], s[n][r]);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        // selected, never exp of a mask
        s[n][r] = (live_bits >> (4 * n + r)) & 1u ? expf(s[n][r] - mx[r >> 1]) : 0.f;
        l[r >> 1] += s[n][r];
      }
#pragma unroll
    for (int n = 0; n < ON; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) o[n][r] *= alpha[r >> 1];

    // o += p v over this warp's columns
    product_kn<P, NT, ON>(o, s, sV + wc * KD, g, t);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = row_a + 8 * i;
    if (row >= Sq) continue;
    const float ls = l[i] == 0.f ? 1.f : l[i];
    float* orow = out + (((size_t)b * Sq + row) * H + h) * DH + wc * KD + 2 * t;
#pragma unroll
    for (int n = 0; n < ON; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n) = make_float2(o[n][2 * i] / ls, o[n][2 * i + 1] / ls);
    if (t == 0 && wc == 0)
      lse[((size_t)b * H + h) * Sq + row] = (m[i] > NEG_INF / 2 ? m[i] : NEG_INF) + logf(ls);
  }
}

// delta = sum_d dO * O (minus the lse cotangent when given): one warp per
// (b, i, h) row of the (B, Sq, H, DH) tensors
template <int DH>
__global__ void __launch_bounds__(256)
f32_delta_kernel(const float* __restrict__ dout, const float* __restrict__ out,
                 const float* __restrict__ g_lse, float* __restrict__ delta, int H, int Sq,
                 long rows) {
  const long row = (long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < DH / 32; ++e)
    s = fmaf(dout[row * DH + lane + 32 * e], out[row * DH + lane + 32 * e], s);
  s = warp_sum(s);
  if (lane == 0) {
    const int h = (int)(row % H);
    const long bi = row / H;
    const int i = (int)(bi % Sq);
    const long b = bi / Sq;
    const long idx = (b * H + h) * Sq + i;
    delta[idx] = g_lse ? s - g_lse[idx] : s;
  }
}

// -------------------------------------------------------------------- dq

template <int DH>
struct Dq {
  static constexpr int THREADS = 256;
  static constexpr int BQ = 64, BK = DH == 256 ? 16 : 32, P = DH + 4, NT = BK / 8;
  static constexpr int SMEM = (2 * BQ * P + 4 * BK * P + 4 * NT * 128) * 4;
};

// one CTA per (head, batch, 64-row Q tile); warps w and w + 4 own rows
// 16 (w % 4) ..: warp w + 4 computes dp (FFMA) and hands it over, warp w
// computes s and p, forms dS and accumulates dQ += dS K
template <int DH>
__global__ void __launch_bounds__(Dq<DH>::THREADS, 1)
f32_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const int* __restrict__ kv_lo, const int* __restrict__ kv_hi,
              float* __restrict__ dq, int H, int Hkv, int Sq, int Sk, int causal,
              float scale) {
  using C = Dq<DH>;
  constexpr int P = C::P, BQ = C::BQ, BK = C::BK, NT = C::NT, ON = DH / 8;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                  // (BQ, P)
  float* sdO = sQ + BQ * P;          // (BQ, P)
  float* sKV = sdO + BQ * P;         // stage s: K (BK, P) at 2 s BK P, V after it
  float* sX = sKV + 4 * BK * P;      // dp of each row block

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp % 4, role = warp / 4;
  const int hk = h / (H / Hkv);
  const int lo = kv_lo ? max(kv_lo[b], 0) : 0;
  const int hi = kv_hi ? min(kv_hi[b], Sk) : Sk;
  const int kv_begin = (lo / BK) * BK;
  const int kv_end = causal ? min(hi, q0 + BQ) : hi;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BK - 1) / BK : 0;

  const size_t q_stride = (size_t)H * DH, kv_stride = (size_t)Hkv * DH;
  const size_t q_off = ((size_t)b * Sq * H + h) * DH;
  const float* kb = k + ((size_t)b * Sk * Hkv + hk) * DH;
  const float* vb = v + ((size_t)b * Sk * Hkv + hk) * DH;
  copy_rows<BQ, DH, C::THREADS>(sQ, q + q_off, q0, Sq, q_stride);
  copy_rows<BQ, DH, C::THREADS>(sdO, dout + q_off, q0, Sq, q_stride);
  if (n_tiles) {
    copy_rows<BK, DH, C::THREADS>(sKV, kb, kv_begin, Sk, kv_stride);
    copy_rows<BK, DH, C::THREADS>(sKV + BK * P, vb, kv_begin, Sk, kv_stride);
  }
  cp_async_commit();

  const int row_a = q0 + 16 * wr + g;
  float lse_r[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + 8 * i;
    const size_t idx = ((size_t)b * H + h) * Sq + row;
    lse_r[i] = row < Sq ? lse[idx] : 0.f;
    dl[i] = row < Sq ? delta[idx] : 0.f;
  }
  float acc[ON][4];                  // warp w: dQ
#pragma unroll
  for (int n = 0; n < ON; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const float* xa = (role ? sdO : sQ) + 16 * wr * P;
  float* sD = sX + wr * NT * 128;

  for (int it = 0; it < n_tiles; ++it) {
    const int kv0 = kv_begin + it * BK;
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_tiles) {
      float* nxt = sKV + ((it + 1) & 1) * 2 * BK * P;
      copy_rows<BK, DH, C::THREADS>(nxt, kb, kv0 + BK, Sk, kv_stride);
      copy_rows<BK, DH, C::THREADS>(nxt + BK * P, vb, kv0 + BK, Sk, kv_stride);
    }
    cp_async_commit();
    const float* sK = sKV + (it & 1) * 2 * BK * P;

    float x[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) x[n][0] = x[n][1] = x[n][2] = x[n][3] = 0.f;
    if (role) {
      // dp = dO v^T
      product_ffma<P, NT, DH>(x, xa, sK + BK * P, g, t);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) sD[(4 * n + r) * 32 + lane] = x[n][r];
      named_barrier_arrive(1 + wr, 64);   // dp is in shared memory
      continue;
    }
    // s = q k^T, p, then ds = p (dp - delta) scale
    product_nk<P, NT, DH>(x, xa, sK, g, t);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = row_a + 8 * (r >> 1), col = kv0 + 8 * n + 2 * t + (r & 1);
        const bool live = col >= lo && col < hi && (!causal || row >= col);
        x[n][r] = live ? expf(x[n][r] * scale - lse_r[r >> 1]) : 0.f;   // selected
      }
    named_barrier_sync(1 + wr, 64);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        x[n][r] = x[n][r] * (sD[(4 * n + r) * 32 + lane] - dl[r >> 1]) * scale;
    // dQ += dS K
    product_kn<P, NT, ON>(acc, x, sK, g, t);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2 && role == 0; ++i) {
    const int row = row_a + 8 * i;
    if (row >= Sq) continue;
    float* drow = dq + (((size_t)b * Sq + row) * H + h) * DH + 2 * t;
#pragma unroll
    for (int n = 0; n < ON; ++n)
      *reinterpret_cast<float2*>(drow + 8 * n) = make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

// ----------------------------------------------------------------- dk/dv

template <int DH>
struct Dkv {
  static constexpr int THREADS = 256;
  static constexpr int BK = 64, BQ = DH == 64 ? 32 : 16, P = DH + 4, NT = BQ / 8;
  static constexpr int STAGE = 2 * BQ * P + 2 * BQ;   // Q, dO, lse, delta of a query tile
  static constexpr int SMEM = (2 * BK * P + 2 * STAGE + 4 * NT * 128) * 4;
  static constexpr int MIN_CTAS = DH == 256 ? 1 : 2;
};

// one CTA per (64-key tile, kv head, batch); warps w and w + 4 own keys
// kv0 + 16 (w % 4) ..: warp w computes s^T and p^T and accumulates dV +=
// P^T dO, warp w + 4 computes dp^T (FFMA) and, with p^T from warp w,
// dK += dS^T Q;
// the walk covers the group's query heads and their live query tiles
template <int DH>
__global__ void __launch_bounds__(Dkv<DH>::THREADS, Dkv<DH>::MIN_CTAS)
f32_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const int* __restrict__ kv_lo, const int* __restrict__ kv_hi,
               float* __restrict__ dk, float* __restrict__ dv, int H, int Hkv, int Sq, int Sk,
               int causal, float scale) {
  using C = Dkv<DH>;
  constexpr int P = C::P, BK = C::BK, BQ = C::BQ, NT = C::NT, ON = DH / 8;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;                  // (BK, P)
  float* sV = sK + BK * P;           // (BK, P)
  float* sT = sV + BK * P;           // stage s at s STAGE: Q (BQ, P), dO (BQ, P), lse, delta
  float* sX = sT + 2 * C::STAGE;     // p^T of each key block

  const int hk = blockIdx.x, b = blockIdx.y;
  const int kv0 = blockIdx.z * BK;   // causal: the longest walks come first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp % 4, role = warp / 4;
  const int rep = H / Hkv;
  const int lo = kv_lo ? max(kv_lo[b], 0) : 0;
  const int hi = kv_hi ? min(kv_hi[b], Sk) : Sk;
  const bool tile_live = kv0 < hi && kv0 + BK > lo;
  const int q_begin = causal ? (kv0 / BQ) * BQ : 0;
  const int n_qt = tile_live && Sq > q_begin ? (Sq - q_begin + BQ - 1) / BQ : 0;
  const int n_it = rep * n_qt;

  const size_t q_stride = (size_t)H * DH, kv_stride = (size_t)Hkv * DH;
  // iteration it: query head hk rep + it / n_qt, query tile q_begin + (it % n_qt) BQ
  auto load_tile = [&](int it, float* dst) {
    const int hq = hk * rep + it / n_qt, qt = q_begin + (it % n_qt) * BQ;
    const size_t q_off = ((size_t)b * Sq * H + hq) * DH;
    copy_rows<BQ, DH, C::THREADS>(dst, q + q_off, qt, Sq, q_stride);
    copy_rows<BQ, DH, C::THREADS>(dst + BQ * P, dout + q_off, qt, Sq, q_stride);
    if (threadIdx.x < 2 * BQ) {
      const int c = threadIdx.x % BQ;
      const bool ok = qt + c < Sq;
      const size_t idx = ((size_t)b * H + hq) * Sq + (ok ? qt + c : 0);
      cp_async_4(smem_u32(dst + 2 * BQ * P + threadIdx.x),
                 (threadIdx.x < BQ ? lse : delta) + idx, ok);
    }
  };
  if (n_it) {
    copy_rows<BK, DH, C::THREADS>(sK, k + ((size_t)b * Sk * Hkv + hk) * DH, kv0, Sk, kv_stride);
    copy_rows<BK, DH, C::THREADS>(sV, v + ((size_t)b * Sk * Hkv + hk) * DH, kv0, Sk, kv_stride);
    load_tile(0, sT);
  }
  cp_async_commit();

  const int key_a = kv0 + 16 * wr + g;   // this thread's keys: key_a, key_a + 8
  float acc[ON][4];                      // warp w: dV; warp w + 4: dK
#pragma unroll
  for (int n = 0; n < ON; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const float* xa = (role ? sV : sK) + 16 * wr * P;
  float* sP = sX + wr * NT * 128;

  for (int it = 0; it < n_it; ++it) {
    const int qt = q_begin + (it % n_qt) * BQ;
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_it) load_tile(it + 1, sT + ((it + 1) & 1) * C::STAGE);
    cp_async_commit();
    const float* sQt = sT + (it & 1) * C::STAGE;
    const float* sdOt = sQt + BQ * P;
    const float* sL = sdOt + BQ * P;   // lse [BQ], then delta [BQ]

    float x[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) x[n][0] = x[n][1] = x[n][2] = x[n][3] = 0.f;
    if (role == 0) {
      // s^T = k q^T, then p^T
      product_nk<P, NT, DH>(x, xa, sQt, g, t);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int key = key_a + 8 * (r >> 1), c = 8 * n + 2 * t + (r & 1), qq = qt + c;
          const bool live = key >= lo && key < hi && qq < Sq && (!causal || qq >= key);
          x[n][r] = live ? expf(x[n][r] * scale - sL[c]) : 0.f;   // selected
          sP[(4 * n + r) * 32 + lane] = x[n][r];
        }
      named_barrier_arrive(1 + wr, 64);   // p^T is in shared memory
    } else {
      // dp^T = v dO^T, then ds^T with warp w's p^T
      product_ffma<P, NT, DH>(x, xa, sdOt, g, t);
      named_barrier_sync(1 + wr, 64);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int c = 8 * n + 2 * t + (r & 1);
          x[n][r] = sP[(4 * n + r) * 32 + lane] * (x[n][r] - sL[BQ + c]) * scale;   // ds^T
        }
    }
    // warp w: dV += p^T dO; warp w + 4: dK += dS^T Q
    product_kn<P, NT, ON>(acc, x, role ? sQt : sdOt, g, t);
  }
  cp_async_wait<0>();

  float* dst = role ? dk : dv;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key_a + 8 * i;
    if (key >= Sk) continue;
    float* drow = dst + (((size_t)b * Sk + key) * Hkv + hk) * DH + 2 * t;
#pragma unroll
    for (int n = 0; n < ON; ++n)
      *reinterpret_cast<float2*>(drow + 8 * n) = make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

template <typename F>
void set_smem(F* fn, int bytes) {
  cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int DH>
int fwd(const void* q, const void* k, const void* v, const void* lo, const void* hi, void* out,
        void* lse, int B, int H, int Hkv, int Sq, int Sk, int causal, float scale,
        cudaStream_t st) {
  using C = Fwd<DH>;
  set_smem(f32_fwd_kernel<DH>, C::SMEM);
  dim3 grid(H, B, (Sq + C::BQ - 1) / C::BQ);
  f32_fwd_kernel<DH><<<grid, C::THREADS, C::SMEM, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const int*)lo, (const int*)hi,
      (float*)out, (float*)lse, H, Hkv, Sq, Sk, causal, scale);
  return (int)cudaGetLastError();
}

template <int DH>
int delta(const void* dout, const void* out, const void* g_lse, void* d, int B, int H, int Sq,
          cudaStream_t st) {
  const long rows = (long)B * Sq * H;
  f32_delta_kernel<DH><<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      (const float*)dout, (const float*)out, (const float*)g_lse, (float*)d, H, Sq, rows);
  return (int)cudaGetLastError();
}

template <int DH>
int dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
       const void* dl, const void* lo, const void* hi, void* dq_, int B, int H, int Hkv, int Sq,
       int Sk, int causal, float scale, cudaStream_t st) {
  using C = Dq<DH>;
  set_smem(f32_dq_kernel<DH>, C::SMEM);
  dim3 grid(H, B, (Sq + C::BQ - 1) / C::BQ);
  f32_dq_kernel<DH><<<grid, C::THREADS, C::SMEM, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const float*)lse,
      (const float*)dl, (const int*)lo, (const int*)hi, (float*)dq_, H, Hkv, Sq, Sk, causal,
      scale);
  return (int)cudaGetLastError();
}

template <int DH>
int dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
        const void* dl, const void* lo, const void* hi, void* dk, void* dv, int B, int H,
        int Hkv, int Sq, int Sk, int causal, float scale, cudaStream_t st) {
  using C = Dkv<DH>;
  set_smem(f32_dkv_kernel<DH>, C::SMEM);
  dim3 grid(Hkv, B, (Sk + C::BK - 1) / C::BK);
  f32_dkv_kernel<DH><<<grid, C::THREADS, C::SMEM, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const float*)lse,
      (const float*)dl, (const int*)lo, (const int*)hi, (float*)dk, (float*)dv, H, Hkv, Sq, Sk,
      causal, scale);
  return (int)cudaGetLastError();
}

template <typename F>
int resources_of(F* fn, int threads, int smem, int* r) {
  if (smem) set_smem(fn, smem);
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
int resources(int* r) {
  int err = resources_of(f32_fwd_kernel<DH>, Fwd<DH>::THREADS, Fwd<DH>::SMEM, r);
  if (!err) err = resources_of(f32_delta_kernel<DH>, 256, 0, r + 6);
  if (!err) err = resources_of(f32_dq_kernel<DH>, Dq<DH>::THREADS, Dq<DH>::SMEM, r + 12);
  if (!err) err = resources_of(f32_dkv_kernel<DH>, Dkv<DH>::THREADS, Dkv<DH>::SMEM, r + 18);
  return err;
}

}  // namespace

extern "C" {

// The f32 counterparts of flash_fwd_launch, flash_bwd_delta_launch,
// flash_bwd_dq_launch and flash_bwd_dkv_launch, with the same arguments and
// every tensor f32 (DH 64, 128 or 256; another DH returns
// cudaErrorInvalidValue).  Each returns cudaGetLastError().
int flash_f32_fwd_launch(const void* q, const void* k, const void* v, const void* kv_lo,
                         const void* kv_hi, void* out, void* lse, int B, int H, int Hkv,
                         int Sq, int Sk, int DH, int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (DH == 64) return fwd<64>(q, k, v, kv_lo, kv_hi, out, lse, B, H, Hkv, Sq, Sk, causal, scale, st);
  if (DH == 128) return fwd<128>(q, k, v, kv_lo, kv_hi, out, lse, B, H, Hkv, Sq, Sk, causal, scale, st);
  if (DH == 256) return fwd<256>(q, k, v, kv_lo, kv_hi, out, lse, B, H, Hkv, Sq, Sk, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

int flash_f32_bwd_delta_launch(const void* dout, const void* out, const void* g_lse,
                               void* delta_, int B, int H, int Sq, int DH, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (DH == 64) return delta<64>(dout, out, g_lse, delta_, B, H, Sq, st);
  if (DH == 128) return delta<128>(dout, out, g_lse, delta_, B, H, Sq, st);
  if (DH == 256) return delta<256>(dout, out, g_lse, delta_, B, H, Sq, st);
  return (int)cudaErrorInvalidValue;
}

int flash_f32_bwd_dq_launch(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta_, const void* kv_lo,
                            const void* kv_hi, void* dq_, int B, int H, int Hkv, int Sq, int Sk,
                            int DH, int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (DH == 64)
    return dq<64>(q, k, v, dout, lse, delta_, kv_lo, kv_hi, dq_, B, H, Hkv, Sq, Sk, causal, scale, st);
  if (DH == 128)
    return dq<128>(q, k, v, dout, lse, delta_, kv_lo, kv_hi, dq_, B, H, Hkv, Sq, Sk, causal, scale, st);
  if (DH == 256)
    return dq<256>(q, k, v, dout, lse, delta_, kv_lo, kv_hi, dq_, B, H, Hkv, Sq, Sk, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

int flash_f32_bwd_dkv_launch(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta_, const void* kv_lo,
                             const void* kv_hi, void* dk, void* dv, int B, int H, int Hkv,
                             int Sq, int Sk, int DH, int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (DH == 64)
    return dkv<64>(q, k, v, dout, lse, delta_, kv_lo, kv_hi, dk, dv, B, H, Hkv, Sq, Sk, causal, scale, st);
  if (DH == 128)
    return dkv<128>(q, k, v, dout, lse, delta_, kv_lo, kv_hi, dk, dv, B, H, Hkv, Sq, Sk, causal, scale, st);
  if (DH == 256)
    return dkv<256>(q, k, v, dout, lse, delta_, kv_lo, kv_hi, dk, dv, B, H, Hkv, Sq, Sk, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

// The four kernels' resources (forward, delta, dq, dk/dv) at DH 128, then
// at DH 256, then at DH 64, six ints each (as flash_fwd_resources).
// Returns the first CUDA error.
int flash_f32_resources(int* res) {
  int err = resources<128>(res);
  if (!err) err = resources<256>(res + 24);
  return err ? err : resources<64>(res + 48);
}

}  // extern "C"
