// int8 weight-only matmul with the dequantize fused into the kernel:
//
//     out[R, N] = bf16( (x[R, D] @ q8[D, N]) * scale[N] )
//
// Replaces the Pallas kernels of mlcomp_tpu/ops/pallas/quant_matmul.py:
// `_kernel` (the plain product) and `_kernel_norm` (an RMSNorm of x folded
// into the prologue), both launched by `quant_matmul`.
//
// What bounds it on an H100: at decode (R <= 64 rows) the int8 weight
// bytes.  Every generated token reads every projection once; x is a few
// KB.  The design of that path, qmm_gemv_tc_kernel: out^T = q8^T . x^T on
// the tensor cores (mma.sync m16n8k16).  The output features fill the
// product's 16-row M and x's rows, padded to 8, 16, 32 or 64, its N, so 64
// rows cost about what 8 do and the only ALU work per weight byte is the
// exact int8 -> bf16 conversion (wgmma.cuh's bf16x2_of_int8, 2.25
// instructions a value).
// - A CTA of eight warps owns 128 output features for a slice of D.  Each
//   warp takes 128, 64 or 32 of them (fewer at more rows, to bound its
//   accumulators) and a share of every 128-deep step.  Features and depth
//   are permuted inside the product (the sum does not care) so that a lane
//   reads its weights as one 16-, 8- or 4-byte word per weight row, two
//   rows make bf16 pairs with one byte permute, and its x operand is 8
//   contiguous bytes.
// - A cp.async ring of three to six stages (as many as leave room for two
//   CTAs an SM) brings each step's raw int8 weights (16 KB, chunks
//   swizzled so that the lanes' reads meet no bank conflict), its raw x
//   rows and, with the norm, its gamma.  All but one stage are asked for
//   at the kernel's start, behind only the norm's first loads of x (L2
//   hits that would otherwise queue behind the stream).
// - With the norm prologue, every CTA sums each row's squares over the
//   full row (16-byte loads) while those copies are in flight, then norms
//   each step's x as it moves from the ring into the bf16 operand buffer:
//   bf16(x * inv_rms * g), the TPU's order.
// - Where the output tiles leave SMs idle (a 2048-wide projection makes 16
//   tiles), the wrapper's gemv_plan splits D over the CTAs of a thread-
//   block cluster (at most 8).  Each CTA leaves its f32 partial tile in
//   shared memory; after a cluster barrier each CTA adds a share of the
//   tile over the cluster's ranks in rank order through distributed shared
//   memory, scales, rounds and writes it.  One launch per call, no partial
//   sums in device memory, no atomics: reruns are bit-equal.
//
// Above 64 rows (admission chunks of 256 rows, prefills of thousands) the
// product is bound by tensor-core operations, and at 256 rows the weight
// bytes come close behind.  That path is a Hopper GEMM whose B operand is
// dequantized in shared memory (wgmma.cuh):
// - a CTA of two warpgroups owns a 128 x 128 output tile for a slice of D;
//   each warpgroup's 64 rows are wgmma's M, and m64n128k16 reads x and the
//   bf16 weight tile, both K-major in 128-byte-swizzled shared memory,
//   into f32 register accumulators;
// - a three-stage cp.async ring brings each 64-deep step's x tile (bf16)
//   and raw int8 weight tile (8 KB, half the bytes of a bf16 weight);
// - all threads turn the raw tile into bf16, transposed to K-major: a
//   byte permute interleaves two weight rows, another puts each value
//   under the exponent of 128, two logic ops split off its sign and one
//   bf16x2 add removes the offset (exact; 2.25 instructions a value).  Two
//   bf16 buffers let step t + 1's conversion run while step t's products
//   are in flight;
// - 128 registers and 105 KB of shared memory a CTA: two CTAs share an
//   SM, so one converts or waits at a barrier while the other's products
//   run;
// - a small planner in the wrapper splits D into slices of whole steps
//   where the output tiles leave SMs idle (256 rows of a 2048-wide
//   projection make 32 tiles), and a second pass (qmm_reduce_kernel)
//   adds the slices in a fixed order: deterministic, no atomics.
// No TMA, producer warp or register rebalancing: all 256 threads copy,
// convert and issue products.  (A producer warpgroup that copied and
// converted for two consumer ones fell behind them; 256-column tiles ran
// their transposed-B products slower, and their K-major ones left the
// conversion nothing to hide behind on a one-CTA SM.)

// Arithmetic matches the TPU kernel: x arrives rounded to bf16, int8 ->
// bf16 is exact and a product of two bf16 values is exact in f32, so the
// only difference is the order of the f32 sums.  The scale multiplies the
// f32 sum once; the result rounds to bf16.  The norm prologue takes each
// row's inverse RMS from its f32 mean of squares over the full row and
// normalises x as bf16(x * inv_rms * g), the TPU's order; the normed rows
// are never written to device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "wgmma.cuh"

namespace {

// cudaFuncSetAttribute(kernel, max dynamic shared memory) once per kernel
// and device, at its first launch: host work that a decode step would
// otherwise pay on every call.  `done` holds one bit per device.
cudaError_t allow_smem_once(const void* kernel, int bytes, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_acq_rel);
  return err;
}

// ---- 64 rows or fewer: tensor-core GEMV tiles, D split inside a cluster --

constexpr int GEMV_THREADS = 256;        // eight warps
constexpr int GEMV_BN = 128;             // output features a CTA
constexpr int GEMV_KS = 128;             // depth of a step
constexpr int GEMV_SMEM_2 = 115712;      // the most a CTA may take for two an SM
constexpr int MAX_GEMV_ROWS = 64;
constexpr int MAX_CLUSTER = 8;           // the portable cluster size
constexpr int RED_STRIDE = GEMV_BN + 4;  // floats a row of the partial tile

// The warps' shares for RT tiles of 8 rows (ROWS = 8 RT padded rows).  A
// warp owns FW features (MT tiles of 16) and KW rows of each step's depth;
// WF warps share the features, WK the depth.  Lane l (g = l / 4, c = l % 4)
// holds the FB = FW / 8 neighbouring features from g * FB on (feature
// g FB + 2m + e is row g + 8e of tile m) at the RL = KW / 4 depths from
// c RL on (depth c RL + 4 kk + j is the product's column 2c + j, or
// 2c + 8 + j - 2 for j >= 2, of k-step kk).  Accumulators: MT x RT x 4.
template <int RT>
struct Gemv {
  static constexpr int ROWS = 8 * RT;
  static constexpr int MT = RT <= 2 ? 8 : 16 / RT;   // 8, 8, 4, 2
  static constexpr int FW = 16 * MT;                 // 128, 128, 64, 32
  static constexpr int FB = FW / 8;                  // 16, 16, 8, 4
  static constexpr int WF = GEMV_BN / FW;            // 1, 1, 2, 4
  static constexpr int WK = 8 / WF;                  // 8, 8, 4, 2
  static constexpr int KW = GEMV_KS / WK;            // 16, 16, 32, 64
  static constexpr int RL = KW / 4;                  // 4, 4, 8, 16
  static constexpr int KK = KW / 16;                 // k-steps a warp a step
};

// Dynamic shared memory: the ring of (raw weights, raw x, the norm's
// gamma) stages, as many as leave room for two CTAs an SM (at least
// three), the step's x operand (bf16, fragment order), the rows' inverse
// RMS, the tile's scales.  After the loop the ring holds the warps'
// partial tiles.
template <typename TX, bool NORM, int RT>
struct GemvSmem {
  static constexpr int Q_STAGE = GEMV_KS * GEMV_BN;
  static constexpr int X_STAGE = 8 * RT * GEMV_KS * (int)sizeof(TX);
  static constexpr int G_STAGE = NORM ? GEMV_KS * 4 : 0;
  static constexpr int STAGE = Q_STAGE + X_STAGE + G_STAGE;
  static constexpr int XS = 8 * RT * GEMV_KS * 2;
  static constexpr int FIXED = XS + MAX_GEMV_ROWS * 4 + GEMV_BN * 4 + 128;
  static constexpr int FIT = (GEMV_SMEM_2 - FIXED) / STAGE;
  static constexpr int STAGES = FIT < 3 ? 3 : FIT > 8 ? 8 : FIT;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int RED = Gemv<RT>::WK * 8 * RT * RED_STRIDE * 4;
  static constexpr int BYTES = RING + FIXED;
  static_assert(RED <= RING, "the partial tiles fit in the ring");
};

__device__ __forceinline__ float sum_squares(uint4 u, __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lo = __uint_as_float(w[i] << 16), hi = __uint_as_float(w[i] & 0xFFFF0000u);
    s = fmaf(lo, lo, s);
    s = fmaf(hi, hi, s);
  }
  return s;
}

__device__ __forceinline__ float sum_squares(uint4 u, float) {
  const float v[4] = {__uint_as_float(u.x), __uint_as_float(u.y), __uint_as_float(u.z),
                      __uint_as_float(u.w)};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) s = fmaf(v[i], v[i], s);
  return s;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(u.x << 16);
  v[1] = __uint_as_float(u.x & 0xFFFF0000u);
  v[2] = __uint_as_float(u.y << 16);
  v[3] = __uint_as_float(u.y & 0xFFFF0000u);
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
}

// FB bytes of shared memory as FB / 4 words
template <int FB>
__device__ __forceinline__ void load_words(const unsigned char* p, uint32_t (&w)[FB / 4]) {
  if constexpr (FB == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
  } else if constexpr (FB == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x, w[1] = u.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

// grid (N / 128, cluster), launched as clusters of (1, cluster, 1); CTA
// rank p sums `steps` steps of 128 from D row p * steps * 128.  x is bf16,
// or f32 for the norm prologue of an f32 model (the norm's input).
template <typename TX, bool NORM, int RT>
__global__ void __launch_bounds__(GEMV_THREADS, 2)
qmm_gemv_tc_kernel(const TX* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ scale, const float* __restrict__ g, float eps,
                   __nv_bfloat16* __restrict__ out, int rows, int D, int N, int steps) {
  using namespace hopper;
  using S = Gemv<RT>;
  using M = GemvSmem<TX, NORM, RT>;
  constexpr int STAGES = M::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(ring + M::RING);
  float* inv = reinterpret_cast<float*>(ring + M::RING + M::XS);
  float* sc_s = inv + MAX_GEMV_ROWS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, cq = lane & 3;
  const int wf = warp % S::WF, wk = warp / S::WF;
  const int n0 = blockIdx.x * GEMV_BN;
  const int rank = (int)cluster_rank(), ranks = (int)cluster_size();
  const int k_begin = rank * steps * GEMV_KS;

  // Step t's copies into stage t % STAGES.  Weight row r (128 bytes) keeps
  // its 16-byte chunk j at j ^ 2 ((r / RL) % 4): the four lanes of a warp
  // that read one feature word at four depths then meet distinct banks.
  // x rows past `rows` are zero-filled.  With the norm, the step's gamma.
  auto load_step = [&](int t) {
    unsigned char* stage = ring + (t % STAGES) * M::STAGE;
    const int k0 = k_begin + t * GEMV_KS;
    const uint32_t qs = smem_u32(stage);
#pragma unroll
    for (int it = 0; it < M::Q_STAGE / 16 / GEMV_THREADS; ++it) {
      const int i = tid + it * GEMV_THREADS;
      const int r = i >> 3, j = i & 7;
      cp_async_16(qs + r * GEMV_BN + ((j ^ (2 * ((r / S::RL) & 3))) << 4),
                  q + (size_t)(k0 + r) * N + n0 + j * 16, true);
    }
    constexpr int XCH = GEMV_KS * (int)sizeof(TX) / 16;   // chunks an x row
    constexpr int XV = 16 / (int)sizeof(TX);              // values a chunk
    const uint32_t xsm = qs + M::Q_STAGE;
    for (int i = tid; i < S::ROWS * XCH; i += GEMV_THREADS) {
      const int r = i / XCH, j = i % XCH;
      const bool valid = r < rows;
      cp_async_16(xsm + i * 16, valid ? x + (size_t)r * D + k0 + j * XV : x, valid);
    }
    if (NORM && tid < GEMV_KS / 4)
      cp_async_16(xsm + M::X_STAGE + tid * 16, g + k0 + tid * 4, true);
  };

  // With the norm, the first eight 16-byte chunks a lane sums (rows w,
  // w + 8, ... of warp w, chunks l, l + 32, ... of lane l) are asked for
  // before the weight stream: they are L2 hits, and behind the stream they
  // would wait for it.
  constexpr int RPW = S::ROWS / 8;           // rows a warp sums
  constexpr int XV = 16 / (int)sizeof(TX);   // values a 16-byte chunk
  constexpr int PRE = 8;                     // loads a lane keeps in flight
  const int chunks = D / XV;
  auto x_chunk = [&](int i, int c) {
    const int r = warp + 8 * i;
    return r < rows && c < chunks
               ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)r * D) + c)
               : make_uint4(0, 0, 0, 0);
  };
  uint4 pre[PRE];
  if (NORM) {
#pragma unroll
    for (int v = 0; v < PRE; ++v) pre[v] = x_chunk(v % RPW, lane + 32 * (v / RPW));
  }
  // the tile's scales (read after the loop, far behind the stream if
  // asked for then), then all but one stage of the ring
  if (tid < GEMV_BN / 4) cp_async_16(smem_u32(sc_s) + tid * 16, scale + n0 + tid * 4, true);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_step(s);
    cp_async_commit();
  }

  if (NORM) {
    // while the stream is in flight: the rest of each row, PRE loads a
    // pass, summed in a fixed order
    float ss[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) ss[i] = 0.f;
#pragma unroll
    for (int v = 0; v < PRE; ++v) ss[v % RPW] += sum_squares(pre[v], TX());
    for (int c0 = 32 * (PRE / RPW); c0 < chunks; c0 += 32 * (PRE / RPW)) {
#pragma unroll
      for (int v = 0; v < PRE; ++v) pre[v] = x_chunk(v % RPW, c0 + lane + 32 * (v / RPW));
#pragma unroll
      for (int v = 0; v < PRE; ++v) ss[v % RPW] += sum_squares(pre[v], TX());
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      float v = ss[i];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      const int r = warp + 8 * i;
      if (lane == 0) inv[r] = r < rows ? 1.0f / sqrtf(v / (float)D + eps) : 0.f;
    }
  }

  // Step t's x into the operand buffer, in fragment order: unit u (four
  // values, 8 bytes) is what lane u % 32 of the warps along the depth
  // wk = u / 32 / KK % WK hands to k-step u / 32 % KK of row tile
  // u / 32 / KK / WK, so that a warp's 32 lanes read 256 contiguous bytes.
  auto stage_x = [&](int t) {
    const unsigned char* st = ring + (t % STAGES) * M::STAGE + M::Q_STAGE;
    const TX* xr = reinterpret_cast<const TX*>(st);
    const float* gs = reinterpret_cast<const float*>(st + M::X_STAGE);
    for (int u = tid; u < S::ROWS * GEMV_KS / 4; u += GEMV_THREADS) {
      const int l = u & 31, rest = u >> 5;
      const int kk = rest % S::KK, wk_u = rest / S::KK % S::WK, rt = rest / (S::KK * S::WK);
      const int r = 8 * rt + (l >> 2);
      const int k = wk_u * S::KW + S::RL * (l & 3) + 4 * kk;
      float v[4];
      load4(xr + r * GEMV_KS + k, v);
      if (NORM) {
        const float4 gg = *reinterpret_cast<const float4*>(gs + k);
        const float iv = inv[r];
        v[0] = v[0] * iv * gg.x;
        v[1] = v[1] * iv * gg.y;
        v[2] = v[2] * iv * gg.z;
        v[3] = v[3] * iv * gg.w;
      }
      *reinterpret_cast<uint2*>(xs + 4 * u) = make_uint2(pack_bf16(v[0], v[1]),
                                                         pack_bf16(v[2], v[3]));
    }
  };

  // this lane's feature word in each weight row of a stage, and its rows
  const int fbyte = wf * S::FW + gq * S::FB;
  const int q_off = (((fbyte >> 4) ^ (2 * cq)) << 4) + (fbyte & 15);
  const int r_lane = wk * S::KW + S::RL * cq;

  float acc[S::MT][RT][4];
#pragma unroll
  for (int m = 0; m < S::MT; ++m)
#pragma unroll
    for (int j = 0; j < RT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  // Step t: the first barrier says stage t has landed for every thread and
  // every warp is done with step t - 1 (its stage and the operand buffer);
  // the copies of step t + STAGES - 1 go into the freed stage; x is staged;
  // the second barrier publishes it.  Then each warp, per k-step, reads its
  // four weight rows, interleaves two rows a byte permute (the bf16 pairs
  // of one feature at depths k, k + 1), converts and multiplies.
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (t + STAGES - 1 < steps) load_step(t + STAGES - 1);
    cp_async_commit();
    stage_x(t);
    __syncthreads();
    const unsigned char* qs = ring + (t % STAGES) * M::STAGE + q_off;
#pragma unroll
    for (int kk = 0; kk < S::KK; ++kk) {
      uint32_t w[4][S::FB / 4];
#pragma unroll
      for (int j = 0; j < 4; ++j) load_words<S::FB>(qs + (r_lane + 4 * kk + j) * GEMV_BN, w[j]);
      uint32_t b[RT][2];
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) {
        const uint2 v = *reinterpret_cast<const uint2*>(
            xs + 4 * ((((rt * S::WK + wk) * S::KK + kk) << 5) + lane));
        b[rt][0] = v.x;
        b[rt][1] = v.y;
      }
#pragma unroll
      for (int i = 0; i < S::FB / 4; ++i) {
        // features 4i, 4i + 1 (tile 2i) and 4i + 2, 4i + 3 (tile 2i + 1)
        const uint32_t lo01 = __byte_perm(w[0][i], w[1][i], 0x5140);
        const uint32_t lo23 = __byte_perm(w[0][i], w[1][i], 0x7362);
        const uint32_t hi01 = __byte_perm(w[2][i], w[3][i], 0x5140);
        const uint32_t hi23 = __byte_perm(w[2][i], w[3][i], 0x7362);
        const uint32_t a0[4] = {bf16x2_of_int8(lo01, 0x4140), bf16x2_of_int8(lo01, 0x4342),
                                bf16x2_of_int8(hi01, 0x4140), bf16x2_of_int8(hi01, 0x4342)};
        const uint32_t a1[4] = {bf16x2_of_int8(lo23, 0x4140), bf16x2_of_int8(lo23, 0x4342),
                                bf16x2_of_int8(hi23, 0x4140), bf16x2_of_int8(hi23, 0x4342)};
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
          mma_16816(acc[2 * i][rt], a0, b[rt]);
          mma_16816(acc[2 * i + 1][rt], a1, b[rt]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // The ring becomes the partial tiles, red[wk][row][feature]: each warp's
  // accumulators (feature g FB + 2m + e, row 8 rt + 2c + h in element
  // 2e + h of tile m), then the warps along the depth added in order.
  float* red = reinterpret_cast<float*>(ring);
  {
    float* mine = red + wk * S::ROWS * RED_STRIDE + wf * S::FW + gq * S::FB;
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* p = mine + (8 * rt + 2 * cq + h) * RED_STRIDE;
#pragma unroll
        for (int i = 0; i < S::FB / 4; ++i)
          *reinterpret_cast<float4*>(p + 4 * i) =
              make_float4(acc[2 * i][rt][h], acc[2 * i][rt][2 + h], acc[2 * i + 1][rt][h],
                          acc[2 * i + 1][rt][2 + h]);
      }
  }
  __syncthreads();
  const int units = rows * (GEMV_BN / 4);
  for (int u = tid; u < units; u += GEMV_THREADS) {
    float* p = red + (u >> 5) * RED_STRIDE + 4 * (u & 31);
    float4 s = *reinterpret_cast<float4*>(p);
#pragma unroll
    for (int w = 1; w < S::WK; ++w) {
      const float4 v = *reinterpret_cast<const float4*>(p + w * S::ROWS * RED_STRIDE);
      s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
    }
    *reinterpret_cast<float4*>(p) = s;
  }

  // The cluster's slices, added in rank order by the CTA whose share of
  // the tile (a contiguous range of its units) holds the element; then
  // scaled, rounded and written.  The second barrier keeps every CTA's
  // shared memory alive until read; a barrier with release semantics
  // there would wait for the global stores before it.
  if (ranks > 1) {
    cluster_sync();
  } else {
    __syncthreads();
  }
  const uint32_t red0 = smem_u32(red);
  const int share = (units + ranks - 1) / ranks;
  const int u_end = min(units, (rank + 1) * share);
  for (int u = rank * share + tid; u < u_end; u += GEMV_THREADS) {
    const int r = u >> 5, c4 = 4 * (u & 31);
    const uint32_t addr = red0 + (uint32_t)(r * RED_STRIDE + c4) * 4;
    float4 v[MAX_CLUSTER];
#pragma unroll
    for (int p = 0; p < MAX_CLUSTER; ++p)
      if (p < ranks) v[p] = ld_cluster_f4(addr, p);
    float4 s = v[0];
#pragma unroll
    for (int p = 1; p < MAX_CLUSTER; ++p)
      if (p < ranks) s.x += v[p].x, s.y += v[p].y, s.z += v[p].z, s.w += v[p].w;
    const float4 sc = *reinterpret_cast<const float4*>(sc_s + c4);
    *reinterpret_cast<uint2*>(out + (size_t)r * N + n0 + c4) =
        make_uint2(pack_bf16(s.x * sc.x, s.y * sc.y), pack_bf16(s.z * sc.z, s.w * sc.w));
  }
  if (ranks > 1) cluster_sync_relaxed();
}

// one launch of the decode kernel for `rows` padded to RT tiles of 8
template <typename TX, bool NORM, int RT>
cudaError_t launch_gemv(const void* x, const int8_t* q, const float* scale, const float* g,
                        float eps, __nv_bfloat16* out, int rows, int D, int N, int cluster,
                        cudaStream_t st) {
  static std::atomic<unsigned long long> ready{0};
  auto kernel = qmm_gemv_tc_kernel<TX, NORM, RT>;
  constexpr int smem = GemvSmem<TX, NORM, RT>::BYTES;
  cudaError_t err = allow_smem_once((const void*)kernel, smem, ready);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N / GEMV_BN, cluster);
  cfg.blockDim = dim3(GEMV_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const TX*>(x), q, scale, g, eps, out,
                            rows, D, N, D / cluster / GEMV_KS);
}

template <typename TX, bool NORM>
cudaError_t launch_gemv_rows(const void* x, const int8_t* q, const float* scale,
                             const float* g, float eps, __nv_bfloat16* out, int rows, int D,
                             int N, int cluster, cudaStream_t st) {
  if (rows <= 8)
    return launch_gemv<TX, NORM, 1>(x, q, scale, g, eps, out, rows, D, N, cluster, st);
  if (rows <= 16)
    return launch_gemv<TX, NORM, 2>(x, q, scale, g, eps, out, rows, D, N, cluster, st);
  if (rows <= 32)
    return launch_gemv<TX, NORM, 4>(x, q, scale, g, eps, out, rows, D, N, cluster, st);
  return launch_gemv<TX, NORM, 8>(x, q, scale, g, eps, out, rows, D, N, cluster, st);
}

__global__ void qmm_reduce_kernel(const float* __restrict__ partial,
                                  const float* __restrict__ scale,
                                  __nv_bfloat16* __restrict__ out,
                                  int splits, int rows, int N) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)rows * N;
  if (idx >= total) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += partial[sp * total + idx];
  out[idx] = __float2bfloat16(s * scale[idx % N]);
}

// ---- more than 64 rows: wgmma tiles, B dequantized in shared memory -----

constexpr int BM = 128, BN = 128, BK = 64;    // output tile; depth of a step
constexpr int GEMM_THREADS = 256;             // two warpgroups of 64 rows
constexpr int STAGES = 3;                     // cp.async ring of (x, raw q8)
constexpr int X_BYTES = BM * BK * 2;          // 16 KB, K-major, swizzled
constexpr int Q_BYTES = BK * BN;              // 8 KB raw int8, N contiguous
constexpr int B_BYTES = BK * BN * 2;          // 16 KB bf16, K-major, swizzled
// the ring, two bf16 weight tiles, alignment: 105 KB, two CTAs an SM
constexpr int GEMM_SMEM = STAGES * (X_BYTES + Q_BYTES) + 2 * B_BYTES + 1024;

// grid (N / 128, ceil(rows / 128), splits); each CTA sums `steps` steps of
// 64 from D row split * steps * 64.  partial == null: out = bf16(acc *
// scale); else the f32 sums go to partial[split] for qmm_reduce_kernel.
__global__ void __launch_bounds__(GEMM_THREADS, 2)
qmm_wgmma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ scale, float* __restrict__ partial,
                 __nv_bfloat16* __restrict__ out, int rows, int D, int N, int steps) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw0 = smem_u32(smem_raw);
  const uint32_t base = (raw0 + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw0);   // the same bytes, generic
  const uint32_t sB = base;                          // two converted tiles
  const uint32_t sX = sB + 2 * B_BYTES;              // STAGES x tiles
  const uint32_t sQ = sX + STAGES * X_BYTES;         // STAGES raw weight tiles

  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * steps * BK;

  // Step t's copies into stage t % STAGES.  A warpgroup copies its own 64
  // rows of x (so it may refill a stage once its own products of that
  // stage are done), chunk c of row r at chunk c ^ (r % 8).  All threads
  // copy the raw weights, whole 128-byte rows per eight lanes; chunk c of
  // weight row r lands at c ^ (r / 8 % 8), so that the conversion's reads
  // below meet no bank conflict.
  auto load_step = [&](int t) {
    const int stage = t % STAGES;
    const int k0 = k_begin + t * BK;
    const uint32_t xs = sX + stage * X_BYTES;
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int i = wt + it * 128;
      const int r = wg * 64 + (i >> 3), c = i & 7;
      const bool valid = m0 + r < rows;
      const __nv_bfloat16* src = valid ? x + (size_t)(m0 + r) * D + k0 + c * 8 : x;
      cp_async_16(xs + r * 128 + ((c ^ (r & 7)) << 4), src, valid);
    }
    const uint32_t qs = sQ + stage * Q_BYTES;
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int i = tid + it * GEMM_THREADS;
      const int r = i >> 3, c = i & 7;
      cp_async_16(qs + r * 128 + ((c ^ ((r >> 3) & 7)) << 4),
                  q + (size_t)(k0 + r) * N + n0 + c * 16, true);
    }
  };

  // Step t's raw weights -> bf16 buffer t % 2, transposed to K-major (the
  // layout of K in the flash kernels: the transposed-B products run slower
  // than K-major ones on the card): weight column n is a 128-byte row, its
  // 8-deep chunk j at j ^ (n % 8).  Lane l of warp w converts rows
  // 8 (l % 8) .. + 7 of the four columns from n = 16 w + 4 (l / 8):
  // thirty-two lanes read distinct banks, and each eight store eight
  // distinct chunks of one column.  A byte permute interleaves rows k and
  // k + 1 (two columns a word), then each pair converts exactly
  // (wgmma.cuh's bf16x2_of_int8).
  const int cj = lane & 7;
  const int cn = (wg * 4 + warp) * 16 + (lane >> 3) * 4;
  auto convert_step = [&](int t) {
    const unsigned char* qs = gbase + (sQ - base) + (t % STAGES) * Q_BYTES;
    unsigned char* bs = gbase + (t & 1) * B_BYTES;
    uint32_t w[8];
#pragma unroll
    for (int m = 0; m < 8; ++m)
      w[m] = *reinterpret_cast<const uint32_t*>(qs + (8 * cj + m) * 128 +
                                                (((cn >> 4) ^ cj) << 4) + (cn & 15));
    uint32_t o[4][4];   // [column][pair of rows]
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const uint32_t ta = __byte_perm(w[2 * p], w[2 * p + 1], 0x5140);   // columns 0, 1
      const uint32_t tb = __byte_perm(w[2 * p], w[2 * p + 1], 0x7362);   // columns 2, 3
      o[0][p] = bf16x2_of_int8(ta, 0x4140);
      o[1][p] = bf16x2_of_int8(ta, 0x4342);
      o[2][p] = bf16x2_of_int8(tb, 0x4140);
      o[3][p] = bf16x2_of_int8(tb, 0x4342);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = cn + i;
      *reinterpret_cast<uint4*>(bs + n * 128 + ((cj ^ (n & 7)) << 4)) =
          make_uint4(o[i][0], o[i][1], o[i][2], o[i][3]);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_step(s);
    cp_async_commit();
  }

  // Step t: this thread's copies of step t have landed.  The first barrier
  // publishes every thread's copies and says both warpgroups have retired
  // step t - 2's products, the last readers of bf16 buffer t % 2; the
  // threads convert into it.  The second publishes the buffer; the
  // products issue; waiting for all but the newest group retires step
  // t - 1's, which frees this warpgroup's x rows of stage
  // (t - 1) % STAGES (its raw weights were converted before the second
  // barrier of step t - 1) for the copies of step t + STAGES - 1.  The
  // conversion of step t + 1 runs while step t's products are in flight,
  // and the SM's other CTA fills the barriers' gaps.
  float acc[64];
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    convert_step(t);
    fence_proxy_async();
    __syncthreads();
    const uint32_t xa = sX + (t % STAGES) * X_BYTES + wg * 64 * 128;
    const uint32_t bb = sB + (t & 1) * B_BYTES;
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_ss_n128(acc, desc_kmajor(xa, 64, kk), desc_kmajor(bb, BN, kk), t > 0 || kk > 0);
    wgmma_commit();
    fence_operands(acc);
    wgmma_wait<1>();
    fence_operands(acc);
    if (t + STAGES - 1 < steps) load_step(t + STAGES - 1);
    cp_async_commit();
  }
  wgmma_wait<0>();
  fence_operands(acc);

  // accumulator element 4j + 2h + e: row 16 warp + lane / 4 + 8h, column
  // 8j + 2 (lane % 4) + e of this warpgroup's 64 x 128 tile
  const int row0 = m0 + wg * 64 + warp * 16 + (lane >> 2);
  const int col0 = n0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = col0 + 8 * j;
    const float2 sc = partial ? make_float2(1.f, 1.f)
                              : *reinterpret_cast<const float2*>(scale + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= rows) continue;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (partial) {
        *reinterpret_cast<float2*>(partial + ((size_t)blockIdx.z * rows + row) * N + col) =
            make_float2(v0, v1);
      } else {
        *reinterpret_cast<uint32_t*>(out + (size_t)row * N + col) =
            pack_bf16(v0 * sc.x, v1 * sc.y);
      }
    }
  }
}

}  // namespace

extern "C" {

// x (rows, D) bf16 (or f32 when x_f32 != 0, norm prologue only); q (D, N)
// int8; scale (N,) f32; g (D,) f32 or null (null: no norm prologue); out
// (rows, N) bf16.  D % 128 == 0 and N % 128 == 0; D splits into `splits`
// slices of d_chunk rows.  rows <= 64 takes the decode kernel, one launch
// whose slices are the CTAs of one cluster (splits <= 8, d_chunk a
// multiple of 128; `partial` unused).  More rows take the wgmma tiles (no
// norm; d_chunk a multiple of 64), whose slices qmm_reduce_kernel adds
// from `partial` (splits, rows, N) f32 when splits > 1.  Returns the first
// launch error, else cudaGetLastError().
int qmm_launch(const void* x, const void* q, const void* scale, const void* g,
               float eps, void* partial, void* out, int rows, int D, int N,
               int splits, int d_chunk, int x_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* qb = static_cast<const int8_t*>(q);
  const float* sc = static_cast<const float*>(scale);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
  if (rows <= MAX_GEMV_ROWS) {
    if (splits < 1 || splits > MAX_CLUSTER || d_chunk * splits != D || d_chunk % GEMV_KS)
      return (int)cudaErrorInvalidValue;
    const float* gf = static_cast<const float*>(g);
    cudaError_t err;
    if (g != nullptr && x_f32) {
      err = launch_gemv_rows<float, true>(x, qb, sc, gf, eps, ob, rows, D, N, splits, st);
    } else if (g != nullptr) {
      err = launch_gemv_rows<__nv_bfloat16, true>(x, qb, sc, gf, eps, ob, rows, D, N, splits,
                                                  st);
    } else {
      err = launch_gemv_rows<__nv_bfloat16, false>(x, qb, sc, nullptr, eps, ob, rows, D, N,
                                                   splits, st);
    }
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
  }
  static std::atomic<unsigned long long> gemm_ready{0};
  const cudaError_t err = allow_smem_once((const void*)qmm_wgmma_kernel, GEMM_SMEM, gemm_ready);
  if (err != cudaSuccess) return (int)err;
  float* pf = splits > 1 ? static_cast<float*>(partial) : nullptr;
  dim3 grid(N / BN, (rows + BM - 1) / BM, splits);
  qmm_wgmma_kernel<<<grid, GEMM_THREADS, GEMM_SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(x), qb, sc, pf, ob, rows, D, N, d_chunk / BK);
  if (splits > 1) {
    const size_t total = (size_t)rows * N;
    const int threads = 256;
    qmm_reduce_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0, st>>>(
        pf, sc, ob, splits, rows, N);
  }
  return (int)cudaGetLastError();
}

// Resources of the tiled path's kernel, the split pass and the decode
// kernel at 8 rows (plain, norm prologue) and at 64 rows (plain, norm
// prologue on f32 x), six ints each: registers per thread, static shared
// bytes, dynamic shared bytes, local (spill) bytes per thread, threads per
// CTA, CTAs per SM.  Returns the first CUDA error.
int qmm_resources(int* res) {
  const void* fns[6] = {(const void*)qmm_wgmma_kernel, (const void*)qmm_reduce_kernel,
                        (const void*)qmm_gemv_tc_kernel<__nv_bfloat16, false, 1>,
                        (const void*)qmm_gemv_tc_kernel<__nv_bfloat16, true, 1>,
                        (const void*)qmm_gemv_tc_kernel<__nv_bfloat16, false, 8>,
                        (const void*)qmm_gemv_tc_kernel<float, true, 8>};
  const int threads[6] = {GEMM_THREADS, 256, GEMV_THREADS, GEMV_THREADS, GEMV_THREADS,
                          GEMV_THREADS};
  const int smem[6] = {GEMM_SMEM, 0, GemvSmem<__nv_bfloat16, false, 1>::BYTES,
                       GemvSmem<__nv_bfloat16, true, 1>::BYTES,
                       GemvSmem<__nv_bfloat16, false, 8>::BYTES, GemvSmem<float, true, 8>::BYTES};
  for (int i = 0; i < 6; ++i) {
    cudaError_t err = cudaSuccess;
    if (smem[i] > 0)
      err = cudaFuncSetAttribute(fns[i], cudaFuncAttributeMaxDynamicSharedMemorySize, smem[i]);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes a;
    err = cudaFuncGetAttributes(&a, fns[i]);
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
