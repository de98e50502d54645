// Hopper building blocks shared by the flash-attention kernels
// (flash_attention.cu, flash_attention_bwd.cu), the int8 matmul
// (quant_matmul.cu) and the int8-KV chunk decode (decode_attention.cu):
// asynchronous copies into 128-byte-swizzled shared-memory tiles, wgmma
// shared-memory descriptors, the exact int8 -> bf16 conversion, the
// warpgroup matrix products and the warp-level mma.sync product, and the
// thread-block-cluster primitives (rank, barrier, distributed shared
// memory) in inline PTX (sm_90a only).
//
// Tile layout.  A (rows x 128) bf16 tile of a head-dim-128 tensor lives in
// shared memory as two column blocks of (rows x 64): block c holds head
// dims 64c..64c+63, one 128-byte line per row.  Inside a line the 16-byte
// chunk j of row r sits at chunk j ^ (r % 8): the 128-byte swizzle that
// wgmma's descriptor mode 1 reads, for a tile whose base is 1024-byte
// aligned (eight lines, one swizzle atom).  The same tile feeds wgmma two
// ways:
// - K-major (the head dim is the reduction, as for Q K^T): start at
//   column block k / 64, plus 32 bytes per 16-column step inside it;
//   stride 1024 bytes between eight-row groups.
// - MN-major (the rows are the reduction, as for P V): the transpose bit;
//   start 2048 bytes (16 rows) further per 16-row step; leading offset the
//   column-block stride (rows x 128 bytes), stride 1024 bytes between
//   eight-row groups.
//
// Register layouts (PTX ISA, wgmma .m64nNk16): thread t of the warpgroup
// (warp w = t / 32, lane l) holds accumulator element x of an N-wide tile at
// row 16 w + l / 4 + 8 ((x / 2) % 2) and column 8 (x / 4) + 2 (l % 4) + x % 2.
// The register A fragment of one 16-deep step k (four 32-bit registers of
// two bf16) covers the same rows and columns 16 k .. 16 k + 15 in the same
// order, so an accumulator converts to an A operand in place:
// a_i = bf16x2(x[8 k + 2 i], x[8 k + 2 i + 1]).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (src must still be a
// readable address)
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// make this thread's generic-proxy shared-memory writes (cp.async, st.shared)
// visible to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier `id` (1-15; 0 is __syncthreads) over `threads` threads
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// arrive at barrier `id` without waiting (the producer side of a
// producer/consumer hand-off; `threads` counts both sides)
__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous products
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle (mode 1): start address,
// leading and stride byte offsets, each >> 4
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lead_bytes,
                                              uint32_t stride_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lead_bytes >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((stride_bytes >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major operand: 16-column step k (0..7) of a (rows x 128) swizzled tile
// (0..15 of a (rows x 256) one: four column blocks)
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int rows, int k) {
  return make_desc(tile + (k >> 2) * rows * 128 + (k & 3) * 32, 16, 1024);
}

// MN-major operand: 16-row step k of a (rows x 128) swizzled tile, all 128
// columns (columns 128..255 of a (rows x 256) tile: the tile's address plus
// two column blocks, 2 x rows x 128 bytes)
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int rows, int k) {
  return make_desc(tile + k * 2048, rows * 128, 1024);
}

// asynchronous copy of rows [row0, row0 + ROWS) of a (n_rows x DH) bf16
// matrix with a row stride of `stride` elements into a swizzled tile of
// DH / 64 column blocks; rows past n_rows are zero-filled.  THREADS
// threads share the copy.
template <int ROWS, int THREADS, int DH = 128>
__device__ __forceinline__ void load_tile(uint32_t tile, const __nv_bfloat16* src, int row0,
                                          int n_rows, size_t stride, int tid) {
  constexpr int CHUNKS = DH / 8;   // 16-byte chunks a row
  static_assert((ROWS * CHUNKS) % THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < ROWS * CHUNKS / THREADS; ++it) {
    const int i = tid + it * THREADS;
    const int r = i / CHUNKS, c = i % CHUNKS;
    const bool valid = row0 + r < n_rows;
    const __nv_bfloat16* g = valid ? src + (size_t)(row0 + r) * stride + c * 8 : src;
    cp_async_16(tile + (c >> 3) * ROWS * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4), g, valid);
  }
}

// 2^x by the special-function unit (ex2.approx: ~2^-22 relative error,
// +0 for very negative x)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two int8 values (bytes `sel` picks from w) -> their exact bf16 pair:
// 0x4140 gives bytes 0 and 1 of w, 0x4342 bytes 2 and 3 (the lower byte in
// the lower half).
// __byte_perm builds the bf16 words 0x43bb (bb the byte): exponent of 128
// with the byte's low 7 bits as mantissa, 128 + (v & 127), and the byte's
// sign bit as the exponent's last bit.  Masking that bit off leaves
// 128 + (v & 127); it picks the offset to take away: 128 (v >= 0) or 256
// (v < 0, where v & 127 = v + 128).  Every step is exact.
__device__ __forceinline__ uint32_t bf16x2_of_int8(uint32_t w, uint32_t sel) {
  const uint32_t s = __byte_perm(w, 0x43434343u, sel);
  const uint32_t mag = s & 0xFF7FFF7Fu;                  // 128 + (v & 127)
  const uint32_t off = (s & 0x00800080u) | 0xC300C300u;  // -128 or -256
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(mag), "r"(0x3F803F80u), "r"(off));
  return d;
}

// D (64 x 64, f32, registers) (+)= A (64 x 16, shared, K-major) . B (64 x 16,
// shared, K-major)^T
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 128, f32, registers) (+)= A (64 x 16, shared, K-major) . B (128 x 16,
// shared, K-major)^T
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// the shared-memory product at N = 64 or 128, picked by the accumulator's
// size
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  wgmma_ss_n64(d, desc_a, desc_b, accumulate);
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  wgmma_ss_n128(d, desc_a, desc_b, accumulate);
}

// D (64 x 64, f32, registers) += A (64 x 16, bf16 pairs in registers, the
// accumulator layout) . B (16 x 64, shared, MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0, uint32_t a1,
                                          uint32_t a2, uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

// D (64 x 128, f32, registers) += A (64 x 16, bf16 pairs in registers, the
// accumulator layout) . B (16 x 128, shared, MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0, uint32_t a1,
                                           uint32_t a2, uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

// D (64 x 64, f32, registers) (+)= A (64 x 16, bf16 pairs in registers, the
// accumulator layout) . B (64 x 16, shared, K-major)^T: the register-A
// product of a row block held in registers against a K-major tile (the
// head dim the reduction, as for Q K^T)
__device__ __forceinline__ void wgmma_rs_n64_kmajor(float (&d)[32], uint32_t a0, uint32_t a1,
                                                  uint32_t a2, uint32_t a3, uint64_t desc_b,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(accumulate));
}

// the register-A product at N = 64 or 128, picked by the accumulator's
// size
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t desc_b) {
  wgmma_rs_n64(d, a0, a1, a2, a3, desc_b);
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t desc_b) {
  wgmma_rs_n128(d, a0, a1, a2, a3, desc_b);
}

// D (16 x 8, f32) += A (16 x 16, bf16) . B (16 x 8, bf16), one warp
// (mma.sync m16n8k16).  Lane l (g = l / 4, c = l % 4) holds a = {A[g][2c..],
// A[g + 8][2c..], A[g][2c + 8..], A[g + 8][2c + 8..]} (two bf16 a register,
// the lower column in the lower half), b = {B[2c..][g], B[2c + 8..][g]} and
// d = {D[g][2c], D[g][2c + 1], D[g + 8][2c], D[g + 8][2c + 1]}.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// this CTA's rank in its cluster, and the cluster's size (1 and 1 outside
// a cluster launch)
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

// every thread of every CTA of the cluster: shared-memory writes before it
// are visible to reads after it, through distributed shared memory too
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// every thread of every CTA of the cluster, ordering nothing: a CTA that
// waits here knows that the others have done what came before (their
// reads of its shared memory, whose values they have used), without
// waiting for its own or their global stores to be performed
__device__ __forceinline__ void cluster_sync_relaxed() {
  asm volatile(
      "barrier.cluster.arrive.relaxed.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// 16 bytes of CTA `rank`'s shared memory at the address that `addr` has in
// this CTA's
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

}  // namespace hopper
