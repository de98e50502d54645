// Hopper's producer/consumer machinery for the warp-specialised kernels
// (the bf16 head-dim-64 flash forward and backward): shared-memory
// mbarriers, TMA tile loads (cp.async.bulk.tensor) and element copies that
// complete on an mbarrier, register rebalancing between warpgroups
// (setmaxnreg), and on the host the tensor maps those loads read.
//
// The pattern.  A producer warp keeps loads in flight into a ring of
// stages; each stage has a "full" mbarrier (one arrival from the producer,
// which also announces the bytes its TMA loads will deliver, plus any
// arrivals of element copies) and an "empty" mbarrier (one arrival from
// each consumer warp that reads the stage).  Stage s of a ring of R serves
// items s, s + R, s + 2R, ...: item t's consumers wait on full[t % R] with
// parity (t / R) & 1 and the producer waits on empty[t % R] with parity
// ((t / R) & 1) ^ 1, which a fresh barrier passes (its phase -1, odd, counts
// as completed).  A consumer warp that skips an item still waits for it and
// arrives, so that arrivals are never counted toward the wrong item.
//
// A persistent kernel (the forward, dq) runs one CTA an SM, which walks
// its share of the work items (`persistent_item`); the rings' counters run
// on across items, so the next item's loads run beside this one's last
// products and stores.
//
// Tiles.  A tensor map over a (B, S, H, 64) bf16 tensor is 4-D, (64, H, S,
// B) innermost first, with boxes of (64, 1, rows, 1) and the 128-byte
// swizzle: a box lands as rows x 128 bytes, 16-byte chunk j of row r at
// chunk j ^ (r % 8), the layout `desc_kmajor` / `desc_mnmajor` read (the
// stage's base 1024-byte aligned).  Rows past S are zero-filled by the
// hardware, and the full barrier still receives the whole box's bytes.
//
// A wait that has not completed after MBAR_TIMEOUT_CYCLES (about ten
// seconds) traps: a phase-parity fault surfaces as a launch error instead
// of a hung card.

#pragma once

#include <cuda.h>   // CUtensorMap and its enums (types only: nothing links libcuda)
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr long long MBAR_TIMEOUT_CYCLES = 1ll << 34;

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// make the barriers' initialisation visible to the async proxy (TMA) and to
// the other threads (after a __syncthreads)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// arrive and announce `bytes` of transactions (the TMA loads to follow)
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// arrive once this thread's earlier cp.async copies have landed (counted
// in the barrier's initial arrivals: .noinc)
__device__ __forceinline__ void mbar_arrive_cp_async(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// wait for the completion of the phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > MBAR_TIMEOUT_CYCLES) __trap();
}

// TMA: the box at (c0, c1, c2, c3) of a 4-D tensor map into shared memory,
// completing `bar`'s announced transactions
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// register rebalancing between warpgroups (every thread of the warpgroup;
// counts are multiples of 8 in [24, 256]).  The CTA's registers are those
// of its launch (launch_regs a thread): what the consumers take, the
// producer must have given up, or setmaxnreg.inc waits for ever
constexpr int launch_regs(int threads) { return 65536 / threads / 8 * 8; }

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// The persistent kernels' schedule: the k-th work item of CTA c of G, in
// rounds of G items dealt out forwards in even rounds and backwards in odd
// ones, so that the CTA that took the longest item of a round (the items
// ordered longest first) takes the shortest of the next
__device__ __forceinline__ int persistent_item(int k, int c, int G) {
  return k * G + ((k & 1) ? G - 1 - c : c);
}

// ---- host: the card's SMs and the tensor maps ---------------------------

// the current device's SMs: a persistent kernel's CTAs
inline int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's entry-point query (null
// where the installed CUDA has none)
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// A (B, S, H, 64) bf16 tensor as a 4-D map (64, H, S, B) with boxes of
// `rows` positions of one head, 128-byte swizzled, rows past S zero-filled.
// Returns false where the encoder refuses it (base or strides not 16-byte
// aligned, or no entry point).
inline bool bf16_head64_map(CUtensorMap* map, const void* base, int B, int S, int H, int rows) {
  EncodeTiledFn encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[4] = {64, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {128, (cuuint64_t)H * 128, (cuuint64_t)S * H * 128};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
