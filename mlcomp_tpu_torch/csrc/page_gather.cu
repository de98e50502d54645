// Page gather (B8): pages (P, R bytes) through a (S, MP) int32 table into
// (S, MP, R bytes), for any element type: a byte copy per (s, p).
//
// Replaces the Pallas kernel `_gather_leaf_pallas` (`copy_kernel`,
// mlcomp_tpu/kvpool/layout.py:384, pallas_call :399): the TPU prefetches
// the table as scalars so that each grid step's input block index comes
// from it, and DMA-copies physical page table[s, p] to logical (s, p).
//
// What bounds it on an H100: bytes.  It reads each gathered page once and
// writes it once and computes nothing: S * MP * R bytes each way.  One
// decode step of the bf16-KV 1.2B model gathers K and V for every layer:
// 8 rows x 6 pages x 512 KB = 24 MB per leaf per layer, ~15 us at
// 3.35 TB/s.
//
// The design: a persistent grid of 512-thread CTAs, four an SM (or one per
// unit when there are fewer units), walks the (s, p, 32 KB chunk) units in
// order, so that every SM stays busy to the end.  Per unit a CTA reads its
// page id from the table once; each thread then asks for four 16-byte
// vectors (512 x 16 bytes apart) before it stores any, so that 32 KB an SM
// is in flight, with streaming hints on both sides (the loads bypass L1,
// the stores are marked evict-first: neither side is read again here).
// The widest vector the byte count and both base pointers allow is used:
// 16 bytes for every cache leaf the port has (R a multiple of 256); the
// narrower fallbacks copy with plain loads and stores.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int THREADS = 512;
constexpr int IN_FLIGHT = 4;            // vectors a thread loads before it stores
constexpr long long CHUNK = 32 * 1024;  // bytes per unit
constexpr int CTAS_PER_SM = 4;

template <typename V>
__device__ __forceinline__ V load(const V* p) {
  return __ldg(p);
}

template <>
__device__ __forceinline__ int4 load<int4>(const int4* p) {
  int4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

template <typename V>
__device__ __forceinline__ void store(V* p, const V& v) {
  *p = v;
}

template <>
__device__ __forceinline__ void store<int4>(int4* p, const int4& v) {
  asm volatile("st.global.cs.v4.s32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// units: S * MP rows x chunks of CHUNK bytes, flat in (row, chunk) order
template <typename V>
__global__ void __launch_bounds__(THREADS)
gather_kernel(const unsigned char* __restrict__ pages, const int* __restrict__ table,
              unsigned char* __restrict__ out, long long R, long long units) {
  constexpr long long W = sizeof(V);
  const long long per_row = (R + CHUNK - 1) / CHUNK;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const long long sp = u / per_row;
    const long long lo = (u - sp * per_row) * CHUNK / W;
    const long long hi = min((u - sp * per_row + 1) * CHUNK, R) / W;
    const V* src = reinterpret_cast<const V*>(pages + (long long)__ldg(table + sp) * R);
    V* dst = reinterpret_cast<V*>(out + sp * R);
    for (long long i = lo + threadIdx.x; i < hi; i += (long long)THREADS * IN_FLIGHT) {
      V v[IN_FLIGHT];
#pragma unroll
      for (int k = 0; k < IN_FLIGHT; ++k) {
        const long long j = i + (long long)k * THREADS;
        if (j < hi) v[k] = load(src + j);
      }
#pragma unroll
      for (int k = 0; k < IN_FLIGHT; ++k) {
        const long long j = i + (long long)k * THREADS;
        if (j < hi) store(dst + j, v[k]);
      }
    }
  }
}

// the card's SM count, read once per device
int sm_count() {
  static std::atomic<int> cached[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  int n = cached[dev & 63].load(std::memory_order_relaxed);
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) n = 132;
    cached[dev & 63].store(n, std::memory_order_relaxed);
  }
  return n;
}

template <typename V>
void launch(const unsigned char* p, const int* t, unsigned char* o, long long R, long long units,
            cudaStream_t s) {
  const long long grid = units < (long long)CTAS_PER_SM * sm_count() ? units
                                                                     : CTAS_PER_SM * sm_count();
  gather_kernel<V><<<(unsigned)grid, THREADS, 0, s>>>(p, t, o, R, units);
}

}  // namespace

extern "C" {

// pages: P x R bytes; table (S * MP,) int32 physical page ids; out:
// S * MP x R bytes.  Every table entry must be a page index below P.
// Returns cudaGetLastError().
int page_gather_launch(const void* pages, const void* table, void* out, int n_rows,
                       long long R, void* stream) {
  if (n_rows == 0 || R == 0) return 0;
  const uintptr_t align = reinterpret_cast<uintptr_t>(pages) |
                          reinterpret_cast<uintptr_t>(out) | (uintptr_t)R;
  const long long units = (long long)n_rows * ((R + CHUNK - 1) / CHUNK);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* p = static_cast<const unsigned char*>(pages);
  const int* t = static_cast<const int*>(table);
  unsigned char* o = static_cast<unsigned char*>(out);
  if (align % 16 == 0) {
    launch<int4>(p, t, o, R, units, s);
  } else if (align % 8 == 0) {
    launch<int2>(p, t, o, R, units, s);
  } else if (align % 4 == 0) {
    launch<int>(p, t, o, R, units, s);
  } else if (align % 2 == 0) {
    launch<short>(p, t, o, R, units, s);
  } else {
    launch<unsigned char>(p, t, o, R, units, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
