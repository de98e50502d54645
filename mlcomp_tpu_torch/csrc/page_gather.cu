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
// 8 rows x 6 pages x 512 KB = 24 MB per leaf per layer.
//
// The design: grid (S * MP, chunks of one page).  A CTA reads its page id
// from the table once and copies CHUNK bytes of that page with the widest
// load the byte count and both base pointers allow (16 bytes per thread
// per load for every cache leaf the port has: R is a multiple of 256),
// neighbouring threads on neighbouring addresses.  The chunk axis puts
// enough CTAs in flight to fill the card when S * MP is small; a page
// smaller than a chunk is one CTA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long long CHUNK = 32 * 1024;   // bytes per CTA

template <typename V>
__global__ void __launch_bounds__(THREADS)
gather_kernel(const unsigned char* __restrict__ pages, const int* __restrict__ table,
              unsigned char* __restrict__ out, long long R) {
  const long long sp = blockIdx.x;                       // flat (s, p)
  const long long page = table[sp];
  const long long lo = (long long)blockIdx.y * CHUNK;
  const long long hi = min(lo + CHUNK, R);
  const V* src = reinterpret_cast<const V*>(pages + page * R);
  V* dst = reinterpret_cast<V*>(out + sp * R);
  const long long w = sizeof(V);
  for (long long i = lo / w + threadIdx.x; i < hi / w; i += THREADS) dst[i] = __ldg(src + i);
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
  dim3 grid(n_rows, (unsigned)((R + CHUNK - 1) / CHUNK));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* p = static_cast<const unsigned char*>(pages);
  const int* t = static_cast<const int*>(table);
  unsigned char* o = static_cast<unsigned char*>(out);
  if (align % 16 == 0) {
    gather_kernel<int4><<<grid, THREADS, 0, s>>>(p, t, o, R);
  } else if (align % 8 == 0) {
    gather_kernel<int2><<<grid, THREADS, 0, s>>>(p, t, o, R);
  } else if (align % 4 == 0) {
    gather_kernel<int><<<grid, THREADS, 0, s>>>(p, t, o, R);
  } else if (align % 2 == 0) {
    gather_kernel<short><<<grid, THREADS, 0, s>>>(p, t, o, R);
  } else {
    gather_kernel<unsigned char><<<grid, THREADS, 0, s>>>(p, t, o, R);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
