// Native data-loader hot path: multithreaded row gather + PRNG shuffle.
//
// The reference's data path is torch DataLoader worker *processes* feeding
// one GPU each; a TPU-VM host instead assembles one big global batch and
// lets jax.device_put scatter it across the mesh. The hot loop is
// gather-rows-by-index into a contiguous batch buffer — pure memcpy
// bandwidth, done here in C++ with the GIL released and a thread pool
// (TPU-VM hosts have ~100 cores; Python fancy-indexing is single-core and
// allocates). Exposed as a tiny C ABI loaded via ctypes (no pybind11 in
// the image). Python keeps the policy (epochs, padding, sharding); C++
// owns only the byte-moving.
//
// Build: g++ -O3 -march=native -shared -fPIC -pthread dataops.cpp -o libmlcdata.so

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Gather n rows of row_bytes each: dst[i] = src[idx[i]], parallel over rows.
void mlc_gather(const unsigned char* src, int64_t row_bytes,
                const int64_t* idx, int64_t n, unsigned char* dst,
                int n_threads) {
  if (n <= 0) return;
  if (n_threads < 1) n_threads = 1;
  // small batches: threading overhead dominates; stay inline
  if (n_threads == 1 || n * row_bytes < (int64_t)1 << 20) {
    for (int64_t i = 0; i < n; ++i)
      memcpy(dst + i * row_bytes, src + idx[i] * row_bytes, (size_t)row_bytes);
    return;
  }
  std::vector<std::thread> pool;
  std::atomic<int64_t> next(0);
  const int64_t chunk = (n + n_threads * 4 - 1) / (n_threads * 4);
  for (int t = 0; t < n_threads; ++t) {
    pool.emplace_back([&]() {
      for (;;) {
        int64_t start = next.fetch_add(chunk);
        if (start >= n) return;
        int64_t end = start + chunk < n ? start + chunk : n;
        for (int64_t i = start; i < end; ++i)
          memcpy(dst + i * row_bytes, src + idx[i] * row_bytes,
                 (size_t)row_bytes);
      }
    });
  }
  for (auto& th : pool) th.join();
}

// splitmix64 — tiny, high-quality seeding PRNG
static inline uint64_t splitmix64(uint64_t& s) {
  uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

// In-place Fisher–Yates over idx[0..n), deterministic in seed.
void mlc_shuffle(int64_t* idx, int64_t n, uint64_t seed) {
  uint64_t s = seed ? seed : 0x106689d45497fdb5ULL;
  for (int64_t i = n - 1; i > 0; --i) {
    uint64_t j = splitmix64(s) % (uint64_t)(i + 1);
    int64_t tmp = idx[i];
    idx[i] = idx[j];
    idx[j] = tmp;
  }
}

// iota fill — completes the index-pipeline C ABI so Python never loops
void mlc_iota(int64_t* idx, int64_t n) {
  for (int64_t i = 0; i < n; ++i) idx[i] = i;
}

}  // extern "C"
