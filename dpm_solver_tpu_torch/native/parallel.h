// A thread map shared by the codec libraries of the host-IO runtime.
#pragma once

#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

namespace dpmio {

// Run fn(i) for i in [0, n) on up to `threads` workers. Returns the number
// of failures (fn returns 0 on success).
inline int parallel_for(int64_t n, int threads, int (*fn)(int64_t, void*), void* ctx) {
  if (threads < 1) threads = 1;
  if (threads > n) threads = static_cast<int>(n);
  std::atomic<int64_t> next(0);
  std::atomic<int> failures(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) return;
      if (fn(i, ctx) != 0) failures.fetch_add(1);
    }
  };
  if (threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return failures.load();
}

}  // namespace dpmio
