// Slab buffer pool: size-classed freelists for the runtime's IO scratch
// allocations.
//
// Role parity: blobstore/common/resourcepool + util/bytespool (slab mem
// pools for shard/block buffers) and blobstore/common/tcmalloc
// (tcmalloc_manage.cc: allocator stats + ReleaseFreeMemory as an ops
// surface). The reference links gperftools process-wide; this runtime's
// hot allocations are the store scratch buffers (extent read-verify,
// CRC rebuild, chunk compaction), so a focused pool gives the same
// steady-state behavior — no per-IO malloc/free churn — with an
// inspectable stats/release surface instead of an opaque allocator.
//
// Build: part of libcubefs_rt.so (see runtime/build.py).

#include "bufpool.h"

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

namespace {

constexpr int kMinShift = 12;  // 4 KiB
constexpr int kMaxShift = 23;  // 8 MiB
constexpr int kClasses = kMaxShift - kMinShift + 1;
// per-class cap on cached buffers, sized so the whole pool holds at
// most ~2x the largest class per class (small classes cache more)
constexpr size_t kMaxCachedBytesPerClass = 16 << 20;

struct SizeClass {
  std::mutex mu;
  std::vector<void*> free_list;
  uint64_t hits = 0;
  uint64_t misses = 0;
};

SizeClass g_classes[kClasses];

int class_for(size_t n) {
  if (n == 0 || n > ((size_t)1 << kMaxShift)) return -1;
  int shift = kMinShift;
  while (((size_t)1 << shift) < n) shift++;
  return shift - kMinShift;
}

}  // namespace

extern "C" {

void* bp_alloc(size_t n) {
  int cls = class_for(n);
  if (cls < 0) return malloc(n);  // oversize: system allocator
  SizeClass& sc = g_classes[cls];
  {
    std::lock_guard<std::mutex> g(sc.mu);
    if (!sc.free_list.empty()) {
      void* p = sc.free_list.back();
      sc.free_list.pop_back();
      sc.hits++;
      return p;
    }
    sc.misses++;
  }
  return malloc((size_t)1 << (cls + kMinShift));
}

void bp_free(void* p, size_t n) {
  if (p == nullptr) return;
  int cls = class_for(n);
  if (cls < 0) {
    free(p);
    return;
  }
  size_t buf_bytes = (size_t)1 << (cls + kMinShift);
  SizeClass& sc = g_classes[cls];
  {
    std::lock_guard<std::mutex> g(sc.mu);
    if (sc.free_list.size() * buf_bytes < kMaxCachedBytesPerClass) {
      sc.free_list.push_back(p);
      return;
    }
  }
  free(p);  // class cache full
}

size_t bp_release_free_memory() {
  size_t released = 0;
  for (int i = 0; i < kClasses; i++) {
    SizeClass& sc = g_classes[i];
    std::vector<void*> drop;
    {
      std::lock_guard<std::mutex> g(sc.mu);
      drop.swap(sc.free_list);
    }
    for (void* p : drop) free(p);
    released += drop.size() * ((size_t)1 << (i + kMinShift));
  }
  return released;
}

size_t bp_stats_json(char* out, size_t cap) {
  if (out == nullptr || cap == 0) return 0;
  std::string s = "{\"classes\": [";
  size_t held = 0;
  for (int i = 0; i < kClasses; i++) {
    SizeClass& sc = g_classes[i];
    size_t cached;
    uint64_t hits, misses;
    {
      std::lock_guard<std::mutex> g(sc.mu);
      cached = sc.free_list.size();
      hits = sc.hits;
      misses = sc.misses;
    }
    size_t bytes = (size_t)1 << (i + kMinShift);
    held += cached * bytes;
    char item[128];
    snprintf(item, sizeof item,
             "%s{\"size\": %zu, \"cached\": %zu, \"hits\": %llu, "
             "\"misses\": %llu}",
             i ? ", " : "", bytes, cached, (unsigned long long)hits,
             (unsigned long long)misses);
    s += item;
  }
  char tail[48];
  snprintf(tail, sizeof tail, "], \"held_bytes\": %zu}", held);
  s += tail;
  size_t n = s.size() < cap - 1 ? s.size() : cap - 1;
  memcpy(out, s.data(), n);
  out[n] = 0;
  return n;
}

}  // extern "C"
