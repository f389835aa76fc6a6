// Size-classed slab buffer pool for the native runtime's IO scratch
// paths — the tcmalloc/resourcepool role (see bufpool.cc). C ABI plus a
// RAII helper for in-runtime use.
#pragma once

#include <cstddef>
#include <cstdint>

extern "C" {
// pooled alloc/free: n may be any size; buffers come from power-of-two
// size classes (oversize requests fall through to the system allocator)
void* bp_alloc(size_t n);
void bp_free(void* p, size_t n);
// tcmalloc_manage.cc parity: drop all cached free buffers, returning
// the number of bytes released to the system
size_t bp_release_free_memory();
// JSON stats {classes: [{size, cached, hits, misses}], held_bytes};
// returns bytes written (truncated to cap-1), 0 on bad args
size_t bp_stats_json(char* out, size_t cap);
}

// RAII wrapper for runtime-internal scratch buffers
struct PoolBuf {
  uint8_t* data = nullptr;
  size_t cap = 0;

  explicit PoolBuf(size_t n) : data((uint8_t*)bp_alloc(n)), cap(n) {}
  ~PoolBuf() {
    if (data) bp_free(data, cap);
  }
  PoolBuf(const PoolBuf&) = delete;
  PoolBuf& operator=(const PoolBuf&) = delete;
};
