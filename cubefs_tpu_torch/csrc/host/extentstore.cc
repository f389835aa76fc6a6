// Native extent-store runtime: the datanode disk engine.
//
// Role parity: reference datanode/storage (128MiB extents, random writes,
// per-128KiB-block CRC32 header maintained on write — extent_store.go:665
// Write, extent.go CRC header, persistence_crc.go). Reimplemented as C++
// with a C ABI for ctypes:
//   <dir>/extents/e_<id>.data — sparse extent payload
//   <dir>/extents/e_<id>.crc  — uint32 CRC per 128KiB block (+ size hdr)
// A write covering byte range [off, off+len) re-CRCs only the touched
// blocks (read-modify over block boundaries). Reads verify block CRCs
// for fully-covered blocks. Whole-extent CRC = IEEE CRC over the block
// CRC array (matching the reference's crc-of-crcs discipline).
//
// The PyTorch port's copy of cubefs_tpu/runtime/src/extentstore.cc (the
// same extent and CRC files on disk), built with dataserve.cc and
// metaserve.cc into one library by cubefs_tpu_torch/runtime/fsnative.py.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cerrno>
#include <string>
#include <unordered_map>
#include <mutex>
#include <vector>
#include <algorithm>
#include <fcntl.h>
#include <unistd.h>
#include <sys/stat.h>

#include "bufpool.h"

namespace {

constexpr uint64_t kBlockSize = 128 * 1024;  // util.BlockSize parity
constexpr uint64_t kMaxExtent = 128ull << 20;

// CRC32 delegates to the shared native kernel (crc32cpu.cc): CLMUL
// folding at ~13 GB/s with a table fallback, bit-identical with zlib.
extern "C" uint32_t rt_crc32(uint32_t crc, const uint8_t* p, size_t n);

uint32_t crc32_ieee(uint32_t crc, const uint8_t* p, size_t n) {
  return rt_crc32(crc, p, n);
}

struct Extent {
  int data_fd = -1;
  int crc_fd = -1;
  uint64_t size = 0;               // logical size (max written end)
  std::vector<uint32_t> block_crc;  // per-block
  std::mutex mu;
};

struct EStore {
  std::string dir;
  std::unordered_map<uint64_t, Extent*> extents;
  std::mutex mu;
  char err[256] = {0};
};

void es_set_err(EStore* s, const char* msg) {
  snprintf(s->err, 256, "%s (errno=%d %s)", msg, errno,
           errno ? strerror(errno) : "");
}

std::string epath(EStore* s, uint64_t id, const char* ext) {
  char buf[64];
  snprintf(buf, sizeof buf, "/e_%016llx.%s", (unsigned long long)id, ext);
  return s->dir + buf;
}

bool load_extent(EStore* s, uint64_t id, Extent* e, bool create) {
  std::string dp = epath(s, id, "data"), cp = epath(s, id, "crc");
  if (!create && access(dp.c_str(), F_OK) != 0) {
    es_set_err(s, "no such extent");
    return false;
  }
  e->data_fd = ::open(dp.c_str(), O_RDWR | O_CREAT, 0644);
  e->crc_fd = ::open(cp.c_str(), O_RDWR | O_CREAT, 0644);
  if (e->data_fd < 0 || e->crc_fd < 0) {
    es_set_err(s, "open extent files");
    return false;
  }
  uint64_t hdr = 0;
  if (pread(e->crc_fd, &hdr, 8, 0) == 8) e->size = hdr;
  struct stat st;
  fstat(e->data_fd, &st);
  e->size = std::max<uint64_t>(e->size, (uint64_t)st.st_size);
  uint64_t nblocks = (e->size + kBlockSize - 1) / kBlockSize;
  e->block_crc.assign(nblocks, 0);
  if (nblocks)
    pread(e->crc_fd, e->block_crc.data(), nblocks * 4, 8);
  return true;
}

Extent* get_extent(EStore* s, uint64_t id, bool create) {
  std::lock_guard<std::mutex> g(s->mu);
  auto it = s->extents.find(id);
  if (it != s->extents.end()) return it->second;
  Extent* e = new Extent();
  if (!load_extent(s, id, e, create)) {
    delete e;
    return nullptr;
  }
  s->extents[id] = e;
  return e;
}

bool persist_crc(EStore* s, Extent* e) {
  uint64_t hdr = e->size;
  if (pwrite(e->crc_fd, &hdr, 8, 0) != 8) {
    es_set_err(s, "crc hdr write");
    return false;
  }
  if (!e->block_crc.empty() &&
      pwrite(e->crc_fd, e->block_crc.data(), e->block_crc.size() * 4, 8) !=
          (ssize_t)(e->block_crc.size() * 4)) {
    es_set_err(s, "crc table write");
    return false;
  }
  return true;
}

// Recompute CRC of one block from the data file.
bool recrc_block(EStore* s, Extent* e, uint64_t b) {
  uint64_t off = b * kBlockSize;
  uint64_t len = std::min(kBlockSize, e->size - off);
  PoolBuf buf(len);  // pooled scratch: no per-recrc malloc churn
  ssize_t rd = pread(e->data_fd, buf.data, len, (off_t)off);
  if (rd < 0) {
    es_set_err(s, "pread for recrc");
    return false;
  }
  if ((uint64_t)rd < len) {  // sparse tail: treat missing as zeros
    memset(buf.data + rd, 0, len - rd);
  }
  e->block_crc[b] = crc32_ieee(0, buf.data, len);
  return true;
}

}  // namespace

extern "C" {

void* es_open(const char* dir) {
  EStore* s = new EStore();
  s->dir = dir;
  ::mkdir(dir, 0755);
  struct stat st;
  if (stat(dir, &st) != 0 || !S_ISDIR(st.st_mode)) {
    delete s;
    return nullptr;
  }
  return s;
}

void es_close(void* h) {
  EStore* s = (EStore*)h;
  if (!s) return;
  for (auto& kv : s->extents) {
    persist_crc(s, kv.second);
    if (kv.second->data_fd >= 0) ::close(kv.second->data_fd);
    if (kv.second->crc_fd >= 0) ::close(kv.second->crc_fd);
    delete kv.second;
  }
  delete s;
}

const char* es_last_error(void* h) { return ((EStore*)h)->err; }

int es_create(void* h, uint64_t extent_id) {
  EStore* s = (EStore*)h;
  return get_extent(s, extent_id, true) ? 0 : -1;
}

// Random-access write; maintains block CRCs for touched blocks.
int es_write(void* h, uint64_t extent_id, uint64_t off, const uint8_t* buf,
             uint64_t len) {
  EStore* s = (EStore*)h;
  if (off + len > kMaxExtent) {
    es_set_err(s, "write past max extent size");
    return -1;
  }
  Extent* e = get_extent(s, extent_id, true);
  if (!e) return -1;
  std::lock_guard<std::mutex> g(e->mu);
  if (pwrite(e->data_fd, buf, len, (off_t)off) != (ssize_t)len) {
    es_set_err(s, "pwrite");
    return -1;
  }
  uint64_t old_size = e->size;
  e->size = std::max(e->size, off + len);
  uint64_t nblocks = (e->size + kBlockSize - 1) / kBlockSize;
  if (e->block_crc.size() < nblocks) e->block_crc.resize(nblocks, 0);
  uint64_t b0 = off / kBlockSize, b1 = (off + len - 1) / kBlockSize;
  if (e->size > old_size) {
    // growth: sparse holes between the old tail and this write, plus the
    // old tail block itself (its span lengthened), need fresh CRCs
    uint64_t old_tail = old_size ? (old_size - 1) / kBlockSize : 0;
    b0 = std::min(b0, old_tail);
  }
  for (uint64_t b = b0; b <= b1; b++)
    if (!recrc_block(s, e, b)) return -1;
  if (!persist_crc(s, e)) return -1;
  return 0;
}

// Read with CRC verification of all touched blocks.
// Returns bytes read, -2 on crc mismatch, -1 on other errors.
int64_t es_read(void* h, uint64_t extent_id, uint64_t off, uint8_t* buf,
                uint64_t len) {
  EStore* s = (EStore*)h;
  Extent* e = get_extent(s, extent_id, false);
  if (!e) return -1;
  std::lock_guard<std::mutex> g(e->mu);
  if (len == 0 || off >= e->size) return 0;  // len==0 would underflow b1
  len = std::min(len, e->size - off);
  ssize_t rd = pread(e->data_fd, buf, len, (off_t)off);
  if (rd < 0) {
    es_set_err(s, "pread");
    return -1;
  }
  if ((uint64_t)rd < len) memset(buf + rd, 0, len - rd);
  // verify every touched block (read its full span from disk)
  uint64_t b0 = off / kBlockSize, b1 = (off + len - 1) / kBlockSize;
  PoolBuf tmp(kBlockSize);  // pooled: this runs on EVERY verified read
  for (uint64_t b = b0; b <= b1; b++) {
    uint64_t boff = b * kBlockSize;
    uint64_t blen = std::min(kBlockSize, e->size - boff);
    ssize_t r2 = pread(e->data_fd, tmp.data, blen, (off_t)boff);
    if (r2 < 0) {
      es_set_err(s, "pread verify");
      return -1;
    }
    if ((uint64_t)r2 < blen) memset(tmp.data + r2, 0, blen - r2);
    if (crc32_ieee(0, tmp.data, blen) != e->block_crc[b]) {
      es_set_err(s, "block crc mismatch");
      return -2;
    }
  }
  return (int64_t)len;
}

uint64_t es_size(void* h, uint64_t extent_id) {
  EStore* s = (EStore*)h;
  Extent* e = get_extent(s, extent_id, false);
  return e ? e->size : 0;
}

// Copy out the per-block CRC table; returns block count (for scrub /
// replica-diff repair and batched TPU re-verification).
int64_t es_block_crcs(void* h, uint64_t extent_id, uint32_t* out, int64_t cap) {
  EStore* s = (EStore*)h;
  Extent* e = get_extent(s, extent_id, false);
  if (!e) return -1;
  std::lock_guard<std::mutex> g(e->mu);
  int64_t n = std::min<int64_t>(cap, (int64_t)e->block_crc.size());
  memcpy(out, e->block_crc.data(), n * 4);
  return (int64_t)e->block_crc.size();
}

int es_delete(void* h, uint64_t extent_id) {
  EStore* s = (EStore*)h;
  std::lock_guard<std::mutex> g(s->mu);
  auto it = s->extents.find(extent_id);
  if (it != s->extents.end()) {
    ::close(it->second->data_fd);
    ::close(it->second->crc_fd);
    delete it->second;
    s->extents.erase(it);
  }
  std::string dp = epath(s, extent_id, "data"), cp = epath(s, extent_id, "crc");
  if (::unlink(dp.c_str()) != 0 && errno != ENOENT) {
    es_set_err(s, "unlink");
    return -1;
  }
  ::unlink(cp.c_str());
  return 0;
}

int es_sync(void* h, uint64_t extent_id) {
  EStore* s = (EStore*)h;
  Extent* e = get_extent(s, extent_id, false);
  if (!e) return -1;
  std::lock_guard<std::mutex> g(e->mu);
  if (!persist_crc(s, e)) return -1;
  if (fsync(e->data_fd) != 0 || fsync(e->crc_fd) != 0) {
    es_set_err(s, "fsync");
    return -1;
  }
  return 0;
}

}  // extern "C"
