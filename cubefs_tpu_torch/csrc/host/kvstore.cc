// Durable ordered KV store — the RocksDB choke-point analog.
//
// Role parity: blobstore/common/kvstorev2/rocksdb.go and
// raftstore/raftstore_db/store_rocksdb.go — the reference backs every
// shard / control-plane state machine with an ordered persistent KV.
// This is a deliberately small log-structured engine with the same
// contract (ordered iteration, range scans, crash-safe mutations), not
// an LSM port: the working set lives in one std::map (shards are
// range-split long before memory pressure matters) with
//
//   snapshot file  sorted (op,key,value) records, CRC32-framed
//   WAL            mutations since the snapshot, same framing
//
// open() loads snapshot + replays the WAL, truncating at the first
// torn/corrupt record (an unacknowledged tail write). compact() dumps
// the map to snapshot.tmp, fsyncs, renames, truncates the WAL;
// auto-compaction triggers when the WAL outgrows max(1 MiB, the
// snapshot size) so recovery cost stays bounded by live data.
//
// Record framing (WAL and snapshot):
//   u32 crc32(payload) | u32 paylen | payload
//   payload = u8 op (1=put, 2=del) | u32 klen | key | value
//
// All calls are serialized by a per-store mutex; handles are opaque
// pointers across the ctypes boundary (cubefs_tpu_torch/runtime/kvstore.py).
//
// The PyTorch port's copy of cubefs_tpu/runtime/src/kvstore.cc (the same
// WAL and snapshot files on disk), built on its own by that facade.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

uint32_t crc32_of(const uint8_t* data, size_t n) {
  static uint32_t table[256];
  static bool init = false;
  if (!init) {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    init = true;
  }
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; i++) c = table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

void put_u32(std::string& out, uint32_t v) {
  out.push_back(char(v & 0xFF));
  out.push_back(char((v >> 8) & 0xFF));
  out.push_back(char((v >> 16) & 0xFF));
  out.push_back(char((v >> 24) & 0xFF));
}

uint32_t get_u32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 |
         uint32_t(p[3]) << 24;
}

std::string frame(uint8_t op, const std::string& key, const std::string& val) {
  std::string payload;
  payload.push_back(char(op));
  put_u32(payload, uint32_t(key.size()));
  payload += key;
  payload += val;
  std::string rec;
  put_u32(rec, crc32_of(reinterpret_cast<const uint8_t*>(payload.data()),
                        payload.size()));
  put_u32(rec, uint32_t(payload.size()));
  rec += payload;
  return rec;
}

struct Store {
  std::mutex mu;
  std::string dir;
  std::map<std::string, std::string> mem;
  int wal_fd = -1;
  uint64_t wal_bytes = 0;
  uint64_t snap_bytes = 0;

  std::string wal_path() const { return dir + "/kv.wal"; }
  std::string snap_path() const { return dir + "/kv.snap"; }

  // Applies records from `path` into mem; stops cleanly at a torn or
  // corrupt tail (the record was never acknowledged). Returns bytes of
  // the valid prefix.
  uint64_t load_file(const std::string& path) {
    FILE* f = fopen(path.c_str(), "rb");
    if (!f) return 0;
    uint64_t good = 0;
    std::vector<uint8_t> buf;
    for (;;) {
      uint8_t hdr[8];
      if (fread(hdr, 1, 8, f) != 8) break;
      uint32_t crc = get_u32(hdr), n = get_u32(hdr + 4);
      if (n > (1u << 30)) break;  // insane length = corruption
      buf.resize(n);
      if (fread(buf.data(), 1, n, f) != n) break;
      if (crc32_of(buf.data(), n) != crc) break;
      if (n < 5) break;
      uint8_t op = buf[0];
      uint32_t klen = get_u32(buf.data() + 1);
      if (5 + klen > n) break;
      std::string key(reinterpret_cast<char*>(buf.data() + 5), klen);
      if (op == 1) {
        mem[key].assign(reinterpret_cast<char*>(buf.data() + 5 + klen),
                        n - 5 - klen);
      } else if (op == 2) {
        mem.erase(key);
      } else {
        break;
      }
      good += 8 + n;
    }
    fclose(f);
    return good;
  }

  bool open() {
    struct stat st{};
    if (stat(dir.c_str(), &st) != 0 || !S_ISDIR(st.st_mode)) return false;
    if (stat(snap_path().c_str(), &st) == 0) snap_bytes = uint64_t(st.st_size);
    load_file(snap_path());
    uint64_t good = load_file(wal_path());
    // drop any torn tail so new appends start at a valid boundary
    wal_fd = ::open(wal_path().c_str(), O_RDWR | O_CREAT, 0644);
    if (wal_fd < 0) return false;
    if (ftruncate(wal_fd, off_t(good)) != 0) return false;
    if (lseek(wal_fd, 0, SEEK_END) < 0) return false;
    wal_bytes = good;
    return true;
  }

  bool append_wal(const std::string& rec) {
    const char* p = rec.data();
    size_t left = rec.size();
    while (left > 0) {
      ssize_t w = write(wal_fd, p, left);
      if (w <= 0) return false;
      p += w;
      left -= size_t(w);
    }
    if (fdatasync(wal_fd) != 0) return false;
    wal_bytes += rec.size();
    return true;
  }

  bool compact_locked() {
    std::string tmp = snap_path() + ".tmp";
    int fd = ::open(tmp.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
    if (fd < 0) return false;
    uint64_t total = 0;
    for (const auto& [k, v] : mem) {
      std::string rec = frame(1, k, v);
      const char* p = rec.data();
      size_t left = rec.size();
      while (left > 0) {
        ssize_t w = write(fd, p, left);
        if (w <= 0) {
          close(fd);
          unlink(tmp.c_str());
          return false;
        }
        p += w;
        left -= size_t(w);
      }
      total += rec.size();
    }
    if (fdatasync(fd) != 0 || close(fd) != 0) {
      unlink(tmp.c_str());
      return false;
    }
    if (rename(tmp.c_str(), snap_path().c_str()) != 0) return false;
    // WAL contents are now covered by the snapshot
    if (ftruncate(wal_fd, 0) != 0) return false;
    if (lseek(wal_fd, 0, SEEK_SET) < 0) return false;
    wal_bytes = 0;
    snap_bytes = total;
    return true;
  }

  void maybe_autocompact() {
    uint64_t threshold = snap_bytes > (1u << 20) ? snap_bytes : (1u << 20);
    if (wal_bytes > threshold) compact_locked();
  }
};

}  // namespace

extern "C" {

void* kv_open(const char* dir) {
  Store* s = new Store();
  s->dir = dir;
  if (!s->open()) {
    delete s;
    return nullptr;
  }
  return s;
}

void kv_close(void* h) {
  Store* s = static_cast<Store*>(h);
  if (s->wal_fd >= 0) close(s->wal_fd);
  delete s;
}

int kv_put(void* h, const char* key, uint32_t klen, const char* val,
           uint32_t vlen) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  std::string k(key, klen), v(val, vlen);
  if (!s->append_wal(frame(1, k, v))) return -1;
  s->mem[k] = std::move(v);
  s->maybe_autocompact();
  return 0;
}

// -1: not found; 0: deleted
int kv_del(void* h, const char* key, uint32_t klen) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  std::string k(key, klen);
  auto it = s->mem.find(k);
  if (it == s->mem.end()) return -1;
  if (!s->append_wal(frame(2, k, ""))) return -2;
  s->mem.erase(it);
  s->maybe_autocompact();
  return 0;
}

// Returns the value length, copying min(vlen, cap) bytes into out.
// -1: not found. Caller retries with a bigger buffer if vlen > cap.
int64_t kv_get(void* h, const char* key, uint32_t klen, char* out,
               uint32_t cap) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  auto it = s->mem.find(std::string(key, klen));
  if (it == s->mem.end()) return -1;
  uint32_t n = uint32_t(it->second.size());
  memcpy(out, it->second.data(), n < cap ? n : cap);
  return int64_t(n);
}

uint64_t kv_count(void* h) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  return s->mem.size();
}

// Scans [start, end) (empty end = unbounded), at most `max_items`
// records, serialized as (u32 klen | u32 vlen | key | value)* into out.
// Returns bytes written; *n_out = records written; *more_out = 1 if
// items remained (resume with start = last key + '\0'). Items that
// would overflow `cap` also set *more_out.
int64_t kv_scan(void* h, const char* start, uint32_t slen, const char* end,
                uint32_t elen, uint32_t max_items, char* out, uint32_t cap,
                uint32_t* n_out, uint32_t* more_out) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  std::string lo(start, slen), hi(end, elen);
  uint64_t used = 0;
  uint32_t n = 0;
  *more_out = 0;
  for (auto it = s->mem.lower_bound(lo); it != s->mem.end(); ++it) {
    if (!hi.empty() && it->first >= hi) break;
    if (n >= max_items) {
      *more_out = 1;
      break;
    }
    uint64_t need = 8 + it->first.size() + it->second.size();
    if (used + need > cap) {
      *more_out = 1;
      break;
    }
    std::string rec;
    put_u32(rec, uint32_t(it->first.size()));
    put_u32(rec, uint32_t(it->second.size()));
    rec += it->first;
    rec += it->second;
    memcpy(out + used, rec.data(), rec.size());
    used += rec.size();
    n++;
  }
  *n_out = n;
  return int64_t(used);
}

// Median key of [start, end) for range splits. Returns klen (copied up
// to cap) or -1 when the range holds < 2 keys.
int64_t kv_median(void* h, const char* start, uint32_t slen, const char* end,
                  uint32_t elen, char* out, uint32_t cap) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  std::string lo(start, slen), hi(end, elen);
  auto it = s->mem.lower_bound(lo);
  uint64_t n = 0;
  for (auto j = it; j != s->mem.end() && (hi.empty() || j->first < hi); ++j)
    n++;
  if (n < 2) return -1;
  for (uint64_t i = 0; i < n / 2; i++) ++it;
  uint32_t klen = uint32_t(it->first.size());
  memcpy(out, it->first.data(), klen < cap ? klen : cap);
  return int64_t(klen);
}

// Atomically applies a batch of mutations with ONE WAL append + ONE
// fdatasync (range moves during shard splits would otherwise pay a
// sync per key). `data` = sequence of records:
//   u8 op (1=put, 2=del) | u32 klen | u32 vlen | key | value
// Returns the number of records applied, or -1 on malformed input /
// write failure (nothing is applied on failure).
int64_t kv_batch(void* h, const char* data, uint64_t len) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  // parse + frame first: reject malformed input before touching disk
  std::string wal;
  std::vector<std::pair<uint8_t, std::pair<std::string, std::string>>> ops;
  uint64_t off = 0;
  const uint8_t* p = reinterpret_cast<const uint8_t*>(data);
  while (off < len) {
    if (off + 9 > len) return -1;
    uint8_t op = p[off];
    uint32_t klen = get_u32(p + off + 1), vlen = get_u32(p + off + 5);
    off += 9;
    if (off + klen + vlen > len || (op != 1 && op != 2)) return -1;
    std::string key(reinterpret_cast<const char*>(p + off), klen);
    std::string val(reinterpret_cast<const char*>(p + off + klen), vlen);
    off += klen + vlen;
    wal += frame(op, key, val);
    ops.emplace_back(op, std::make_pair(std::move(key), std::move(val)));
  }
  if (!s->append_wal(wal)) return -1;
  for (auto& [op, kvp] : ops) {
    if (op == 1)
      s->mem[kvp.first] = std::move(kvp.second);
    else
      s->mem.erase(kvp.first);
  }
  s->maybe_autocompact();
  return int64_t(ops.size());
}

int kv_compact(void* h) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  return s->compact_locked() ? 0 : -1;
}

int kv_clear(void* h) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  s->mem.clear();
  return s->compact_locked() ? 0 : -1;
}

uint64_t kv_wal_bytes(void* h) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  return s->wal_bytes;
}

uint64_t kv_snap_bytes(void* h) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  return s->snap_bytes;
}

}  // extern "C"
