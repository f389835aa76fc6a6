// Native client library: the libcfs-analog C ABI.
//
// Role parity: client/libsdk (cgo libcfs.so with //export cfs_* symbols
// consumed by the Java SDK, libsdk.go:289-840) and the cgo/gRPC sidecar
// boundary named in BASELINE.json. This is a dependency-free C++
// HTTP/1.1 client for the framework's RPC wire shape (POST /method,
// JSON args in X-Rpc-Args, binary body), exposing:
//   cfs_blob_put / cfs_blob_get / cfs_blob_delete  — access gateway
//   cfs_codec_encode / cfs_codec_crc32             — codec sidecar
//   cfs_mount + cfs_open/read/write/lseek/close, cfs_stat_path,
//   cfs_mkdirs, cfs_readdir, cfs_unlink, cfs_rename, cfs_truncate
//     — the POSIX file surface over an FsGateway daemon (the
//       reference embeds the SDK via cgo; this framework's native
//       boundary is a local daemon instead, the bcache pattern)
// so Go/Java/C++ consumers can drive the codec (kernels A and B on the
// card), the blob plane and the file plane without a Python runtime.
//
// The port's copy of cubefs_tpu/runtime/src/native_client.cc: the same
// exports, wire and errno scheme. It stands alone (no extent store, no
// read plane): cubefs_tpu_torch/runtime/nativeclient.py builds it into a
// library of its own, libnativeclient-<hash>.so under _build/.

#include <arpa/inet.h>
#include <fcntl.h>
#include <netdb.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <unistd.h>

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <vector>

namespace {

thread_local std::string g_nc_err;
thread_local std::string g_nc_meta;  // last response's X-Rpc-Resp JSON
thread_local int g_nc_errno = 0;     // POSIX errno of the last failure

void nc_set_err(const std::string& e) { g_nc_err = e; }

// Decode the gateway's errno-on-the-wire scheme (fsgateway._err /
// metanode._rpc_err): HTTP 400+errno for small errnos, except 404 and
// 421 which are reserved transport codes; 499 carries "errno=NN: ..."
// in the error message for large/colliding errnos. Everything else
// (transport failure, 5xx) is EIO.
int status_to_errno(int status) {
  if (status >= 401 && status <= 498 && status != 404 && status != 421)
    return status - 400;
  if (status == 499) {
    size_t p = g_nc_meta.find("errno=");
    if (p != std::string::npos) return atoi(g_nc_meta.c_str() + p + 6);
  }
  return EIO;
}

// negative-errno return for the POSIX surface (libsdk.go returns
// -errno throughout; so do we)
int nc_fail() { return -(g_nc_errno ? g_nc_errno : EIO); }

int dial(const char* host, int port) {
  addrinfo hints{}, *res = nullptr;
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  char portstr[16];
  snprintf(portstr, sizeof portstr, "%d", port);
  if (getaddrinfo(host, portstr, &hints, &res) != 0 || !res) {
    nc_set_err("getaddrinfo failed");
    return -1;
  }
  int fd = socket(res->ai_family, res->ai_socktype, 0);
  if (fd < 0 || connect(fd, res->ai_addr, res->ai_addrlen) != 0) {
    nc_set_err(std::string("connect failed: ") + strerror(errno));
    if (fd >= 0) close(fd);
    freeaddrinfo(res);
    return -1;
  }
  freeaddrinfo(res);
  return fd;
}

bool send_all(int fd, const void* buf, size_t n) {
  const char* p = (const char*)buf;
  while (n) {
    ssize_t w = ::send(fd, p, n, 0);
    if (w <= 0) return false;
    p += w;
    n -= w;
  }
  return true;
}

// Minimal HTTP/1.1 exchange. Returns status code, fills resp body+meta.
int http_post(const char* host, int port, const std::string& path,
              const std::string& args_json, const uint8_t* body,
              size_t body_len, std::vector<uint8_t>* resp) {
  g_nc_errno = 0;
  int fd = dial(host, port);
  if (fd < 0) {
    g_nc_errno = EIO;
    return -1;
  }
  // heap-built header: args_json (e.g. a multi-slice location) can be
  // arbitrarily long; a fixed buffer would truncate and over-send
  std::string head = "POST /" + path + " HTTP/1.1\r\nHost: " + host +
                     "\r\nX-Rpc-Args: " + args_json +
                     "\r\nContent-Length: " + std::to_string(body_len) +
                     "\r\nConnection: close\r\n\r\n";
  if (!send_all(fd, head.data(), head.size()) ||
      (body_len && !send_all(fd, body, body_len))) {
    nc_set_err("send failed");
    g_nc_errno = EIO;
    close(fd);
    return -1;
  }
  std::string raw;
  char buf[65536];
  ssize_t r;
  while ((r = recv(fd, buf, sizeof buf, 0)) > 0) raw.append(buf, r);
  close(fd);
  size_t hdr_end = raw.find("\r\n\r\n");
  if (hdr_end == std::string::npos) {
    nc_set_err("malformed http response");
    g_nc_errno = EIO;
    return -1;
  }
  int status = 0;
  sscanf(raw.c_str(), "HTTP/1.1 %d", &status);
  // stash X-Rpc-Resp
  g_nc_meta.clear();
  size_t mp = raw.find("X-Rpc-Resp: ");
  if (mp != std::string::npos && mp < hdr_end) {
    size_t e = raw.find("\r\n", mp);
    g_nc_meta = raw.substr(mp + 12, e - mp - 12);
  }
  if (resp) {
    resp->assign(raw.begin() + hdr_end + 4, raw.end());
  }
  if (status != 200) {
    nc_set_err("http status " + std::to_string(status) + ": " + g_nc_meta);
    g_nc_errno = status_to_errno(status);
  }
  return status;
}

std::string json_escape(const char* s) {
  std::string out;
  for (const char* p = s; *p; ++p) {
    unsigned char c = (unsigned char)*p;
    if (c == '"' || c == '\\') {
      out += '\\';
      out += c;
    } else if (c < 0x20) {
      char buf[8];
      snprintf(buf, sizeof buf, "\\u%04x", c);
      out += buf;
    } else {
      out += c;
    }
  }
  return out;
}

// ---------------- POSIX-surface client state ----------------
struct CfsFile {
  std::string path;
  uint64_t offset = 0;
  bool append = false;
};

struct CfsClient {
  std::string host;
  int port = 0;
  std::mutex mu;
  std::map<int, CfsFile> fds;
  int next_fd = 3;
};

// open(2) flag bits (Linux values, the ABI contract)
constexpr int kO_WRONLY = 01;
constexpr int kO_RDWR = 02;
constexpr int kO_CREAT = 0100;
constexpr int kO_EXCL = 0200;
constexpr int kO_TRUNC = 01000;
constexpr int kO_APPEND = 02000;

int fs_call(CfsClient* c, const std::string& method,
            const std::string& args, const uint8_t* body, size_t body_len,
            std::vector<uint8_t>* resp) {
  return http_post(c->host.c_str(), c->port, method, args, body, body_len,
                   resp);
}

// pull an integer field out of the stashed X-Rpc-Resp JSON meta
bool meta_int(const char* key, long long* out) {
  std::string pat = std::string("\"") + key + "\":";
  size_t p = g_nc_meta.find(pat);
  if (p == std::string::npos) return false;
  *out = atoll(g_nc_meta.c_str() + p + pat.size());
  return true;
}

}  // namespace

extern "C" {

const char* cfs_last_error() { return g_nc_err.c_str(); }
const char* cfs_last_meta() { return g_nc_meta.c_str(); }
// POSIX errno of this thread's last failed call (0 after success); the
// cfs_* POSIX surface also returns it as a negative result, matching
// the reference libsdk's -errno contract (libsdk.go:289-840)
int cfs_last_errno() { return g_nc_errno; }

// ---------------- POSIX file surface (libsdk.go:289-840 analog) ------

void* cfs_mount(const char* host, int port) {
  CfsClient* c = new CfsClient();
  c->host = host;
  c->port = port;
  // probe the gateway so a bad address fails at mount, not first IO
  std::vector<uint8_t> resp;
  if (http_post(host, port, "fs_stat", "{\"path\": \"/\"}", nullptr, 0,
                &resp) != 200) {
    delete c;
    return nullptr;
  }
  return c;
}

void cfs_unmount(void* h) { delete (CfsClient*)h; }

int cfs_open(void* h, const char* path, int flags, int mode) {
  CfsClient* c = (CfsClient*)h;
  std::string p = json_escape(path);
  std::vector<uint8_t> resp;
  int st = fs_call(c, "fs_stat", "{\"path\": \"" + p + "\"}", nullptr, 0,
                   &resp);
  uint64_t size = 0;
  if (st == 200 && resp.size() >= 8) {
    if ((flags & kO_CREAT) && (flags & kO_EXCL)) {
      // atomic create-if-absent contract: the file exists, so fail
      nc_set_err("O_EXCL: file exists");
      g_nc_errno = EEXIST;
      return nc_fail();
    }
    memcpy(&size, resp.data(), 8);
    if (flags & kO_TRUNC) {
      if (fs_call(c, "fs_truncate",
                  "{\"path\": \"" + p + "\", \"size\": 0}", nullptr, 0,
                  nullptr) != 200)
        return nc_fail();
      size = 0;
    }
  } else if (flags & kO_CREAT) {
    char args[4352];
    snprintf(args, sizeof args, "{\"path\": \"%s\", \"mode\": %d}",
             p.c_str(), mode);
    int cst = fs_call(c, "fs_create", args, nullptr, 0, nullptr);
    if (cst == 417 && (flags & kO_EXCL)) {
      // lost the create race while O_EXCL was set: must fail
      g_nc_errno = EEXIST;
      return nc_fail();
    }
    if (cst == 417) {
      // lost the create race (EEXIST): O_CREAT without O_EXCL must open
      // the existing file, honoring O_TRUNC
      if (flags & kO_TRUNC) {
        if (fs_call(c, "fs_truncate",
                    "{\"path\": \"" + p + "\", \"size\": 0}", nullptr,
                    0, nullptr) != 200)
          return nc_fail();
      } else if (fs_call(c, "fs_stat", "{\"path\": \"" + p + "\"}",
                         nullptr, 0, &resp) == 200 && resp.size() >= 8) {
        memcpy(&size, resp.data(), 8);
      }
    } else if (cst != 200) {
      return nc_fail();
    }
  } else {
    return nc_fail();  // -ENOENT; detail in cfs_last_error()
  }
  std::lock_guard<std::mutex> g(c->mu);
  int fd = c->next_fd++;
  CfsFile f;
  f.path = path;
  f.append = (flags & kO_APPEND) != 0;
  f.offset = f.append ? size : 0;
  c->fds[fd] = f;
  return fd;
}

int cfs_close(void* h, int fd) {
  CfsClient* c = (CfsClient*)h;
  std::lock_guard<std::mutex> g(c->mu);
  if (!c->fds.erase(fd)) {
    g_nc_errno = EBADF;
    return nc_fail();
  }
  g_nc_errno = 0;  // success with no HTTP round-trip: clear stale errno
  return 0;
}

int64_t cfs_pread(void* h, int fd, void* buf, uint64_t n, uint64_t off) {
  CfsClient* c = (CfsClient*)h;
  std::string path;
  {
    std::lock_guard<std::mutex> g(c->mu);
    auto it = c->fds.find(fd);
    if (it == c->fds.end()) {
      nc_set_err("bad fd");
      g_nc_errno = EBADF;
      return nc_fail();
    }
    path = it->second.path;
  }
  char args[4352];
  snprintf(args, sizeof args,
           "{\"path\": \"%s\", \"offset\": %llu, \"length\": %llu}",
           json_escape(path.c_str()).c_str(), (unsigned long long)off,
           (unsigned long long)n);
  std::vector<uint8_t> resp;
  if (fs_call(c, "fs_read", args, nullptr, 0, &resp) != 200)
    return nc_fail();
  if (resp.size() > n) {
    nc_set_err("gateway returned more than requested");
    g_nc_errno = EIO;
    return nc_fail();
  }
  memcpy(buf, resp.data(), resp.size());
  return (int64_t)resp.size();
}

int64_t cfs_read(void* h, int fd, void* buf, uint64_t n) {
  CfsClient* c = (CfsClient*)h;
  uint64_t off;
  {
    std::lock_guard<std::mutex> g(c->mu);
    auto it = c->fds.find(fd);
    if (it == c->fds.end()) {
      nc_set_err("bad fd");
      g_nc_errno = EBADF;
      return nc_fail();
    }
    off = it->second.offset;
  }
  int64_t got = cfs_pread(h, fd, buf, n, off);
  if (got > 0) {
    std::lock_guard<std::mutex> g(c->mu);
    auto it = c->fds.find(fd);
    if (it != c->fds.end()) it->second.offset = off + got;
  }
  return got;
}

int64_t cfs_pwrite(void* h, int fd, const void* buf, uint64_t n,
                   uint64_t off) {
  CfsClient* c = (CfsClient*)h;
  std::string path;
  {
    std::lock_guard<std::mutex> g(c->mu);
    auto it = c->fds.find(fd);
    if (it == c->fds.end()) {
      nc_set_err("bad fd");
      g_nc_errno = EBADF;
      return nc_fail();
    }
    path = it->second.path;
  }
  char args[4352];
  snprintf(args, sizeof args, "{\"path\": \"%s\", \"offset\": %llu}",
           json_escape(path.c_str()).c_str(), (unsigned long long)off);
  if (fs_call(c, "fs_write", args, (const uint8_t*)buf, n, nullptr) != 200)
    return nc_fail();
  return (int64_t)n;
}

int64_t cfs_write(void* h, int fd, const void* buf, uint64_t n) {
  CfsClient* c = (CfsClient*)h;
  uint64_t off;
  bool append;
  std::string path;
  {
    std::lock_guard<std::mutex> g(c->mu);
    auto it = c->fds.find(fd);
    if (it == c->fds.end()) {
      nc_set_err("bad fd");
      g_nc_errno = EBADF;
      return nc_fail();
    }
    off = it->second.offset;
    append = it->second.append;
    path = it->second.path;
  }
  if (append) {
    // O_APPEND: every write lands at the CURRENT end of file; a failed
    // size probe must fail the write (a stale cached offset would
    // silently overwrite existing bytes)
    std::vector<uint8_t> resp;
    if (fs_call(c, "fs_stat",
                "{\"path\": \"" + json_escape(path.c_str()) + "\"}",
                nullptr, 0, &resp) != 200 || resp.size() < 8) {
      nc_set_err("O_APPEND size probe failed: " + g_nc_err);
      return nc_fail();
    }
    memcpy(&off, resp.data(), 8);
  }
  int64_t put = cfs_pwrite(h, fd, buf, n, off);
  if (put > 0) {
    std::lock_guard<std::mutex> g(c->mu);
    auto it = c->fds.find(fd);
    if (it != c->fds.end()) it->second.offset = off + put;
  }
  return put;
}

int64_t cfs_lseek(void* h, int fd, int64_t off, int whence) {
  CfsClient* c = (CfsClient*)h;
  uint64_t size = 0;
  std::string path;
  {
    std::lock_guard<std::mutex> g(c->mu);
    auto it = c->fds.find(fd);
    if (it == c->fds.end()) {
      nc_set_err("bad fd");
      g_nc_errno = EBADF;
      return nc_fail();
    }
    path = it->second.path;
  }
  if (whence == 2) {  // SEEK_END
    std::vector<uint8_t> resp;
    if (fs_call(c, "fs_stat",
                "{\"path\": \"" + json_escape(path.c_str()) + "\"}",
                nullptr, 0, &resp) != 200 || resp.size() < 8)
      return nc_fail();
    memcpy(&size, resp.data(), 8);
  }
  std::lock_guard<std::mutex> g(c->mu);
  auto it = c->fds.find(fd);
  if (it == c->fds.end()) {
    g_nc_errno = EBADF;
    return nc_fail();
  }
  int64_t base = whence == 0 ? 0
                 : whence == 1 ? (int64_t)it->second.offset
                               : (int64_t)size;
  int64_t pos = base + off;
  if (pos < 0) {
    nc_set_err("negative seek");
    g_nc_errno = EINVAL;
    return nc_fail();
  }
  it->second.offset = (uint64_t)pos;
  g_nc_errno = 0;  // SEEK_SET/CUR succeed locally: clear stale errno
  return pos;
}

// out: size (u64), mode (u32), type (u32: 0 file / 1 dir / 2 symlink),
// mtime seconds (u64) — the gateway's fixed-layout stat record
int cfs_stat_path(void* h, const char* path, uint64_t* size, uint32_t* mode,
                  uint32_t* type, uint64_t* mtime) {
  CfsClient* c = (CfsClient*)h;
  std::vector<uint8_t> resp;
  if (fs_call(c, "fs_stat",
              "{\"path\": \"" + json_escape(path) + "\"}", nullptr, 0,
              &resp) != 200 || resp.size() < 24)
    return nc_fail();
  if (size) memcpy(size, resp.data(), 8);
  if (mode) memcpy(mode, resp.data() + 8, 4);
  if (type) memcpy(type, resp.data() + 12, 4);
  if (mtime) memcpy(mtime, resp.data() + 16, 8);
  return 0;
}

int cfs_mkdirs(void* h, const char* path) {
  CfsClient* c = (CfsClient*)h;
  std::string acc;
  std::string p(path);
  size_t i = 0;
  while (i < p.size()) {
    size_t j = p.find('/', i + 1);
    if (j == std::string::npos) j = p.size();
    acc = p.substr(0, j);
    if (!acc.empty() && acc != "/") {
      int st = fs_call(c, "fs_mkdir",
                       "{\"path\": \"" + json_escape(acc.c_str()) + "\"}",
                       nullptr, 0, nullptr);
      if (st != 200 && st != 417) return nc_fail();  // 417 = EEXIST: fine
    }
    i = j;
  }
  return 0;
}

// newline-joined names into out; returns entry count or -1
int64_t cfs_readdir(void* h, const char* path, char* out, uint64_t cap) {
  CfsClient* c = (CfsClient*)h;
  std::vector<uint8_t> resp;
  if (fs_call(c, "fs_readdir",
              "{\"path\": \"" + json_escape(path) + "\"}", nullptr, 0,
              &resp) != 200)
    return nc_fail();
  if (resp.size() + 1 > cap) {
    nc_set_err("readdir buffer too small");
    g_nc_errno = ERANGE;
    return nc_fail();
  }
  memcpy(out, resp.data(), resp.size());
  out[resp.size()] = 0;
  long long n = 0;
  meta_int("count", &n);
  return n;
}

int cfs_unlink(void* h, const char* path) {
  CfsClient* c = (CfsClient*)h;
  return fs_call(c, "fs_unlink",
                 "{\"path\": \"" + json_escape(path) + "\"}", nullptr, 0,
                 nullptr) == 200
             ? 0
             : nc_fail();
}

int cfs_rmdir(void* h, const char* path) { return cfs_unlink(h, path); }

int cfs_rename(void* h, const char* oldp, const char* newp) {
  CfsClient* c = (CfsClient*)h;
  return fs_call(c, "fs_rename",
                 "{\"old\": \"" + json_escape(oldp) + "\", \"new\": \"" +
                     json_escape(newp) + "\"}",
                 nullptr, 0, nullptr) == 200
             ? 0
             : nc_fail();
}

int cfs_truncate(void* h, const char* path, uint64_t size) {
  CfsClient* c = (CfsClient*)h;
  char args[4352];
  snprintf(args, sizeof args, "{\"path\": \"%s\", \"size\": %llu}",
           json_escape(path).c_str(), (unsigned long long)size);
  return fs_call(c, "fs_truncate", args, nullptr, 0, nullptr) == 200 ? 0
                                                                      : nc_fail();
}

int cfs_flush(void* h, int fd) {
  (void)h;
  (void)fd;
  g_nc_errno = 0;
  return 0;  // writes are synchronous through the gateway
}

// PUT via access; returns 0 and writes the location JSON into loc_out.
int cfs_blob_put(const char* host, int port, const uint8_t* data,
                 uint64_t len, char* loc_out, uint64_t loc_cap) {
  std::vector<uint8_t> resp;
  int st = http_post(host, port, "put", "{}", data, len, &resp);
  if (st != 200) return -1;
  // location JSON is inside the meta header
  if (g_nc_meta.size() + 1 > loc_cap) {
    nc_set_err("location buffer too small");
    return -1;
  }
  memcpy(loc_out, g_nc_meta.c_str(), g_nc_meta.size() + 1);
  return 0;
}

// GET via access; loc_json = {"location": {...}} args payload.
int64_t cfs_blob_get(const char* host, int port, const char* args_json,
                     uint8_t* out, uint64_t cap) {
  std::vector<uint8_t> resp;
  int st = http_post(host, port, "get", args_json, nullptr, 0, &resp);
  if (st != 200) return -1;
  if (resp.size() > cap) {
    nc_set_err("output buffer too small");
    return -2;
  }
  memcpy(out, resp.data(), resp.size());
  return (int64_t)resp.size();
}

int cfs_blob_delete(const char* host, int port, const char* args_json) {
  int st = http_post(host, port, "delete", args_json, nullptr, 0, nullptr);
  return st == 200 ? 0 : -1;
}

// EC encode offload: data = batch*n shards of shard_size bytes; parity
// (batch*m*shard_size) written to out.
// Shared-memory encode for a CO-LOCATED sidecar (codec/service.py
// rpc_encode_shm): shards land in a /dev/shm file, only shapes ride
// HTTP. Measured 6-8x the body-over-HTTP path, whose framing+copies
// cap the boundary at ~0.4 GiB/s (SURVEY §7 hard part 2).
int cfs_codec_encode_shm(const char* host, int port, int n, int m,
                         uint64_t shard_size, int batch,
                         const uint8_t* data, uint8_t* parity_out) {
  size_t in_bytes = (size_t)batch * n * shard_size;
  size_t out_bytes = (size_t)batch * m * shard_size;
  char path[128];
  snprintf(path, sizeof path, "/dev/shm/cubefs-codec-%d-XXXXXX",
           (int)getpid());
  int fd = mkstemp(path);
  if (fd < 0) {
    nc_set_err("mkstemp /dev/shm failed");
    return -1;
  }
  int rc = -1;
  uint8_t* map = nullptr;
  do {
    if (ftruncate(fd, (off_t)(in_bytes + out_bytes)) != 0) {
      nc_set_err("ftruncate shm failed");
      break;
    }
    map = (uint8_t*)mmap(nullptr, in_bytes + out_bytes,
                         PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
    if (map == MAP_FAILED) {
      map = nullptr;
      nc_set_err("mmap shm failed");
      break;
    }
    memcpy(map, data, in_bytes);
    char args[256];
    snprintf(args, sizeof args,
             "{\"n\": %d, \"m\": %d, \"shard_size\": %llu, \"batch\": %d, "
             "\"shm\": \"%s\"}",
             n, m, (unsigned long long)shard_size, batch, path);
    std::vector<uint8_t> resp;
    int st = http_post(host, port, "encode_shm", args, nullptr, 0, &resp);
    if (st != 200) break;
    memcpy(parity_out, map + in_bytes, out_bytes);
    rc = 0;
  } while (false);
  if (map) munmap(map, in_bytes + out_bytes);
  close(fd);
  unlink(path);
  return rc;
}

int cfs_codec_encode(const char* host, int port, int n, int m,
                     uint64_t shard_size, int batch, const uint8_t* data,
                     uint8_t* parity_out) {
  char args[256];
  snprintf(args, sizeof args,
           "{\"n\": %d, \"m\": %d, \"shard_size\": %llu, \"batch\": %d}",
           n, m, (unsigned long long)shard_size, batch);
  std::vector<uint8_t> resp;
  int st = http_post(host, port, "encode", args, data,
                     (size_t)batch * n * shard_size, &resp);
  if (st != 200) return -1;
  if (resp.size() != (size_t)batch * m * shard_size) {
    nc_set_err("unexpected parity size");
    return -1;
  }
  memcpy(parity_out, resp.data(), resp.size());
  return 0;
}

// Batched CRC32 offload: blocks of block_len; out = count u32le CRCs.
int cfs_codec_crc32(const char* host, int port, uint64_t block_len,
                    const uint8_t* data, uint64_t data_len, uint32_t* out) {
  char args[128];
  snprintf(args, sizeof args, "{\"block_len\": %llu}",
           (unsigned long long)block_len);
  std::vector<uint8_t> resp;
  int st = http_post(host, port, "crc32", args, data, data_len, &resp);
  if (st != 200) return -1;
  // exact-size check: the caller sized `out` for data_len/block_len CRCs
  size_t expect = (size_t)(data_len / block_len) * 4;
  if (resp.size() != expect) {
    nc_set_err("unexpected crc payload size");
    return -1;
  }
  memcpy(out, resp.data(), resp.size());
  return (int)(resp.size() / 4);
}

}  // extern "C"
