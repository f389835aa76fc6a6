// Native metanode read plane: the hot-loop half of manager_op.go.
//
// Role parity: metanode/manager_op.go — the reference serves every meta
// op from a Go TCP demux over in-RAM trees (metanode/btree.go). The
// Python op loop tops out ~1-4k ops/s under the GIL; this server owns
// the read-side demux and the inode/dentry trees in C++, serving
// lookup / inode_get / readdir / dentry_count / walk on the same
// 64-byte binary packet protocol (utils/packet.py) with wire-identical
// errno / leader-redirect encodings, entirely off the GIL.
//
// The Python MetaPartition stays the FSM of record: every apply mirrors
// its tree mutation into this store under the partition lock (inodes as
// pre-serialized JSON blobs, dentries as parent -> name -> ino maps),
// and raft role transitions flip the per-partition serving flag
// synchronously — so the native plane serves exactly what a leader-
// routed Python read would, or answers 421 "leader=<addr>".
//
// Writes (submit / alloc_ino) stay on the Python packet/HTTP planes:
// they are raft-bound, so the GIL is not their ceiling.
//
// The PyTorch port's copy of cubefs_tpu/runtime/src/metaserve.cc (the same
// wire), built by cubefs_tpu_torch/runtime/fsnative.py.

#include <arpa/inet.h>

#include "packetwire.h"

#include <algorithm>
#include <array>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <shared_mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// ------------------------------------------------------------- tiny JSON
// Parses the flat-ish args objects the meta SDK sends ({"pid":1,
// "names":["a"],"stat":true}). Full escape handling (incl. \uXXXX
// surrogate pairs -> UTF-8) because Python's json.dumps default is
// ensure_ascii=True, so every non-ASCII filename arrives escaped.
struct JVal {
  enum Kind { NUM, STR, BOOL, NUL, ARR, OBJ } kind = NUL;
  uint64_t num = 0;
  bool b = false;
  std::string str;
  std::vector<JVal> arr;
  std::vector<std::pair<std::string, JVal>> obj;

  const JVal* get(const char* key) const {
    for (auto& kv : obj)
      if (kv.first == key) return &kv.second;
    return nullptr;
  }
};

struct JParser {
  const char* p;
  const char* end;
  bool ok = true;

  explicit JParser(const std::string& s) : p(s.data()), end(s.data() + s.size()) {}

  void ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) p++;
  }
  bool lit(const char* s) {
    size_t n = strlen(s);
    if ((size_t)(end - p) < n || memcmp(p, s, n) != 0) return false;
    p += n;
    return true;
  }

  void utf8_append(std::string& out, uint32_t cp) {
    if (cp < 0x80) {
      out += (char)cp;
    } else if (cp < 0x800) {
      out += (char)(0xC0 | (cp >> 6));
      out += (char)(0x80 | (cp & 0x3F));
    } else if (cp < 0x10000) {
      out += (char)(0xE0 | (cp >> 12));
      out += (char)(0x80 | ((cp >> 6) & 0x3F));
      out += (char)(0x80 | (cp & 0x3F));
    } else {
      out += (char)(0xF0 | (cp >> 18));
      out += (char)(0x80 | ((cp >> 12) & 0x3F));
      out += (char)(0x80 | ((cp >> 6) & 0x3F));
      out += (char)(0x80 | (cp & 0x3F));
    }
  }

  int hex4() {
    if (end - p < 4) return -1;
    int v = 0;
    for (int i = 0; i < 4; i++) {
      char c = *p++;
      v <<= 4;
      if (c >= '0' && c <= '9') v |= c - '0';
      else if (c >= 'a' && c <= 'f') v |= c - 'a' + 10;
      else if (c >= 'A' && c <= 'F') v |= c - 'A' + 10;
      else return -1;
    }
    return v;
  }

  bool str(std::string& out) {
    if (p >= end || *p != '"') return false;
    p++;
    while (p < end && *p != '"') {
      if (*p == '\\') {
        p++;
        if (p >= end) return false;
        char c = *p++;
        switch (c) {
          case '"': out += '"'; break;
          case '\\': out += '\\'; break;
          case '/': out += '/'; break;
          case 'b': out += '\b'; break;
          case 'f': out += '\f'; break;
          case 'n': out += '\n'; break;
          case 'r': out += '\r'; break;
          case 't': out += '\t'; break;
          case 'u': {
            int v = hex4();
            if (v < 0) return false;
            uint32_t cp = (uint32_t)v;
            if (cp >= 0xD800 && cp <= 0xDBFF && end - p >= 6 && p[0] == '\\' &&
                p[1] == 'u') {
              p += 2;
              int lo = hex4();
              if (lo < 0) return false;
              cp = 0x10000 + ((cp - 0xD800) << 10) + ((uint32_t)lo - 0xDC00);
            }
            utf8_append(out, cp);
            break;
          }
          default: return false;
        }
      } else {
        out += *p++;
      }
    }
    if (p >= end) return false;
    p++;  // closing quote
    return true;
  }

  JVal value() {
    JVal v;
    ws();
    if (p >= end) { ok = false; return v; }
    char c = *p;
    if (c == '"') {
      v.kind = JVal::STR;
      if (!str(v.str)) ok = false;
    } else if (c == '{') {
      p++;
      v.kind = JVal::OBJ;
      ws();
      if (p < end && *p == '}') { p++; return v; }
      while (ok) {
        ws();
        std::string key;
        if (!str(key)) { ok = false; break; }
        ws();
        if (p >= end || *p++ != ':') { ok = false; break; }
        v.obj.emplace_back(std::move(key), value());
        ws();
        if (p < end && *p == ',') { p++; continue; }
        if (p < end && *p == '}') { p++; break; }
        ok = false;
      }
    } else if (c == '[') {
      p++;
      v.kind = JVal::ARR;
      ws();
      if (p < end && *p == ']') { p++; return v; }
      while (ok) {
        v.arr.push_back(value());
        ws();
        if (p < end && *p == ',') { p++; continue; }
        if (p < end && *p == ']') { p++; break; }
        ok = false;
      }
    } else if (c == 't') {
      v.kind = JVal::BOOL; v.b = true; ok = lit("true");
    } else if (c == 'f') {
      v.kind = JVal::BOOL; v.b = false; ok = lit("false");
    } else if (c == 'n') {
      v.kind = JVal::NUL; ok = lit("null");
    } else {
      // number: meta args only carry non-negative integers; floats and
      // negatives are accepted syntactically (truncated toward zero)
      v.kind = JVal::NUM;
      bool neg = (*p == '-');
      if (neg) p++;
      uint64_t n = 0;
      bool any = false;
      while (p < end && *p >= '0' && *p <= '9') { n = n * 10 + (*p++ - '0'); any = true; }
      if (p < end && (*p == '.' || *p == 'e' || *p == 'E')) {
        // skip fraction/exponent
        while (p < end && (*p == '.' || *p == 'e' || *p == 'E' || *p == '+' ||
                           *p == '-' || (*p >= '0' && *p <= '9')))
          p++;
      }
      if (!any) ok = false;
      v.num = neg ? 0 : n;
    }
    return v;
  }
};

void j_escape(std::string& out, const std::string& s) {
  out += '"';
  for (unsigned char c : s) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\b': out += "\\b"; break;
      case '\f': out += "\\f"; break;
      case '\n': out += "\\n"; break;
      case '\r': out += "\\r"; break;
      case '\t': out += "\\t"; break;
      default:
        if (c < 0x20) {
          char buf[8];
          snprintf(buf, sizeof buf, "\\u%04x", c);
          out += buf;
        } else {
          out += (char)c;  // raw UTF-8 passes through: valid JSON
        }
    }
  }
  out += '"';
}

// ---------------------------------------------------------------- store
struct Partition {
  uint64_t pid, start, end;
  mutable std::shared_mutex mu;
  bool serving = false;       // leader (or standalone): reads allowed
  std::string leader;         // advertised redirect target when not
  std::unordered_map<uint64_t, std::string> inodes;  // ino -> JSON blob
  std::unordered_map<uint64_t, std::map<std::string, uint64_t>> dentries;
  // sub-ranges a split or merge handed away: {lo, hi, target pid}
  std::vector<std::array<uint64_t, 3>> moved;
};

// The pid a moved sub-range went to, or 0 (caller holds p.mu).
uint64_t moved_to(const Partition& p, uint64_t ino) {
  for (auto& m : p.moved)
    if (m[0] <= ino && ino < m[1]) return m[2];
  return 0;
}

struct MetaServe {
  mutable std::shared_mutex pmu;
  std::unordered_map<uint64_t, std::shared_ptr<Partition>> parts;

  int listen_fd = -1;
  std::thread accepter;
  std::atomic<bool> stopping{false};
  std::atomic<int> live_conns{0};
  std::atomic<uint64_t> ops{0};
  std::mutex conn_mu;
  std::vector<int> conn_fds;

  std::shared_ptr<Partition> by_pid(uint64_t pid) const {
    std::shared_lock l(pmu);
    auto it = parts.find(pid);
    return it == parts.end() ? nullptr : it->second;
  }
  std::shared_ptr<Partition> by_ino(uint64_t ino) const {
    std::shared_lock l(pmu);
    for (auto& kv : parts)
      if (kv.second->start <= ino && ino < kv.second->end) return kv.second;
    return nullptr;
  }
};

using pktwire::PacketHdr;
using pktwire::recv_exact;
using pktwire::send_all;

constexpr uint8_t MAGIC = pktwire::MAGIC;
constexpr uint8_t RESULT_RPC = pktwire::RESULT_RPC;
constexpr uint8_t OP_META_LOOKUP = 0x20;
constexpr uint8_t OP_META_INODE_GET = 0x21;
constexpr uint8_t OP_META_READDIR = 0x22;
constexpr uint8_t OP_META_DENTRY_COUNT = 0x24;
constexpr uint8_t OP_META_WALK = 0x26;
constexpr uint8_t OP_PING = 0x7F;
constexpr uint32_t MAX_FRAME = pktwire::MAX_FRAME;

// errno -> wire code, matching utils/rpc.py errno_error: 400+errno for
// small errnos (404/421 never arise from ENOENT/ENOTDIR), else 499
int errno_code(int e) { return (e < 99) ? 400 + e : 499; }

struct RpcReject {
  int code;
  std::string msg;
};

void reply_err(int fd, const PacketHdr& req, const RpcReject& e) {
  std::string args = "{\"error\": ";
  j_escape(args, e.msg);
  args += ", \"code\": " + std::to_string(e.code) + "}";
  reply(fd, req, RESULT_RPC, args);
}

// serving gate: Python's _mp_leader analog (404 when absent, 421 when
// not leader-served). Returns the partition with mu held shared.
std::shared_ptr<Partition> gate(MetaServe* ms, uint64_t pid,
                                std::shared_lock<std::shared_mutex>& lk) {
  auto p = ms->by_pid(pid);
  if (!p) throw RpcReject{404, "meta partition " + std::to_string(pid) +
                                   " not on this node"};
  std::shared_lock l(p->mu);
  if (!p->serving) throw RpcReject{421, "leader=" + p->leader};
  lk = std::move(l);
  return p;
}

// Python's _range_gate_read: a moved sub-range redirects (453, the
// target pid) instead of answering ENOENT from the trees it dropped to a
// client that holds the partition map from before the split.
void fence_moved(const Partition& p, uint64_t ino) {
  if (uint64_t t = moved_to(p, ino))
    throw RpcReject{453, "pid=" + std::to_string(t)};
}

uint64_t need_num(const JVal& args, const char* key) {
  const JVal* v = args.get(key);
  if (!v || v->kind != JVal::NUM)
    throw RpcReject{400, std::string("missing/bad arg ") + key};
  return v->num;
}

std::string need_str(const JVal& args, const char* key) {
  const JVal* v = args.get(key);
  if (!v || v->kind != JVal::STR)
    throw RpcReject{400, std::string("missing/bad arg ") + key};
  return v->str;
}

std::string op_lookup(MetaServe* ms, const JVal& args) {
  uint64_t pid = need_num(args, "pid");
  uint64_t parent = need_num(args, "parent");
  std::string name = need_str(args, "name");
  std::shared_lock<std::shared_mutex> lk;
  auto p = gate(ms, pid, lk);
  fence_moved(*p, parent);
  auto d = p->dentries.find(parent);
  if (d == p->dentries.end())
    throw RpcReject{errno_code(2), name + " not in " + std::to_string(parent)};
  auto it = d->second.find(name);
  if (it == d->second.end())
    throw RpcReject{errno_code(2), name + " not in " + std::to_string(parent)};
  return "{\"ino\": " + std::to_string(it->second) + "}";
}

std::string op_inode_get(MetaServe* ms, const JVal& args) {
  uint64_t pid = need_num(args, "pid");
  uint64_t ino = need_num(args, "ino");
  std::shared_lock<std::shared_mutex> lk;
  auto p = gate(ms, pid, lk);
  fence_moved(*p, ino);
  auto it = p->inodes.find(ino);
  if (it == p->inodes.end())
    throw RpcReject{errno_code(2), "inode " + std::to_string(ino)};
  return "{\"inode\": " + it->second + "}";
}

std::string op_readdir(MetaServe* ms, const JVal& args) {
  uint64_t pid = need_num(args, "pid");
  uint64_t parent = need_num(args, "parent");
  std::shared_lock<std::shared_mutex> lk;
  auto p = gate(ms, pid, lk);
  fence_moved(*p, parent);
  auto d = p->dentries.find(parent);
  if (d == p->dentries.end())
    throw RpcReject{errno_code(20),
                    std::to_string(parent) + " is not a dir here"};
  std::string out = "{\"entries\": {";
  bool first = true;
  for (auto& kv : d->second) {
    if (!first) out += ", ";
    first = false;
    j_escape(out, kv.first);
    out += ": " + std::to_string(kv.second);
  }
  out += "}}";
  return out;
}

std::string op_dentry_count(MetaServe* ms, const JVal& args) {
  uint64_t pid = need_num(args, "pid");
  uint64_t parent = need_num(args, "parent");
  std::shared_lock<std::shared_mutex> lk;
  auto p = gate(ms, pid, lk);
  fence_moved(*p, parent);
  auto d = p->dentries.find(parent);
  size_t n = d == p->dentries.end() ? 0 : d->second.size();
  return "{\"count\": " + std::to_string(n) + "}";
}

std::string op_walk(MetaServe* ms, const JVal& args) {
  // Python rpc_walk parity: consume names while the owning partition is
  // local AND leader-served; hand back {ino, remaining} otherwise.
  uint64_t ino = need_num(args, "ino");
  const JVal* names_v = args.get("names");
  if (!names_v || names_v->kind != JVal::ARR)
    throw RpcReject{400, "missing/bad arg names"};
  const JVal* stat_v = args.get("stat");
  bool want_stat = stat_v && stat_v->kind == JVal::BOOL && stat_v->b;
  std::vector<std::string> names;
  names.reserve(names_v->arr.size());
  for (auto& v : names_v->arr) {
    if (v.kind != JVal::STR) throw RpcReject{400, "missing/bad arg names"};
    names.push_back(v.str);
  }
  // With "pid" (the partition the client's view routed the walk to),
  // the walk reads that partition alone while the ino lies in its range:
  // every volume's first partition starts at inode 1, so on a node
  // hosting two volumes a range names no partition. Without it, the
  // reference's search by range.
  const JVal* pid_v = args.get("pid");
  const bool pinned = pid_v && pid_v->kind == JVal::NUM;
  const std::shared_ptr<Partition> home =
      pinned ? ms->by_pid((uint64_t)pid_v->num) : nullptr;
  auto owner = [&](uint64_t i) -> std::shared_ptr<Partition> {
    if (!pinned) return ms->by_ino(i);
    return (home && home->start <= i && i < home->end) ? home : nullptr;
  };
  size_t i = 0;
  while (i < names.size()) {
    auto p = owner(ino);
    if (!p) break;
    std::shared_lock l(p->mu);
    // a moved sub-range hands back a partial, as Python's walk does
    if (!p->serving || moved_to(*p, ino)) break;
    auto d = p->dentries.find(ino);
    if (d == p->dentries.end())
      throw RpcReject{errno_code(2),
                      names[i] + " not in " + std::to_string(ino)};
    auto it = d->second.find(names[i]);
    if (it == d->second.end())
      throw RpcReject{errno_code(2),
                      names[i] + " not in " + std::to_string(ino)};
    ino = it->second;
    i++;
  }
  std::string out = "{\"ino\": " + std::to_string(ino) + ", \"remaining\": [";
  for (size_t k = i; k < names.size(); k++) {
    if (k > i) out += ", ";
    j_escape(out, names[k]);
  }
  out += "]";
  if (i == names.size() && want_stat) {
    auto p = owner(ino);
    if (p) {
      std::shared_lock l(p->mu);
      if (p->serving && !moved_to(*p, ino)) {
        auto it = p->inodes.find(ino);
        if (it == p->inodes.end())
          throw RpcReject{errno_code(2), "inode " + std::to_string(ino)};
        out += ", \"inode\": " + it->second;
      }
    }
  }
  out += "}";
  return out;
}

void serve_conn(MetaServe* ms, int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
  std::string args_buf, payload_buf;
  while (!ms->stopping.load(std::memory_order_relaxed)) {
    PacketHdr h;
    if (!recv_exact(fd, &h, sizeof h)) break;
    if (h.magic != MAGIC || h.asize > MAX_FRAME || h.psize > MAX_FRAME)
      break;  // framing lost: drop the connection (packet.py discipline)
    args_buf.resize(h.asize);
    if (h.asize && !recv_exact(fd, &args_buf[0], h.asize)) break;
    payload_buf.resize(h.psize);
    if (h.psize && !recv_exact(fd, &payload_buf[0], h.psize)) break;
    if (rt_crc32(0, (const uint8_t*)payload_buf.data(),
                 payload_buf.size()) != h.crc)
      break;  // corrupt payload: drop
    ms->ops.fetch_add(1, std::memory_order_relaxed);
    JVal args;
    if (h.asize) {
      JParser jp(args_buf);
      args = jp.value();
      if (!jp.ok || args.kind != JVal::OBJ) {
        reply_err(fd, h, {400, "bad args json"});
        continue;
      }
    } else {
      args.kind = JVal::OBJ;
    }
    try {
      std::string out;
      switch (h.opcode) {
        case OP_PING: out = "{}"; break;
        case OP_META_LOOKUP: out = op_lookup(ms, args); break;
        case OP_META_INODE_GET: out = op_inode_get(ms, args); break;
        case OP_META_READDIR: out = op_readdir(ms, args); break;
        case OP_META_DENTRY_COUNT: out = op_dentry_count(ms, args); break;
        case OP_META_WALK: out = op_walk(ms, args); break;
        default: {
          // not a native read op: this plane doesn't serve it (the SDK
          // routes writes to the Python packet plane); 0xFD matches the
          // Python server's unknown-opcode result
          PacketHdr rh = h;
          std::string eargs = "{\"error\": \"no opcode on native read plane\"}";
          reply(fd, rh, 0xFD, eargs);
          continue;
        }
      }
      reply(fd, h, 0, out);
    } catch (const RpcReject& e) {
      reply_err(fd, h, e);
    } catch (const std::exception& e) {
      reply_err(fd, h, {500, std::string("native metaserve: ") + e.what()});
    }
  }
  {
    // deregister BEFORE closing: ms_stop only shutdown()s registered
    // fds and never closes them, so an fd number freed by this close
    // can never be shut down after the kernel reuses it
    std::lock_guard<std::mutex> g(ms->conn_mu);
    auto& v = ms->conn_fds;
    v.erase(std::remove(v.begin(), v.end(), fd), v.end());
  }
  close(fd);
  ms->live_conns.fetch_sub(1);
}

void accept_loop(MetaServe* ms) {
  while (!ms->stopping.load()) {
    int fd = accept(ms->listen_fd, nullptr, nullptr);
    if (fd < 0) {
      if (ms->stopping.load()) return;
      std::this_thread::sleep_for(std::chrono::milliseconds(5));
      continue;
    }
    ms->live_conns.fetch_add(1);
    {
      std::lock_guard<std::mutex> g(ms->conn_mu);
      ms->conn_fds.push_back(fd);
    }
    // ms_stop sets `stopping` BEFORE sweeping conn_fds under conn_mu:
    // either our push landed before the sweep (fd gets shut down
    // there), or we observe `stopping` here and shut it down ourselves
    // — a conn can never slip past both and block recv forever
    if (ms->stopping.load()) shutdown(fd, SHUT_RDWR);
    std::thread(serve_conn, ms, fd).detach();
  }
}

}  // namespace

extern "C" {

void* ms_create() { return new MetaServe(); }

void ms_destroy(void* h) {
  auto* ms = (MetaServe*)h;
  delete ms;
}

void ms_add_partition(void* h, uint64_t pid, uint64_t start, uint64_t end) {
  auto* ms = (MetaServe*)h;
  auto p = std::make_shared<Partition>();
  p->pid = pid;
  p->start = start;
  p->end = end;
  std::unique_lock l(ms->pmu);
  ms->parts[pid] = std::move(p);
}

void ms_drop_partition(void* h, uint64_t pid) {
  auto* ms = (MetaServe*)h;
  std::unique_lock l(ms->pmu);
  ms->parts.erase(pid);
}

void ms_set_serving(void* h, uint64_t pid, int serving, const char* leader) {
  auto* ms = (MetaServe*)h;
  auto p = ms->by_pid(pid);
  if (!p) return;
  std::unique_lock l(p->mu);
  p->serving = serving != 0;
  p->leader = leader ? leader : "";
}

// The partition's moved sub-ranges, replaced whole: n triples {lo, hi,
// target pid} at v.
void ms_set_moved(void* h, uint64_t pid, const uint64_t* v, uint64_t n) {
  auto* ms = (MetaServe*)h;
  auto p = ms->by_pid(pid);
  if (!p) return;
  std::unique_lock l(p->mu);
  p->moved.clear();
  for (uint64_t i = 0; i < n; i++)
    p->moved.push_back({v[3 * i], v[3 * i + 1], v[3 * i + 2]});
}

void ms_put_inode(void* h, uint64_t pid, uint64_t ino, const char* blob,
                  uint32_t len) {
  auto* ms = (MetaServe*)h;
  auto p = ms->by_pid(pid);
  if (!p) return;
  std::unique_lock l(p->mu);
  p->inodes[ino].assign(blob, len);
}

void ms_del_inode(void* h, uint64_t pid, uint64_t ino) {
  auto* ms = (MetaServe*)h;
  auto p = ms->by_pid(pid);
  if (!p) return;
  std::unique_lock l(p->mu);
  p->inodes.erase(ino);
}

void ms_ensure_dir(void* h, uint64_t pid, uint64_t ino) {
  auto* ms = (MetaServe*)h;
  auto p = ms->by_pid(pid);
  if (!p) return;
  std::unique_lock l(p->mu);
  p->dentries.try_emplace(ino);
}

void ms_del_dir(void* h, uint64_t pid, uint64_t ino) {
  auto* ms = (MetaServe*)h;
  auto p = ms->by_pid(pid);
  if (!p) return;
  std::unique_lock l(p->mu);
  p->dentries.erase(ino);
}

void ms_put_dentry(void* h, uint64_t pid, uint64_t parent, const char* name,
                   uint32_t nlen, uint64_t ino) {
  auto* ms = (MetaServe*)h;
  auto p = ms->by_pid(pid);
  if (!p) return;
  std::unique_lock l(p->mu);
  p->dentries[parent][std::string(name, nlen)] = ino;
}

void ms_del_dentry(void* h, uint64_t pid, uint64_t parent, const char* name,
                   uint32_t nlen) {
  auto* ms = (MetaServe*)h;
  auto p = ms->by_pid(pid);
  if (!p) return;
  std::unique_lock l(p->mu);
  auto d = p->dentries.find(parent);
  if (d != p->dentries.end()) d->second.erase(std::string(name, nlen));
}

void ms_clear(void* h, uint64_t pid) {
  auto* ms = (MetaServe*)h;
  auto p = ms->by_pid(pid);
  if (!p) return;
  std::unique_lock l(p->mu);
  p->inodes.clear();
  p->dentries.clear();
}

uint64_t ms_op_count(void* h) { return ((MetaServe*)h)->ops.load(); }

// Returns the bound port, or -1 on failure.
int ms_serve(void* h, const char* host, int port) {
  auto* ms = (MetaServe*)h;
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)port);
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    close(fd);
    return -1;
  }
  if (bind(fd, (sockaddr*)&addr, sizeof addr) != 0 || listen(fd, 128) != 0) {
    close(fd);
    return -1;
  }
  socklen_t alen = sizeof addr;
  getsockname(fd, (sockaddr*)&addr, &alen);
  ms->listen_fd = fd;
  ms->stopping.store(false);
  ms->accepter = std::thread(accept_loop, ms);
  return (int)ntohs(addr.sin_port);
}

// Load generator for capacity measurement (the mdtest-shape driver):
// `conns` connections (one thread each) issue `iters` serial
// round-trips of the same request frame. Returns elapsed seconds, or
// -1 when any connection fails or any reply is an error. Lives here so
// capacity numbers measure the server without a Python client's GIL in
// the loop (this box benches on one core).
double ms_bench(const char* host, int port, int opcode,
                const char* args_json, int iters, int conns) {
  std::string args = args_json ? args_json : "";
  PacketHdr h{};
  h.magic = MAGIC;
  h.opcode = (uint8_t)opcode;
  h.crc = rt_crc32(0, nullptr, 0);
  h.asize = (uint32_t)args.size();
  std::string frame((const char*)&h, sizeof h);
  frame += args;
  std::atomic<bool> failed{false};
  auto worker = [&]() {
    int fd = socket(AF_INET, SOCK_STREAM, 0);
    sockaddr_in a{};
    a.sin_family = AF_INET;
    a.sin_port = htons((uint16_t)port);
    if (fd < 0 || inet_pton(AF_INET, host, &a.sin_addr) != 1 ||
        connect(fd, (sockaddr*)&a, sizeof a) != 0) {
      failed.store(true);
      if (fd >= 0) close(fd);
      return;
    }
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
    std::string body;
    for (int i = 0; i < iters && !failed.load(); i++) {
      PacketHdr rh;
      if (!send_all(fd, frame.data(), frame.size()) ||
          !recv_exact(fd, &rh, sizeof rh)) {
        failed.store(true);
        break;
      }
      size_t rest = (size_t)rh.asize + rh.psize;
      body.resize(rest);
      if (rest && !recv_exact(fd, &body[0], rest)) {
        failed.store(true);
        break;
      }
      if (rh.result != 0) failed.store(true);
    }
    close(fd);
  };
  auto t0 = std::chrono::steady_clock::now();
  std::vector<std::thread> ts;
  for (int c = 0; c < conns; c++) ts.emplace_back(worker);
  for (auto& t : ts) t.join();
  auto t1 = std::chrono::steady_clock::now();
  if (failed.load()) return -1;
  return std::chrono::duration<double>(t1 - t0).count();
}

void ms_stop(void* h) {
  auto* ms = (MetaServe*)h;
  ms->stopping.store(true);
  if (ms->listen_fd >= 0) {
    shutdown(ms->listen_fd, SHUT_RDWR);
    close(ms->listen_fd);
    ms->listen_fd = -1;
  }
  {
    std::lock_guard<std::mutex> g(ms->conn_mu);
    for (int fd : ms->conn_fds) shutdown(fd, SHUT_RDWR);
    ms->conn_fds.clear();
  }
  if (ms->accepter.joinable()) ms->accepter.join();
  while (ms->live_conns.load() > 0)
    std::this_thread::sleep_for(std::chrono::milliseconds(1));
}

}  // extern "C"
