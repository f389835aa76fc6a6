// Native datanode read plane: GIL-free extent reads.
//
// Role parity: datanode/server.go's TCP packet serving for read ops —
// the reference serves extent reads from Go directly over the native
// store. Here the Python DataNode keeps the write path (chain
// replication + per-dp raft need the Python planes), while this C++
// thread-per-connection server answers OP_READ from the SAME native
// extent-store handles (extentstore.cc es_read: internally locked,
// CRC-verified per block) with zero Python in the loop.
//
// Registration mirrors the meta plane: the Python DataNode registers
// each partition's es handle; serving flags flip with node/disk health
// (a broken disk's partitions answer 503-coded errors so clients fail
// over to another replica). ds_drop_partition BLOCKS until in-flight
// reads drain — the caller closes the store right after, and a read
// racing a close would touch freed memory.
//
// The PyTorch port's copy of cubefs_tpu/runtime/src/dataserve.cc (the same
// wire), in one library with extentstore.cc so the store handles cross.

#include <arpa/inet.h>

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <mutex>
#include <shared_mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include "packetwire.h"

extern "C" int64_t es_read(void* h, uint64_t extent_id, uint64_t off,
                           uint8_t* buf, uint64_t len);
extern "C" uint64_t es_size(void* h, uint64_t extent_id);
extern "C" const char* es_last_error(void* h);

namespace {

using pktwire::PacketHdr;

constexpr uint8_t OP_READ = 0x02;
constexpr uint8_t OP_PING = 0x7F;
// reads span up to a whole extent (128 MiB, extentstore kMaxExtent) —
// the inbound-frame cap stays small, this bounds only the reply
constexpr uint64_t MAX_READ = 128ull << 20;

struct Partition {
  void* es = nullptr;
  mutable std::shared_mutex mu;  // readers shared; drop exclusive
  bool serving = true;
};

struct DataServe {
  mutable std::shared_mutex pmu;
  std::unordered_map<uint64_t, std::shared_ptr<Partition>> parts;
  std::atomic<bool> down{false};  // node-level kill switch
  std::atomic<bool> stopping{false};
  std::atomic<int> live_conns{0};
  std::atomic<uint64_t> ops{0};
  int listen_fd = -1;
  std::thread accepter;
  std::mutex conn_mu;
  std::vector<int> conn_fds;
  std::mutex fail_mu;
  // DISTINCT dps with es_read failures since the last drain: a set, so
  // one dying dp's failure storm can neither grow memory nor push other
  // dps' signals past the drain cap
  std::unordered_set<uint64_t> failed_dps;

  std::shared_ptr<Partition> get(uint64_t dp) const {
    std::shared_lock l(pmu);
    auto it = parts.find(dp);
    return it == parts.end() ? nullptr : it->second;
  }
};

// args are tiny ({"length": N}); scan out one integer field
uint64_t parse_length(const std::string& args) {
  size_t k = args.find("\"length\"");
  if (k == std::string::npos) return 0;
  k = args.find(':', k);
  if (k == std::string::npos) return 0;
  k++;
  while (k < args.size() && (args[k] == ' ')) k++;
  uint64_t v = 0;
  while (k < args.size() && args[k] >= '0' && args[k] <= '9')
    v = v * 10 + (args[k++] - '0');
  return v;
}

void err_reply(int fd, const PacketHdr& req, int code, const char* msg) {
  std::string args = "{\"error\": \"";
  for (const char* p = msg; *p; p++)
    if (*p != '"' && *p != '\\' && (unsigned char)*p >= 0x20) args += *p;
  args += "\", \"code\": " + std::to_string(code) + "}";
  pktwire::reply(fd, req, pktwire::RESULT_RPC, args);
}

void serve_conn(DataServe* ds, int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
  std::string args_buf, payload_buf;
  std::vector<uint8_t> data;
  while (!ds->stopping.load(std::memory_order_relaxed)) {
    PacketHdr h;
    if (!pktwire::recv_exact(fd, &h, sizeof h)) break;
    if (h.magic != pktwire::MAGIC || h.asize > pktwire::MAX_FRAME ||
        h.psize > pktwire::MAX_FRAME)
      break;  // framing lost: drop the connection
    args_buf.resize(h.asize);
    if (h.asize && !pktwire::recv_exact(fd, &args_buf[0], h.asize)) break;
    payload_buf.resize(h.psize);
    if (h.psize && !pktwire::recv_exact(fd, &payload_buf[0], h.psize)) break;
    if (rt_crc32(0, (const uint8_t*)payload_buf.data(),
                 payload_buf.size()) != h.crc)
      break;  // corrupt payload: drop
    ds->ops.fetch_add(1, std::memory_order_relaxed);
    if (h.opcode == OP_PING) {
      pktwire::reply(fd, h, 0, "{}");
      continue;
    }
    if (h.opcode != OP_READ) {
      // not a native read op: this plane doesn't serve it (writes ride
      // the Python planes)
      pktwire::reply(fd, h, 0xFD,
                     "{\"error\": \"no opcode on native read plane\"}");
      continue;
    }
    if (ds->down.load()) {
      err_reply(fd, h, 503, "datanode is down");
      continue;
    }
    auto p = ds->get(h.partition);
    if (!p) {
      err_reply(fd, h, 404, "dp not on this node");
      continue;
    }
    std::shared_lock pl(p->mu);
    if (!p->serving || p->es == nullptr) {
      err_reply(fd, h, 503, "partition not served (disk broken?)");
      continue;
    }
    uint64_t want = parse_length(args_buf);
    if (want > MAX_READ) {
      err_reply(fd, h, 400, "length too large");
      continue;
    }
    // clamp the allocation to what the extent can actually yield: an
    // unauthenticated request must not commit 128 MiB for a bogus
    // extent/offset (es_read clamps identically, so replies match)
    uint64_t esz = es_size(p->es, h.extent);
    if (h.offset >= esz)
      want = 0;
    else if (want > esz - h.offset)
      want = esz - h.offset;
    data.resize(want);
    int64_t got = want ? es_read(p->es, h.extent, h.offset, data.data(),
                                 want)
                       : 0;
    if (got < 0) {
      const char* e = es_last_error(p->es);
      {
        // surface the failure to the Python disk triage: ds_take_failed
        // drains this set so a dying disk that only serves native reads
        // still gets probed, marked and migrated
        std::lock_guard<std::mutex> g(ds->fail_mu);
        ds->failed_dps.insert(h.partition);
      }
      err_reply(fd, h, 409, e ? e : "extent read failed");
      continue;
    }
    pktwire::reply(fd, h, 0, "{}", data.data(), (size_t)got);
    if (data.capacity() > (8u << 20) && want < (1u << 20)) {
      // don't pin a large-read high-water mark for an idle connection
      data.shrink_to_fit();
    }
  }
  {
    std::lock_guard<std::mutex> g(ds->conn_mu);
    auto& v = ds->conn_fds;
    for (size_t i = 0; i < v.size(); i++)
      if (v[i] == fd) {
        v.erase(v.begin() + (long)i);
        break;
      }
  }
  close(fd);
  ds->live_conns.fetch_sub(1);
}

void accept_loop(DataServe* ds) {
  while (!ds->stopping.load()) {
    int fd = accept(ds->listen_fd, nullptr, nullptr);
    if (fd < 0) {
      if (ds->stopping.load()) return;
      std::this_thread::sleep_for(std::chrono::milliseconds(5));
      continue;
    }
    ds->live_conns.fetch_add(1);
    {
      std::lock_guard<std::mutex> g(ds->conn_mu);
      ds->conn_fds.push_back(fd);
    }
    if (ds->stopping.load()) shutdown(fd, SHUT_RDWR);
    std::thread(serve_conn, ds, fd).detach();
  }
}

}  // namespace

extern "C" {

void* ds_create() { return new DataServe(); }

void ds_destroy(void* h) { delete (DataServe*)h; }

void ds_add_partition(void* h, uint64_t dp_id, void* es, int serving) {
  auto* ds = (DataServe*)h;
  auto p = std::make_shared<Partition>();
  p->es = es;
  p->serving = serving != 0;
  std::unique_lock l(ds->pmu);
  ds->parts[dp_id] = std::move(p);
}

void ds_set_serving(void* h, uint64_t dp_id, int serving) {
  auto* ds = (DataServe*)h;
  auto p = ds->get(dp_id);
  if (!p) return;
  std::unique_lock l(p->mu);
  p->serving = serving != 0;
}

// Blocks until in-flight reads on the partition drain, then forgets it
// — the caller closes the extent store right after, so a racing read
// must never still hold the handle.
void ds_drop_partition(void* h, uint64_t dp_id) {
  auto* ds = (DataServe*)h;
  std::shared_ptr<Partition> p;
  {
    std::unique_lock l(ds->pmu);
    auto it = ds->parts.find(dp_id);
    if (it == ds->parts.end()) return;
    p = it->second;
    ds->parts.erase(it);
  }
  std::unique_lock l(p->mu);  // waits for shared holders (reads)
  p->es = nullptr;
}

void ds_set_down(void* h, int down) {
  ((DataServe*)h)->down.store(down != 0);
}

uint64_t ds_op_count(void* h) { return ((DataServe*)h)->ops.load(); }

// Drain dp_ids whose native reads hit store errors since the last call
// (clear-on-read); returns the count written into out (<= cap).
int ds_take_failed(void* h, uint64_t* out, int cap) {
  auto* ds = (DataServe*)h;
  std::lock_guard<std::mutex> g(ds->fail_mu);
  int n = 0;
  for (auto it = ds->failed_dps.begin();
       it != ds->failed_dps.end() && n < cap;) {
    out[n++] = *it;
    it = ds->failed_dps.erase(it);  // entries past cap stay for next drain
  }
  return n;
}

int ds_serve(void* h, const char* host, int port) {
  auto* ds = (DataServe*)h;
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
  ds->listen_fd = fd;
  ds->stopping.store(false);
  ds->accepter = std::thread(accept_loop, ds);
  return (int)ntohs(addr.sin_port);
}

void ds_stop(void* h) {
  auto* ds = (DataServe*)h;
  ds->stopping.store(true);
  if (ds->listen_fd >= 0) {
    shutdown(ds->listen_fd, SHUT_RDWR);
    close(ds->listen_fd);
    ds->listen_fd = -1;
  }
  {
    std::lock_guard<std::mutex> g(ds->conn_mu);
    for (int fd : ds->conn_fds) shutdown(fd, SHUT_RDWR);
    ds->conn_fds.clear();
  }
  if (ds->accepter.joinable()) ds->accepter.join();
  while (ds->live_conns.load() > 0)
    std::this_thread::sleep_for(std::chrono::milliseconds(1));
}

}  // extern "C"
