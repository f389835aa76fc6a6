// Shared 64-byte binary packet wire helpers (utils/packet.py parity),
// used by the native meta read plane (metaserve.cc) and the native data
// read plane (dataserve.cc). Header-only; everything inline.
//
// The PyTorch port's copy of cubefs_tpu/runtime/src/packetwire.h.
#pragma once

#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cstdint>
#include <cstring>
#include <string>

extern "C" uint32_t rt_crc32(uint32_t crc, const uint8_t* p, size_t n);

namespace pktwire {

#pragma pack(push, 1)
struct PacketHdr {
  uint8_t magic, opcode, flags, result;
  uint32_t crc, psize, asize;
  uint64_t partition, extent, offset, req_id;
  uint8_t reserved[16];
};
#pragma pack(pop)
static_assert(sizeof(PacketHdr) == 64, "header must be 64 bytes");

constexpr uint8_t MAGIC = 0xCF;
constexpr uint8_t RESULT_RPC = 0xE1;
constexpr uint32_t MAX_FRAME = 16u << 20;

inline bool recv_exact(int fd, void* buf, size_t n) {
  uint8_t* b = (uint8_t*)buf;
  while (n) {
    ssize_t r = recv(fd, b, n, 0);
    if (r <= 0) return false;
    b += r;
    n -= (size_t)r;
  }
  return true;
}

inline bool send_all(int fd, const void* buf, size_t n) {
  const uint8_t* b = (const uint8_t*)buf;
  while (n) {
    ssize_t r = send(fd, b, n, MSG_NOSIGNAL);
    if (r <= 0) return false;
    b += r;
    n -= (size_t)r;
  }
  return true;
}

inline void reply(int fd, const PacketHdr& req, uint8_t result,
                  const std::string& args,
                  const uint8_t* payload = nullptr, size_t plen = 0) {
  PacketHdr h{};
  h.magic = MAGIC;
  h.opcode = req.opcode;
  h.result = result;
  h.crc = rt_crc32(0, payload, plen);
  h.psize = (uint32_t)plen;
  h.asize = (uint32_t)args.size();
  h.req_id = req.req_id;
  // header+args coalesce into one small send; the payload goes straight
  // from the caller's buffer — no multi-MiB frame copy
  std::string head((const char*)&h, sizeof h);
  head += args;
  if (!send_all(fd, head.data(), head.size())) return;
  if (plen) send_all(fd, payload, plen);
}

}  // namespace pktwire
