// Shared native CRC32 (IEEE, reflected 0xEDB88320) — the hot-loop CRC
// for the extent/chunk stores and the C ABI.
//
// Role parity: Go stdlib hash/crc32's CLMUL assembly (used by
// datanode/storage/extent.go:626 and blobstore's crc32block framing) —
// the reference's CPU write path checksums at >10 GB/s via PCLMULQDQ
// folding. This is an original implementation of that standard
// technique (Gopal et al., "Fast CRC Computation for Generic
// Polynomials Using PCLMULQDQ", Intel whitepaper 2009; the published
// folding constants for the IEEE polynomial are public domain and used
// verbatim by zlib variants and the Linux kernel). Verified
// bit-identical against zlib across lengths, alignments and seeds in
// tests/test_crc32cpu.py.
//
// Contract (matches the stores' crc32_ieee): `crc` is a FINALIZED crc
// (as returned to callers); un-finalized internally.

#include <cstddef>
#include <cstdint>

#if defined(__x86_64__)
#include <immintrin.h>
#define CRC_X86 1
#endif

namespace {

// ---------------- table fallback (slicing-by-8) ----------------
struct CrcTables {
  uint32_t t[8][256];
  CrcTables() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; i++)
      for (int s = 1; s < 8; s++)
        t[s][i] = t[0][t[s - 1][i] & 0xFF] ^ (t[s - 1][i] >> 8);
  }
};
const CrcTables kT;

uint32_t crc32_slice8(uint32_t crc, const uint8_t* p, size_t n) {
  crc = ~crc;
  while (n >= 8) {
    crc ^= (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
           ((uint32_t)p[3] << 24);
    crc = kT.t[7][crc & 0xFF] ^ kT.t[6][(crc >> 8) & 0xFF] ^
          kT.t[5][(crc >> 16) & 0xFF] ^ kT.t[4][crc >> 24] ^
          kT.t[3][p[4]] ^ kT.t[2][p[5]] ^ kT.t[1][p[6]] ^ kT.t[0][p[7]];
    p += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ kT.t[0][(crc ^ *p++) & 0xFF];
  return ~crc;
}

#ifdef CRC_X86
// Published folding constants for the reflected IEEE polynomial
// (Intel whitepaper §4; identical values appear in Chromium zlib's
// crc32_simd.c and the Linux kernel's crc32-pclmul):
//   k1 = x^(4*128+32) mod P, k2 = x^(4*128-32) mod P   (64-byte fold)
//   k3 = x^(128+32)   mod P, k4 = x^(128-32)   mod P   (16-byte fold)
//   k5 = x^(64+32)    mod P                            (128 -> 64)
//   poly = P'<<1 | 1, mu = floor(x^64 / P')            (Barrett)
// Preconditions: n >= 64 and n % 16 == 0 (rt_crc32 slices the tail off).
__attribute__((target("pclmul,sse4.1")))
uint32_t crc32_clmul(uint32_t crc0, const uint8_t* p, size_t n) {
  const __m128i k1k2 = _mm_set_epi64x(0x00000001c6e41596, 0x0000000154442bd4);
  const __m128i k3k4 = _mm_set_epi64x(0x00000000ccaa009e, 0x00000001751997d0);

  __m128i x1 = _mm_loadu_si128((const __m128i*)(p + 0));
  __m128i x2 = _mm_loadu_si128((const __m128i*)(p + 16));
  __m128i x3 = _mm_loadu_si128((const __m128i*)(p + 32));
  __m128i x4 = _mm_loadu_si128((const __m128i*)(p + 48));
  x1 = _mm_xor_si128(x1, _mm_cvtsi32_si128((int)~crc0));
  p += 64;
  n -= 64;

  while (n >= 64) {
    __m128i t;
    t = _mm_clmulepi64_si128(x1, k1k2, 0x00);
    x1 = _mm_clmulepi64_si128(x1, k1k2, 0x11);
    x1 = _mm_xor_si128(_mm_xor_si128(x1, t),
                       _mm_loadu_si128((const __m128i*)(p + 0)));
    t = _mm_clmulepi64_si128(x2, k1k2, 0x00);
    x2 = _mm_clmulepi64_si128(x2, k1k2, 0x11);
    x2 = _mm_xor_si128(_mm_xor_si128(x2, t),
                       _mm_loadu_si128((const __m128i*)(p + 16)));
    t = _mm_clmulepi64_si128(x3, k1k2, 0x00);
    x3 = _mm_clmulepi64_si128(x3, k1k2, 0x11);
    x3 = _mm_xor_si128(_mm_xor_si128(x3, t),
                       _mm_loadu_si128((const __m128i*)(p + 32)));
    t = _mm_clmulepi64_si128(x4, k1k2, 0x00);
    x4 = _mm_clmulepi64_si128(x4, k1k2, 0x11);
    x4 = _mm_xor_si128(_mm_xor_si128(x4, t),
                       _mm_loadu_si128((const __m128i*)(p + 48)));
    p += 64;
    n -= 64;
  }

  // fold 4 lanes into one (16-byte folds)
  __m128i t;
  t = _mm_clmulepi64_si128(x1, k3k4, 0x00);
  x1 = _mm_clmulepi64_si128(x1, k3k4, 0x11);
  x2 = _mm_xor_si128(x2, _mm_xor_si128(x1, t));
  t = _mm_clmulepi64_si128(x2, k3k4, 0x00);
  x2 = _mm_clmulepi64_si128(x2, k3k4, 0x11);
  x3 = _mm_xor_si128(x3, _mm_xor_si128(x2, t));
  t = _mm_clmulepi64_si128(x3, k3k4, 0x00);
  x3 = _mm_clmulepi64_si128(x3, k3k4, 0x11);
  x4 = _mm_xor_si128(x4, _mm_xor_si128(x3, t));

  while (n >= 16) {
    t = _mm_clmulepi64_si128(x4, k3k4, 0x00);
    x4 = _mm_clmulepi64_si128(x4, k3k4, 0x11);
    x4 = _mm_xor_si128(_mm_xor_si128(x4, t),
                       _mm_loadu_si128((const __m128i*)p));
    p += 16;
    n -= 16;
  }

  // Final reduction: the folded accumulator IS a 16-byte virtual
  // message with the same CRC residue as the whole input (verified
  // bit-identical against zlib in the derivation model), so a table
  // pass over its bytes replaces the fiddly Barrett sequence at
  // negligible cost.
  uint8_t tail[16];
  _mm_storeu_si128((__m128i*)tail, x4);
  uint32_t state = 0;  // raw state: the init-xor was folded in via x1
  for (int i = 0; i < 16; i++)
    state = kT.t[0][(state ^ tail[i]) & 0xFF] ^ (state >> 8);
  return ~state;
}
#endif

}  // namespace

extern "C" {

// Shared CRC entry for every native component (and ctypes callers).
uint32_t rt_crc32(uint32_t crc, const uint8_t* p, size_t n) {
#ifdef CRC_X86
  static const bool has_clmul =
      __builtin_cpu_supports("pclmul") && __builtin_cpu_supports("sse4.1");
  if (has_clmul && n >= 64) {
    size_t head = n & ~(size_t)15;  // clmul wants whole 16B blocks
    crc = crc32_clmul(crc, p, head);
    p += head;
    n -= head;
  }
#endif
  return crc32_slice8(crc, p, n);
}

int rt_crc32_level() {
#ifdef CRC_X86
  if (__builtin_cpu_supports("pclmul") && __builtin_cpu_supports("sse4.1"))
    return 1;
#endif
  return 0;
}

}  // extern "C"
