// Host GF(2^8) codec legs of the port: the `cpp` and `cpp-xor` engines
// (cubefs_tpu_torch/codec/engine.py).
//
// The port's own copy of the JAX package's native CPU engine
// (cubefs_tpu/runtime/src/gfcpu.cc: gf_apply, xor_apply, gf_cpu_level).
// gf_apply is the split-nibble table-lookup multiply-accumulate (Plank,
// Greenan, Miller, FAST'13): for each coefficient c, two 16-entry tables
// map the low and high nibble of every input byte through PSHUFB/VPSHUFB,
// and products accumulate with XOR. Field: poly 0x11D, generator 2, the
// field of ops/gf256.py and of the CUDA kernels. xor_apply replays the
// XOR schedules that ops/xorprog.py compiles.
//
// Built with g++ (not nvcc) at first use by ops/gfcpu.py and bound with
// ctypes. The SIMD path is chosen at run time (__builtin_cpu_supports),
// so the library needs no -march flag.

#include <cstdint>
#include <cstring>
#include <mutex>

#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>
#define GF_X86 1
#endif

namespace {

constexpr uint16_t POLY = 0x11D;

uint8_t MUL[256][256];
std::once_flag mul_once;

void build_tables() {
  // call_once: ctypes drops the GIL, so concurrent first encodes would
  // otherwise read MUL mid-build (silent wrong parity)
  std::call_once(mul_once, [] {
    uint8_t exp[512];
    int log[256] = {0};
    int x = 1;
    for (int i = 0; i < 255; i++) {
      exp[i] = (uint8_t)x;
      log[x] = i;
      x <<= 1;
      if (x & 0x100) x ^= POLY;
    }
    for (int i = 255; i < 510; i++) exp[i] = exp[i - 255];
    for (int a = 0; a < 256; a++)
      for (int b = 0; b < 256; b++)
        MUL[a][b] = (a && b) ? exp[log[a] + log[b]] : 0;
  });
}

// scalar accumulate: out ^= c * in  (last-resort portable path)
void mulacc_scalar(uint8_t c, const uint8_t* in, uint8_t* out, uint64_t s) {
  const uint8_t* row = MUL[c];
  for (uint64_t k = 0; k < s; k++) out[k] ^= row[in[k]];
}

#ifdef GF_X86
__attribute__((target("ssse3"))) void mulacc_ssse3(uint8_t c,
                                                   const uint8_t* in,
                                                   uint8_t* out, uint64_t s) {
  uint8_t lo[16], hi[16];
  for (int v = 0; v < 16; v++) {
    lo[v] = MUL[c][v];
    hi[v] = MUL[c][v << 4];
  }
  __m128i tlo = _mm_loadu_si128((const __m128i*)lo);
  __m128i thi = _mm_loadu_si128((const __m128i*)hi);
  __m128i mask = _mm_set1_epi8(0x0F);
  uint64_t k = 0;
  for (; k + 16 <= s; k += 16) {
    __m128i x = _mm_loadu_si128((const __m128i*)(in + k));
    __m128i y = _mm_loadu_si128((const __m128i*)(out + k));
    __m128i pl = _mm_shuffle_epi8(tlo, _mm_and_si128(x, mask));
    __m128i ph = _mm_shuffle_epi8(
        thi, _mm_and_si128(_mm_srli_epi64(x, 4), mask));
    y = _mm_xor_si128(y, _mm_xor_si128(pl, ph));
    _mm_storeu_si128((__m128i*)(out + k), y);
  }
  for (; k < s; k++) out[k] ^= MUL[c][in[k]];
}

__attribute__((target("avx2"))) void mulacc_avx2(uint8_t c, const uint8_t* in,
                                                 uint8_t* out, uint64_t s) {
  uint8_t lo[16], hi[16];
  for (int v = 0; v < 16; v++) {
    lo[v] = MUL[c][v];
    hi[v] = MUL[c][v << 4];
  }
  __m256i tlo = _mm256_broadcastsi128_si256(
      _mm_loadu_si128((const __m128i*)lo));
  __m256i thi = _mm256_broadcastsi128_si256(
      _mm_loadu_si128((const __m128i*)hi));
  __m256i mask = _mm256_set1_epi8(0x0F);
  uint64_t k = 0;
  for (; k + 32 <= s; k += 32) {
    __m256i x = _mm256_loadu_si256((const __m256i*)(in + k));
    __m256i y = _mm256_loadu_si256((const __m256i*)(out + k));
    __m256i pl = _mm256_shuffle_epi8(tlo, _mm256_and_si256(x, mask));
    __m256i ph = _mm256_shuffle_epi8(
        thi, _mm256_and_si256(_mm256_srli_epi64(x, 4), mask));
    y = _mm256_xor_si256(y, _mm256_xor_si256(pl, ph));
    _mm256_storeu_si256((__m256i*)(out + k), y);
  }
  for (; k < s; k++) out[k] ^= MUL[c][in[k]];
}
#endif

using MulAccFn = void (*)(uint8_t, const uint8_t*, uint8_t*, uint64_t);

MulAccFn pick_mulacc() {
#ifdef GF_X86
  if (__builtin_cpu_supports("avx2")) return mulacc_avx2;
  if (__builtin_cpu_supports("ssse3")) return mulacc_ssse3;
#endif
  return mulacc_scalar;
}

}  // namespace

extern "C" {

// out[b,i,:] = XOR_j mat[i*n+j] (x) in[b,j,:]   (contiguous uint8 views)
void gf_apply(const uint8_t* mat, uint64_t m, uint64_t n, const uint8_t* in,
              uint8_t* out, uint64_t s, uint64_t batch) {
  build_tables();
  MulAccFn mulacc = pick_mulacc();
  for (uint64_t b = 0; b < batch; b++) {
    const uint8_t* ib = in + b * n * s;
    uint8_t* ob = out + b * m * s;
    for (uint64_t i = 0; i < m; i++) {
      uint8_t* dst = ob + i * s;
      memset(dst, 0, s);
      for (uint64_t j = 0; j < n; j++) {
        uint8_t c = mat[i * n + j];
        if (c == 0) continue;
        mulacc(c, ib + j * s, dst, s);
      }
    }
  }
}

// Scheduled XOR-program executor: the native replay of the schedules
// ops/xorprog.py compiles (the arXiv 2108.02692 direction). The op
// stream is int32 [dst, nsrc, src...]* over plane slots: slots
// [0, 8*cin) are input bit-planes (shard j bit k -> slot 8j+k,
// LSB-first, matching ops/bitlin.py), the LAST 8*rout slots are output
// planes (row i bit b -> nslots-8*rout+8i+b), temps in between. Per
// block, input shards are split to bit-planes with the 8x8 SWAR bit
// transpose, the ops replay as word-wide XOR (auto-vectorized at -O3),
// and output planes transpose back to bytes. s and block must be
// multiples of 64 (the python caller pads); the plane workspace is
// sized nslots*block/8 so the whole block stays cache-resident.

static inline uint64_t xp_transpose8(uint64_t x) {
  uint64_t t;
  t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAULL;
  x = x ^ t ^ (t << 7);
  t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCULL;
  x = x ^ t ^ (t << 14);
  t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ULL;
  x = x ^ t ^ (t << 28);
  return x;
}

void xor_apply(const int32_t* ops, uint64_t ops_words, const uint8_t* in,
               uint8_t* out, uint64_t cin, uint64_t rout, uint64_t nslots,
               uint64_t s, uint64_t batch, uint64_t block) {
  if (s % 64 || block % 64 || block == 0) return;  // caller contract
  const uint64_t plane_w = block / 64;  // uint64 words per plane slot
  uint64_t* ws = new uint64_t[nslots * plane_w];
  const uint64_t obase = nslots - 8 * rout;
  for (uint64_t b = 0; b < batch; b++) {
    for (uint64_t off = 0; off < s; off += block) {
      const uint64_t cur = (s - off < block) ? (s - off) : block;
      const uint64_t nw = cur / 8;   // words per shard block
      const uint64_t pw = cur / 64;  // words per plane this block
      // split: shard bytes -> 8 bit-planes each
      for (uint64_t j = 0; j < cin; j++) {
        const uint8_t* src = in + (b * cin + j) * s + off;
        uint8_t* pl = (uint8_t*)(ws + 8 * j * plane_w);
        const uint64_t pb = plane_w * 8;  // plane stride in bytes
        for (uint64_t w = 0; w < nw; w++) {
          uint64_t x;
          memcpy(&x, src + w * 8, 8);
          x = xp_transpose8(x);
          for (int k = 0; k < 8; k++)
            pl[(uint64_t)k * pb + w] = (uint8_t)(x >> (8 * k));
        }
      }
      // replay the schedule
      const int32_t* p = ops;
      const int32_t* end = ops + ops_words;
      while (p < end) {
        const int32_t dst = *p++;
        const int32_t n = *p++;
        uint64_t* d = ws + (uint64_t)dst * plane_w;
        if (n == 0) {
          memset(d, 0, pw * 8);
        } else {
          memcpy(d, ws + (uint64_t)p[0] * plane_w, pw * 8);
          for (int32_t i = 1; i < n; i++) {
            const uint64_t* si = ws + (uint64_t)p[i] * plane_w;
            for (uint64_t w = 0; w < pw; w++) d[w] ^= si[w];
          }
          p += n;
        }
      }
      // join: output planes -> bytes
      for (uint64_t i = 0; i < rout; i++) {
        uint8_t* dst = out + (b * rout + i) * s + off;
        const uint8_t* pl = (const uint8_t*)(ws + (obase + 8 * i) * plane_w);
        const uint64_t pb = plane_w * 8;
        for (uint64_t w = 0; w < nw; w++) {
          uint64_t x = 0;
          for (int k = 0; k < 8; k++)
            x |= (uint64_t)pl[(uint64_t)k * pb + w] << (8 * k);
          x = xp_transpose8(x);
          memcpy(dst + w * 8, &x, 8);
        }
      }
    }
  }
  delete[] ws;
}

// which SIMD path gf_apply will take: 2=avx2, 1=ssse3, 0=scalar
int gf_cpu_level() {
#ifdef GF_X86
  if (__builtin_cpu_supports("avx2")) return 2;
  if (__builtin_cpu_supports("ssse3")) return 1;
#endif
  return 0;
}

}  // extern "C"
