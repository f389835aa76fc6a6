// GF(2^8) matrix times shards in the GF(2) bit-matrix form, on Hopper's
// int8 tensor cores:
//   out[b, r, s] = XOR over c of coeff[r, c] * in[b, c, s]
// computed as (W . bits(in)) & 1, repacked, where W is the (8R, 8C) 0/1
// expansion of coeff and bits() the plane-major bit planes of the input.
// in (B, C, S) uint8 (stripe stride given, rows contiguous), W the int8
// operand of ops/gf_bitmajor.py bitmajor_operand on the device, out
// (B, R, S) uint8 contiguous.
//
// Replaces the tuning kernels of the JAX package:
//   C  benchmarks/pallas_tuning.py:41 _kernel_bitmajor (launched :73 per
//      stripe under vmap, :101 on a (B, S/T) grid), int32 or u8 extraction;
//   D  benchmarks/pallas_tuning2.py:56 _mk_kernel (launched :106 on the
//      2-D grid, :127 per stripe), extraction loop / bcast / bool and the
//      probes nodot (:65-72) and noext (:74-76).
//
// Bound on this card: device-memory bytes, (C + R) * S * B at 3.35 TB/s
// (0.070 ms at R=2, C=12, B=4, S=4 MiB). The form's own tensor-core work,
// 2 * 8R * 8C * S * B int8 operations (0.026 ms there at 1979 TOP/s), is
// under that, so the form can in principle reach the byte bound; at
// 36 x 36 it is 0.35 ms and above the bytes.
//
// Operand layout (bitmajor_operand): W is (Mpad, Kpad) int8, row
// m = 8r + k is bit k of output byte r (byte-major, R padded to even), column
// n = 32 * (c / 4) + 4k + c % 4 is bit k of shard row c: K chunk q (32 deep)
// is the 8 planes of shard rows 4q .. 4q+3, C padded to a multiple of 4.
// Padding rows and columns are zero. Kpad = 8 * Cpad is a multiple of 32
// and Mpad = 8 * Rpad a multiple of 16: whole m16n8k32 tiles.
//
// Design. A block owns T columns of one stripe (T a multiple of 32) and
// runs 4 warps.
// 1. Staging: the (C, T) byte tile is read once from device memory with
//    16-byte loads and stored to shared memory transposed, as 32-bit words
//    xw[c / 4][j] = in[c .. c+3, j] (a 4 x 4 byte transpose with
//    __byte_perm). Rows past C are zero; columns past S are zero (the
//    ragged tail is masked, not left unwritten as the Pallas grid s // T
//    leaves it).
// 2. Fragments straight from registers: lane (g, t) of m16n8k32 holds K
//    rows 4t .. 4t+3 and 16+4t .. 16+4t+3 of column g in its two s8
//    B registers. In W's K order those are planes t and 4+t of shard rows
//    4q .. 4q+3, so one shared word w = xw[q][j] gives both registers:
//    (w >> t) & 0x01010101 and (w >> (4 + t)) & 0x01010101. The bits are
//    never expanded in memory: the staged tile is C * T bytes, not 8C * T.
//    This was chosen over staging expanded bits because it needs 8x less
//    shared memory and no second pass over it.
// 3. The dot: mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, A (W) from
//    shared memory, laid out once per block in fragment order (one 16-byte
//    load per fragment), up to four 16-row tiles of W per pass over the
//    input bits; R > 8 runs further passes.
// 4. Repack: lane (g, t) of the accumulator holds rows g and g + 8 of a
//    16-row tile, i.e. bit g of output bytes 2i and 2i+1 (the byte-major
//    row order puts one byte's 8 planes in 8 lanes). Each lane shifts its
//    & 1 sums to bit g, three __shfl_xor ORs gather the 8 planes, and lanes
//    0-3 write 2 x 2 bytes to a shared output stage, which the block then
//    writes to device memory with 16-byte stores.
//
// Variants (template parameters, bit-identical to each other):
//   kExtract: kPerByte (C's int32, D's loop: shift and mask each byte),
//             kSwar (C's u8, D's bcast: one shift and mask of the 32-bit
//             word), kCmp (D's bool: __vcmpne4 of the word against the
//             plane's mask).
//   kProbe:   kNone (the GF apply); kNoDot (D's nodot: the same staging
//             and extraction of every B register, each kept live by an
//             empty asm, then no dot: byte i of a column gathers rows
//             8i .. 8i+7 of the reference's plane-major bits (row k*C + c)
//             straight from the staged words); kNoExt (D's noext: the same
//             staging and dot, with every B register the byte x[0, j]
//             broadcast as int8, no extraction).
// Grid: the vmapped forms (per stripe) are one launch per stripe with
// gridDim.y = 1; the flat forms (flatgrid, bm-flat) one launch with the
// stripes in blockIdx.y. The wrapper chooses; the kernel is the same.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMTilesPerPass = 4;

enum { kPerByte = 0, kSwar = 1, kCmp = 2 };
enum { kNone = 0, kNoDot = 1, kNoExt = 2 };

template <int kExtract>
__device__ __forceinline__ uint32_t plane_bits(uint32_t w, int k) {
  if constexpr (kExtract == kPerByte) {
    uint32_t b = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) b |= (((w >> (8 * e)) & 0xFFu) >> k & 1u) << (8 * e);
    return b;
  } else if constexpr (kExtract == kSwar) {
    return (w >> k) & 0x01010101u;
  } else {
    return __vcmpne4(w & (0x01010101u << k), 0u) & 0x01010101u;
  }
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint4& a, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// 4 x 4 byte transpose: words a, b, c, d hold 4 columns of rows 0-3;
// w[j] gets rows 0-3 of column j.
__device__ __forceinline__ void transpose4(uint32_t a, uint32_t b, uint32_t c,
                                           uint32_t d, uint32_t (&w)[4]) {
  const uint32_t t0 = __byte_perm(a, b, 0x5140), t1 = __byte_perm(a, b, 0x7362);
  const uint32_t t2 = __byte_perm(c, d, 0x5140), t3 = __byte_perm(c, d, 0x7362);
  w[0] = __byte_perm(t0, t2, 0x5410);
  w[1] = __byte_perm(t0, t2, 0x7632);
  w[2] = __byte_perm(t1, t3, 0x5410);
  w[3] = __byte_perm(t1, t3, 0x7632);
}

template <int kExtract, int kProbe>
__global__ void __launch_bounds__(kThreads)
gf_bitmajor_kernel(const uint8_t* __restrict__ in, long long in_stride,
                   uint8_t* __restrict__ out, const int8_t* __restrict__ w,
                   int R, int C, long long S, int T, bool vec) {
  const int cpad = (C + 3) & ~3, rpad = (R + 1) & ~1;
  const int kdim = 8 * cpad, mdim = 8 * rpad;
  const int n_kc = kdim / 32, n_mt = mdim / 16;
  extern __shared__ uint4 smem[];
  uint4* a_frag = smem;                                            // n_mt * n_kc * 32
  uint32_t* xw = reinterpret_cast<uint32_t*>(a_frag + n_mt * n_kc * 32);  // cpad/4 * T
  uint8_t* os = reinterpret_cast<uint8_t*>(xw + (cpad / 4) * T);    // rpad * T

  const int tid = threadIdx.x;
  const long long col0 = (long long)blockIdx.x * T;
  const uint8_t* src = in + (long long)blockIdx.y * in_stride;
  uint8_t* dst = out + (long long)blockIdx.y * R * S;

  // W in fragment order: entry (mt, q, lane) holds lane's four A registers.
  if constexpr (kProbe != kNoDot) {
    for (int i = tid; i < n_mt * n_kc * 32; i += kThreads) {
      const int lane = i & 31, q = (i >> 5) % n_kc, mt = (i >> 5) / n_kc;
      const int g = lane >> 2, t = lane & 3;
      const int8_t* r0 = w + (long long)(16 * mt + g) * kdim + 32 * q + 4 * t;
      const int8_t* r1 = r0 + 8 * kdim;
      a_frag[i] = make_uint4(*reinterpret_cast<const uint32_t*>(r0),
                             *reinterpret_cast<const uint32_t*>(r1),
                             *reinterpret_cast<const uint32_t*>(r0 + 16),
                             *reinterpret_cast<const uint32_t*>(r1 + 16));
    }
  }

  // Stage the (C, T) tile as transposed words, 16 columns per item.
  const int chunks = T / 16;
  for (int i = tid; i < (cpad / 4) * chunks; i += kThreads) {
    const int cg = i / chunks, ch = i % chunks;
    const long long col = col0 + 16 * ch;
    uint32_t v[4][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 4 * cg + e;
      const uint8_t* p = src + (long long)row * S + col;
      if (row < C && vec && col + 16 <= S) {
        const uint4 u = *reinterpret_cast<const uint4*>(p);
        v[e][0] = u.x; v[e][1] = u.y; v[e][2] = u.z; v[e][3] = u.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[e][j] = 0;
        if (row < C)
          for (int j = 0; j < 16; ++j)
            if (col + j < S) v[e][j >> 2] |= (uint32_t)p[j] << (8 * (j & 3));
      }
    }
    if constexpr (kProbe == kNoExt) {
      // noext reads only row 0 back: keep every loaded word live.
#pragma unroll
      for (int e = 0; e < 4; ++e)
        asm volatile("" ::"r"(v[e][0]), "r"(v[e][1]), "r"(v[e][2]), "r"(v[e][3]));
    }
    uint4* q = reinterpret_cast<uint4*>(xw + cg * T + 16 * ch);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t t4[4];
      transpose4(v[0][j], v[1][j], v[2][j], v[3][j], t4);
      q[j] = make_uint4(t4[0], t4[1], t4[2], t4[3]);
    }
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  for (int nt = warp; nt < T / 8; nt += kWarps) {
    if (col0 + 8 * nt >= S) break;  // the rest of the tile lies past S
    const int col = 8 * nt + g;     // this lane's B column in the tile
    if constexpr (kProbe == kNoDot) {
      for (int q = 0; q < n_kc; ++q) {
        const uint32_t w4 = xw[q * T + col];
        const uint32_t b0 = plane_bits<kExtract>(w4, t);
        const uint32_t b1 = plane_bits<kExtract>(w4, 4 + t);
        asm volatile("" ::"r"(b0), "r"(b1));  // extract every register, then drop it
      }
      for (int i = t; i < R; i += 4) {  // byte i: reference rows 8i .. 8i+7
        int k = 8 * i / C, c = 8 * i % C;
        uint32_t byte = 0;
        for (int b = 0; b < 8; ++b) {
          byte |= ((xw[(c >> 2) * T + col] >> (8 * (c & 3) + k)) & 1u) << b;
          if (++c == C) { c = 0; ++k; }
        }
        os[i * T + col] = (uint8_t)byte;
      }
    } else {
      for (int mt0 = 0; mt0 < n_mt; mt0 += kMTilesPerPass) {
        int acc[kMTilesPerPass][4];
#pragma unroll
        for (int m = 0; m < kMTilesPerPass; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[m][j] = 0;
        uint32_t bx = 0;
        if constexpr (kProbe == kNoExt)
          bx = (xw[col] & 0xFFu) * 0x01010101u;  // x[0, j] as int8, four times
        for (int q = 0; q < n_kc; ++q) {
          uint32_t b0, b1;
          if constexpr (kProbe == kNoExt) {
            b0 = b1 = bx;
          } else {
            const uint32_t w4 = xw[q * T + col];  // shard rows 4q .. 4q+3
            b0 = plane_bits<kExtract>(w4, t);
            b1 = plane_bits<kExtract>(w4, 4 + t);
          }
#pragma unroll
          for (int m = 0; m < kMTilesPerPass; ++m)
            if (mt0 + m < n_mt)
              mma_s8(acc[m], a_frag[((mt0 + m) * n_kc + q) * 32 + lane], b0, b1);
        }
#pragma unroll
        for (int m = 0; m < kMTilesPerPass; ++m) {
          if (mt0 + m >= n_mt) break;
          uint32_t v = ((acc[m][0] & 1u) << g) | ((acc[m][1] & 1u) << (g + 8)) |
                       ((acc[m][2] & 1u) << (g + 16)) | ((acc[m][3] & 1u) << (g + 24));
          v |= __shfl_xor_sync(0xFFFFFFFFu, v, 4);
          v |= __shfl_xor_sync(0xFFFFFFFFu, v, 8);
          v |= __shfl_xor_sync(0xFFFFFFFFu, v, 16);
          if (g == 0) {  // bytes: (2i, 2t), (2i, 2t+1), (2i+1, 2t), (2i+1, 2t+1)
            const int r = 2 * (mt0 + m), j = 8 * nt + 2 * t;
            *reinterpret_cast<uint16_t*>(os + r * T + j) = (uint16_t)v;
            *reinterpret_cast<uint16_t*>(os + (r + 1) * T + j) = (uint16_t)(v >> 16);
          }
        }
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < R * chunks; i += kThreads) {
    const int r = i / chunks, ch = i % chunks;
    const long long col = col0 + 16 * ch;
    if (col >= S) continue;
    const uint8_t* s = os + r * T + 16 * ch;
    uint8_t* d = dst + (long long)r * S + col;
    if (vec && col + 16 <= S) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    } else {
      for (int j = 0; j < 16; ++j)
        if (col + j < S) d[j] = s[j];
    }
  }
}

size_t smem_bytes(int R, int C, int T) {
  const int cpad = (C + 3) & ~3, rpad = (R + 1) & ~1;
  return (size_t)(8 * rpad) * (8 * cpad) + (size_t)cpad * T +
         (size_t)rpad * T;
}

template <int kExtract, int kProbe>
int launch(const void* in, long long in_stride, void* out, const void* w, int R,
           int C, long long S, int B, int T, void* stream) {
  const size_t smem = smem_bytes(R, C, T);
  // Over the 48 KiB a block gets by default, opt in on every launch: the
  // attribute belongs to the current device, and setting it costs little.
  if (smem > (48 << 10)) {
    const cudaError_t e = cudaFuncSetAttribute(gf_bitmajor_kernel<kExtract, kProbe>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const bool vec = S % 16 == 0 && in_stride % 16 == 0 && (uintptr_t)in % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  const dim3 grid((unsigned)((S + T - 1) / T), (unsigned)B);
  gf_bitmajor_kernel<kExtract, kProbe><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)in, in_stride, (uint8_t*)out, (const int8_t*)w, R, C, S, T, vec);
  return (int)cudaGetLastError();
}

bool bad_args(int R, int C, long long S, int B, int T) {
  return R <= 0 || C <= 0 || S < 0 || B < 0 || T < 32 || T % 32 != 0;
}

}  // namespace

// The GF apply (C, and D without a probe). extract: 0 per byte, 1 SWAR,
// 2 compare. Returns a cudaError_t; cudaErrorInvalidValue for bad sizes.
extern "C" int gf_bitmajor_launch(const void* in, long long in_stride, void* out,
                                  const void* w, int R, int C, long long S, int B,
                                  int T, int extract, void* stream) {
  if (bad_args(R, C, S, B, T)) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  switch (extract) {
    case kPerByte: return launch<kPerByte, kNone>(in, in_stride, out, w, R, C, S, B, T, stream);
    case kSwar: return launch<kSwar, kNone>(in, in_stride, out, w, R, C, S, B, T, stream);
    case kCmp: return launch<kCmp, kNone>(in, in_stride, out, w, R, C, S, B, T, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// D's probes. probe: 1 nodot (with extract as above; needs R <= C, as the
// reference's row slice does), 2 noext (extract unused).
extern "C" int gf_bitmajor_probe_launch(const void* in, long long in_stride, void* out,
                                        const void* w, int R, int C, long long S, int B,
                                        int T, int extract, int probe, void* stream) {
  if (bad_args(R, C, S, B, T) || (probe == kNoDot && R > C))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  if (probe == kNoExt)
    return launch<kSwar, kNoExt>(in, in_stride, out, w, R, C, S, B, T, stream);
  if (probe != kNoDot) return (int)cudaErrorInvalidValue;
  switch (extract) {
    case kPerByte: return launch<kPerByte, kNoDot>(in, in_stride, out, w, R, C, S, B, T, stream);
    case kSwar: return launch<kSwar, kNoDot>(in, in_stride, out, w, R, C, S, B, T, stream);
    case kCmp: return launch<kCmp, kNoDot>(in, in_stride, out, w, R, C, S, B, T, stream);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* gf_bitmajor_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
