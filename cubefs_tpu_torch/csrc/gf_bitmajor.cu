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
// Design: a persistent block, fed asynchronously.
// 1. Work items are (stripe, tile of T columns). The grid is the blocks an
//    SM holds times the SMs, capped at the items; each block lays W out in
//    fragment order once (one 16-byte shared load per fragment later) and
//    walks its items in a grid-stride loop.
// 2. Input ring: `stages` (3 where shared memory allows, else 2) raw
//    row-major (Cpad, T) byte tiles. One producer warp fills a stage with
//    one 1-D bulk copy per shard row (cp.async.bulk, completing on the
//    stage's "full" mbarrier); the consumer warps release it on its "empty"
//    mbarrier. Where bulk copies cannot go (S, the stripe stride or a base
//    not 16-byte aligned) the producer loads the tile itself, as aligned
//    16-byte words funnel-shifted into place, and arrives on "full".
//    Rows C .. Cpad-1 are zeroed once and never written.
// 3. Transpose on read: n-tile j's column g is tile column 32u + 4g + j
//    (j = 0..3, u the warp's group of 32 columns). Lane (g, t) reads one
//    32-bit word from each of rows 4q .. 4q+3 at byte 32u + 4g (lanes of
//    one g share the word, the 8 words are contiguous: no bank conflict);
//    transpose4 gives shard rows 4q .. 4q+3 of its column in each n-tile,
//    and plane_bits of planes t and 4 + t are the two s8 B registers
//    (m16n8k32 lane (g, t) holds K rows 4t .. 4t+3 and 16+4t .. 16+4t+3
//    of column g). Four n-tiles are four independent accumulator chains;
//    at one row tile (R <= 2) a warp takes two of its groups a pass, eight
//    chains on each W fragment it loads.
// 4. Repack: lane (g, t) of an accumulator holds rows g and g + 8 of a
//    16-row tile, bit g of output bytes 2i and 2i+1. For each accumulator
//    element a prmt gathers the four n-tiles' low bytes (four adjacent
//    columns), & 1 moves them to bit g and three __shfl_xor ORs gather the
//    8 planes, so lane t of g = 0 holds output columns 32u + 8t .. 32u +
//    8t + 7 of both rows: two 8-byte shared stores into one of two output
//    stages. After a barrier of the consumer warps the stage goes out with
//    16-byte stores while the next item computes into the other stage.
// 5. Cost: at R=2, C=12 a warp issues about 130 instructions per 32
//    columns, 87 of them integer (24 a K chunk for the transpose and
//    extraction: 8 prmt, 16 shift and mask; about 20 for the repack), on an
//    SM that retires 64 integer results a clock. With 4 consumer warps a
//    scheduler, their dependent chains (load, prmt, extraction, mma,
//    shuffles) bound it, not the bytes: the ring alone (bulk copies and
//    output stores, no compute) runs at 75% of the byte bound, 0.070 ms at
//    4 MiB x 4 stripes.
//
// Variants (template parameters, bit-identical to each other):
//   kExtract: kPerByte (C's int32, D's loop: shift and mask each byte),
//             kSwar (C's u8, D's bcast: one shift and mask of the 32-bit
//             word), kCmp (D's bool: __vcmpne4 of the word against the
//             plane's mask).
//   kProbe:   kNone (the GF apply); kNoDot (D's nodot: the same ring, read
//             and extraction of every B register, each kept live by an
//             empty asm, then no dot: byte i of a column gathers rows
//             8i .. 8i+7 of the reference's plane-major bits (row k*C + c)
//             from the raw stage); kNoExt (D's noext: the same ring, read
//             and dot, with every B register the byte x[0, j] broadcast as
//             int8, no extraction).
// Grid: the vmapped forms (per stripe) are one launch per stripe (B = 1);
// the flat forms (flatgrid, bm-flat) one launch over all stripes' items.
// The wrapper chooses; the kernel is the same.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * (kConsumerWarps + 1);  // + the producer warp
constexpr int kMaxStages = 3;
constexpr int kOutStages = 2;
constexpr int kBarrierBytes = 16 * kMaxStages;  // full and empty mbarriers
constexpr size_t kMaxSmem = 227 << 10;          // a block's opt-in limit on an H100

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
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// The first K chunk's product, on zero sums: no accumulator to clear.
__device__ __forceinline__ void mma_s8_first(int (&d)[4], const uint4& a, uint32_t b0,
                                             uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1), "r"(0), "r"(0), "r"(0),
        "r"(0));
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

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// bytes (a multiple of 16) from 16-byte aligned global src to shared dst,
// counted against the mbarrier's transaction bytes
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumerWarps) : "memory");
}

// Bytes sh .. sh+15 of the 32 bytes lo, hi: whole words by selects (an
// indexed array would live in local memory), the rest by funnel shifts.
__device__ __forceinline__ uint4 shift_out(uint4 lo, uint4 hi, int sh) {
  uint32_t v0 = lo.x, v1 = lo.y, v2 = lo.z, v3 = lo.w, v4 = hi.x, v5 = hi.y;
  if (sh & 8) { v0 = v2; v1 = v3; v2 = v4; v3 = v5; v4 = hi.z; v5 = hi.w; }
  if (sh & 4) { v0 = v1; v1 = v2; v2 = v3; v3 = v4; v4 = v5; }
  const int r = 8 * (sh & 3);
  return make_uint4(__funnelshift_r(v0, v1, r), __funnelshift_r(v1, v2, r),
                    __funnelshift_r(v2, v3, r), __funnelshift_r(v3, v4, r));
}

// The producer's own loads of one (C, cols) tile into a stage, where bulk
// copies cannot go (a row not 16-byte aligned). Piece k of a row, its
// bytes 16k .. 16k+15, comes out of the two aligned 16-byte words around
// it; a word is read only if it holds a byte of the row, and an aligned
// word that holds one lies inside the row's allocation. The lanes take
// the (row, piece) pairs in turn, four pieces a pass, so each lane has
// up to eight loads in flight. Columns past cols hold bytes never stored.
__device__ __forceinline__ void load_tile(uint8_t* dst, const uint8_t* src, long long S, int C,
                                          int T, int cols, int lane) {
  constexpr int kBatch = 4;
  const int pieces = (cols + 15) / 16;
  int c = 0, k = lane;  // this lane's next piece
  for (; k >= pieces; k -= pieces) ++c;
  while (c < C) {
    uint4 lo[kBatch], hi[kBatch];
    int sh[kBatch];
    uint8_t* d[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      d[b] = nullptr;
      if (c < C) {
        const uint8_t* p = src + c * S + 16 * k;
        sh[b] = (int)((uintptr_t)p & 15);
        const uint4* a = reinterpret_cast<const uint4*>(p - sh[b]);
        lo[b] = a[0];
        hi[b] = sh[b] && 16 * k + 16 - sh[b] < cols ? a[1] : make_uint4(0, 0, 0, 0);
        d[b] = dst + (size_t)c * T + 16 * k;
        for (k += 32; k >= pieces; k -= pieces) ++c;
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (d[b]) *reinterpret_cast<uint4*>(d[b]) = shift_out(lo[b], hi[b], sh[b]);
  }
}

// The B registers of K chunk q for the four n-tiles, from p = the word at
// byte 32u + 4g of shard row 4q: rows 4q .. 4q+3 transposed to columns
// 32u + 4g + j, planes t and 4 + t. noext reads the same words and takes
// its faked bits bx instead.
template <int kExtract, int kProbe>
__device__ __forceinline__ void b_regs(const uint32_t* p, int tw, int t,
                                       const uint32_t (&bx)[4], uint32_t (&b0)[4],
                                       uint32_t (&b1)[4]) {
  uint32_t x4[4];
  transpose4(p[0], p[tw], p[2 * tw], p[3 * tw], x4);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (kProbe == kNoExt) {
      asm volatile("" ::"r"(x4[j]));  // read like the apply, extract nothing
      b0[j] = b1[j] = bx[j];
    } else {
      b0[j] = plane_bits<kExtract>(x4[j], t);
      b1[j] = plane_bits<kExtract>(x4[j], 4 + t);
    }
  }
}

// kM row tiles of W (16 rows, output bytes 2i and 2i+1 each) for kG groups
// of 32 columns (this warp's group and, for kG = 2, its next one, 8 groups
// on): the dot over the n_kc K chunks, four n-tile accumulator chains a row
// tile and group, each W fragment loaded once for the kG groups, then the
// repack. a: this lane's fragment of the first row tile's chunk 0; d: the
// first group's output bytes 8t .. 8t+7 of row 2i.
// Lane (g, t) holds element e of n-tile j: row g + 8 (e / 2), column
// 2t + e % 2, which is bit g of output byte 2i + e / 2 at tile column
// 8t + 4 (e % 2) + j. So for each e a prmt gathers the four n-tiles' low
// bytes in column order, & 1 moves to bit g, and three shuffle-ORs gather
// the 8 bits: lane t of g = 0 then holds columns 8t .. 8t+7 of both rows.
template <int kExtract, int kProbe, int kM, int kG>
__device__ __forceinline__ void dot_rows(const uint32_t* words, int tw, const uint4* a, int n_kc,
                                         uint8_t* d, int T, int g, int t) {
  constexpr int kWordStep = 8 * kConsumerWarps, kByteStep = 32 * kConsumerWarps;
  int acc[kM][kG][4][4];
  uint32_t b0[kG][4], b1[kG][4], bx[kG][4] = {};
  if constexpr (kProbe == kNoExt) {  // x[0, column] as int8, in every K row
#pragma unroll
    for (int h = 0; h < kG; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bx[h][j] = ((words[h * kWordStep] >> (8 * j)) & 0xFFu) * 0x01010101u;
  }
#pragma unroll
  for (int h = 0; h < kG; ++h)
    b_regs<kExtract, kProbe>(words + h * kWordStep, tw, t, bx[h], b0[h], b1[h]);
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    const uint4 am = a[m * n_kc * 32];
#pragma unroll
    for (int h = 0; h < kG; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8_first(acc[m][h][j], am, b0[h][j], b1[h][j]);
  }
#pragma unroll 1
  for (int q = 1; q < n_kc; ++q) {
    words += 4 * tw;
    a += 32;
#pragma unroll
    for (int h = 0; h < kG; ++h)
      b_regs<kExtract, kProbe>(words + h * kWordStep, tw, t, bx[h], b0[h], b1[h]);
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const uint4 am = a[m * n_kc * 32];
#pragma unroll
      for (int h = 0; h < kG; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[m][h][j], am, b0[h][j], b1[h][j]);
    }
  }
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int h = 0; h < kG; ++h) {
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t lo =
            __byte_perm(__byte_perm(acc[m][h][0][e], acc[m][h][1][e], 0x0040),
                        __byte_perm(acc[m][h][2][e], acc[m][h][3][e], 0x0040), 0x5410);
        v[e] = (lo & 0x01010101u) << g;
      }
#pragma unroll
      for (int s = 4; s < 32; s <<= 1)
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] |= __shfl_xor_sync(0xFFFFFFFFu, v[e], s);
      if (g == 0) {
        uint8_t* dm = d + (size_t)(2 * m) * T + h * kByteStep;
        *reinterpret_cast<uint2*>(dm) = make_uint2(v[0], v[1]);
        *reinterpret_cast<uint2*>(dm + T) = make_uint2(v[2], v[3]);
      }
    }
}

// One warp's groups u = warp, warp + 8, ... below `groups` of one item:
// read, extract, dot and repack each group of 32 tile columns into the
// output stage os (Rpad, T).
template <int kExtract, int kProbe>
__device__ __forceinline__ void compute_item(const uint8_t* st, uint8_t* os, const uint4* a_frag,
                                             int warp, int groups, int T, int R, int C, int n_kc,
                                             int n_mt, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int tw = T / 4;  // 32-bit words per row
  const uint32_t* words = reinterpret_cast<const uint32_t*>(st) + 8 * warp + g;
  uint8_t* d = os + 32 * warp + 8 * t;
  const uint4* a = a_frag + lane;
  for (int u = warp; u < groups;
       u += kConsumerWarps, words += 8 * kConsumerWarps, d += 32 * kConsumerWarps) {
    if constexpr (kProbe == kNoDot) {
      for (int q = 0; q < n_kc; ++q) {
        const uint32_t* p = words + 4 * q * tw;
        uint32_t x4[4];
        transpose4(p[0], p[tw], p[2 * tw], p[3 * tw], x4);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t b0 = plane_bits<kExtract>(x4[j], t);
          const uint32_t b1 = plane_bits<kExtract>(x4[j], 4 + t);
          asm volatile("" ::"r"(b0), "r"(b1));  // extract every register, then drop it
        }
      }
      for (int i = t; i < R; i += 4) {  // byte i: reference rows 8i .. 8i+7
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = 32 * u + 4 * g + j;
          int k = 8 * i / C, c = 8 * i % C;
          uint32_t byte = 0;
          for (int b = 0; b < 8; ++b) {
            byte |= ((st[(size_t)c * T + col] >> k) & 1u) << b;
            if (++c == C) { c = 0; ++k; }
          }
          os[(size_t)i * T + col] = (uint8_t)byte;
        }
      }
    } else if (n_mt == 1 && u + kConsumerWarps < groups) {
      // One row tile (R <= 2): this group and the warp's next one in a pass.
      dot_rows<kExtract, kProbe, 1, 2>(words, tw, a, n_kc, d, T, g, t);
      u += kConsumerWarps;
      words += 8 * kConsumerWarps;
      d += 32 * kConsumerWarps;
    } else {
      // Two row tiles a pass share the B registers; an odd last one runs alone.
      int mt = 0;
      for (; mt + 2 <= n_mt; mt += 2)
        dot_rows<kExtract, kProbe, 2, 1>(words, tw, a + mt * n_kc * 32, n_kc, d + 2 * mt * T, T,
                                         g, t);
      if (mt < n_mt)
        dot_rows<kExtract, kProbe, 1, 1>(words, tw, a + mt * n_kc * 32, n_kc, d + 2 * mt * T, T,
                                         g, t);
    }
  }
}

// This block's work items blockIdx.x + k * gridDim.x as (stripe, tile),
// stepped without a 64-bit division per item.
struct Items {
  long long stripe, tile, step_s, step_t, n_tiles;
  __device__ explicit Items(long long n)
      : stripe(blockIdx.x / n), tile(blockIdx.x % n), step_s(gridDim.x / n),
        step_t(gridDim.x % n), n_tiles(n) {}
  __device__ void next() {
    stripe += step_s;
    tile += step_t;
    if (tile >= n_tiles) { tile -= n_tiles; ++stripe; }
  }
};

// The ring's stage s of the k-th item and the parity of its round.
struct Ring {
  int s = 0, phase = 0, stages;
  __device__ explicit Ring(int n) : stages(n) {}
  __device__ void next() {
    if (++s == stages) { s = 0; phase ^= 1; }
  }
};

template <int kExtract, int kProbe>
__global__ void __launch_bounds__(kThreads, 2)
gf_bitmajor_kernel(const uint8_t* __restrict__ in, long long in_stride,
                   uint8_t* __restrict__ out, const int8_t* __restrict__ w,
                   int R, int C, long long S, int B, int T, int stages, bool vec) {
  const int cpad = (C + 3) & ~3, rpad = (R + 1) & ~1;
  const int kdim = 8 * cpad, n_kc = cpad / 4, n_mt = rpad / 2;
  const long long n_tiles = (S + T - 1) / T;
  const size_t stage_bytes = (size_t)cpad * T;
  extern __shared__ __align__(16) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  uint4* a_frag = reinterpret_cast<uint4*>(smem + kBarrierBytes);   // n_mt * n_kc * 32
  uint8_t* ring = smem + kBarrierBytes + (size_t)n_mt * n_kc * 32 * 16;  // stages x (Cpad, T)
  uint8_t* ostage = ring + stages * stage_bytes;                       // 2 x (Rpad, T)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(shared_addr(full + s), vec ? 1 : 32);
      mbar_init(shared_addr(empty + s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // W in fragment order, once per block: entry (mt, q, lane) holds lane's
  // four A registers.
  if constexpr (kProbe != kNoDot) {
    for (int i = tid; i < n_mt * n_kc * 32; i += kThreads) {
      const int l = i & 31, q = (i >> 5) % n_kc, mt = (i >> 5) / n_kc;
      const int8_t* r0 = w + (long long)(16 * mt + (l >> 2)) * kdim + 32 * q + 4 * (l & 3);
      const int8_t* r1 = r0 + 8 * kdim;
      a_frag[i] = make_uint4(*reinterpret_cast<const uint32_t*>(r0),
                             *reinterpret_cast<const uint32_t*>(r1),
                             *reinterpret_cast<const uint32_t*>(r0 + 16),
                             *reinterpret_cast<const uint32_t*>(r1 + 16));
    }
  }
  const int pad_words = (cpad - C) * T / 4;  // rows C .. Cpad-1 of each stage
  for (int i = tid; i < stages * pad_words; i += kThreads)
    reinterpret_cast<uint32_t*>(ring + (i / pad_words) * stage_bytes + (size_t)C * T)[i % pad_words] = 0;
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer
    Ring ring_at(stages);
    for (Items it(n_tiles); it.stripe < B; it.next(), ring_at.next()) {
      const int s = ring_at.s;
      const long long col0 = it.tile * T;
      const uint8_t* src = in + it.stripe * in_stride + col0;
      uint8_t* dst = ring + s * stage_bytes;
      const int cols = S - col0 < T ? (int)(S - col0) : T;
      mbar_wait(shared_addr(empty + s), ring_at.phase ^ 1);
      if (vec) {
        if (lane == 0) mbar_arrive_expect_tx(shared_addr(full + s), (uint32_t)(C * cols));
        __syncwarp();
        for (int c = lane; c < C; c += 32)
          bulk_load(shared_addr(dst + (size_t)c * T), src + c * S, cols, shared_addr(full + s));
      } else {
        load_tile(dst, src, S, C, T, cols, lane);
        mbar_arrive(shared_addr(full + s));
      }
    }
    return;
  }

  Ring ring_at(stages);
  int o = 0;  // output stage
  for (Items it(n_tiles); it.stripe < B; it.next(), ring_at.next(), o ^= 1) {
    const int s = ring_at.s;
    const long long col0 = it.tile * T;
    const uint8_t* st = ring + s * stage_bytes;
    uint8_t* os = ostage + (size_t)o * rpad * T;
    const int cols = S - col0 < T ? (int)(S - col0) : T;
    mbar_wait(shared_addr(full + s), ring_at.phase);
    compute_item<kExtract, kProbe>(st, os, a_frag, warp, (cols + 31) / 32, T, R, C, n_kc, n_mt,
                                   lane);
    __syncwarp();
    if (lane == 0) mbar_arrive(shared_addr(empty + s));
    // every consumer's part of os is in; the other output stage's stores
    // (issued before this barrier) are done reading it
    consumers_sync();
    uint8_t* dst = out + it.stripe * R * S;
    for (int r = 0; r < R; ++r) {
      for (int ch = tid; ch < T / 16; ch += 32 * kConsumerWarps) {
        const long long col = col0 + 16 * ch;
        if (col >= S) break;
        const uint8_t* sp = os + (size_t)r * T + 16 * ch;
        uint8_t* d = dst + (long long)r * S + col;
        if (vec && col + 16 <= S) {
          *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(sp);
        } else {
          for (int j = 0; j < 16; ++j)
            if (col + j < S) d[j] = sp[j];
        }
      }
    }
  }
}

size_t smem_bytes(int R, int C, int T, int stages) {
  const int cpad = (C + 3) & ~3, rpad = (R + 1) & ~1;
  return kBarrierBytes + (size_t)(8 * rpad) * (8 * cpad) + (size_t)stages * cpad * T +
         (size_t)kOutStages * rpad * T;
}

// The ring's depth: 3 stages where they fit, else 2 (which may not fit:
// the launch then refuses).
int ring_stages(int R, int C, int T) {
  return smem_bytes(R, C, T, kMaxStages) <= kMaxSmem ? kMaxStages : 2;
}

template <int kExtract, int kProbe>
int blocks_per_sm(int R, int C, int T, size_t* smem_out) {
  const size_t smem = smem_bytes(R, C, T, ring_stages(R, C, T));
  if (smem > kMaxSmem) return -(int)cudaErrorInvalidValue;
  // Over the 48 KiB a block gets by default, opt in: the attribute belongs
  // to the current device, and setting it costs little.
  if (smem > (48 << 10)) {
    const cudaError_t e = cudaFuncSetAttribute(gf_bitmajor_kernel<kExtract, kProbe>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return -(int)e;
  }
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, gf_bitmajor_kernel<kExtract, kProbe>, kThreads, smem);
  if (e != cudaSuccess) return -(int)e;
  if (smem_out) *smem_out = smem;
  return n;
}

template <int kExtract, int kProbe>
int launch(const void* in, long long in_stride, void* out, const void* w, int R,
           int C, long long S, int B, int T, void* stream) {
  // The blocks the card holds at once and the shared memory depend only on
  // (device, R, C, T): kept for the last shape this thread launched, since
  // a sweep or a per-stripe grid launches one shape many times.
  struct Shape {
    int dev = -1, R, C, T;
    long long resident;
    size_t smem;
  };
  static thread_local Shape last;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev != last.dev || R != last.R || C != last.C || T != last.T) {
    size_t smem = 0;
    const int per_sm = blocks_per_sm<kExtract, kProbe>(R, C, T, &smem);
    if (per_sm < 0) return -per_sm;
    if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
    int sms = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    last = {dev, R, C, T, (long long)per_sm * sms, smem};
  }
  const long long items = (S + T - 1) / T * B;
  const unsigned grid = (unsigned)(items < last.resident ? items : last.resident);
  const bool vec = S % 16 == 0 && in_stride % 16 == 0 && (uintptr_t)in % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  gf_bitmajor_kernel<kExtract, kProbe><<<grid, kThreads, last.smem, (cudaStream_t)stream>>>(
      (const uint8_t*)in, in_stride, (uint8_t*)out, (const int8_t*)w, R, C, S, B, T,
      ring_stages(R, C, T), vec);
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

// Blocks of one variant an SM holds at (R, C, T): the persistent grid is
// this times the SMs. probe 0 is the apply. A negative value is a
// cudaError_t, negated.
extern "C" int gf_bitmajor_blocks_per_sm(int R, int C, int T, int extract, int probe) {
  if (bad_args(R, C, 1, 1, T)) return -(int)cudaErrorInvalidValue;
  if (probe == kNoExt) return blocks_per_sm<kSwar, kNoExt>(R, C, T, nullptr);
  const bool nodot = probe == kNoDot;
  if (probe != kNone && !nodot) return -(int)cudaErrorInvalidValue;
  switch (extract) {
    case kPerByte: return nodot ? blocks_per_sm<kPerByte, kNoDot>(R, C, T, nullptr)
                                : blocks_per_sm<kPerByte, kNone>(R, C, T, nullptr);
    case kSwar: return nodot ? blocks_per_sm<kSwar, kNoDot>(R, C, T, nullptr)
                             : blocks_per_sm<kSwar, kNone>(R, C, T, nullptr);
    case kCmp: return nodot ? blocks_per_sm<kCmp, kNoDot>(R, C, T, nullptr)
                            : blocks_per_sm<kCmp, kNone>(R, C, T, nullptr);
  }
  return -(int)cudaErrorInvalidValue;
}

extern "C" const char* gf_bitmajor_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
