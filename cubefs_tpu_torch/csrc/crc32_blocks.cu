// Batched CRC32 (IEEE, bit-identical to zlib.crc32) of equal-length blocks:
//   out[i * inner + j] = crc32(in[i, j, 0:block_len])
// in (outer, inner, block_len) uint8 with byte strides (outer_stride,
// inner_stride, 1), so strided views (a frame's payloads past their CRC
// words, some rows of a stripe) are read in place; out (outer * inner,)
// 64-bit words zeroed by the caller, each left holding its block's unsigned
// CRC (the int64 the wrapper returns, with no widening pass).
//
// Replaces cubefs_tpu/ops/pallas_crc.py:_crc_kernel (launched by _parts_fn
// for crc32_blocks_pallas) together with its jnp epilogue _fold_fn: the TPU
// kernel computes each chunk's raw CRC bits as an int8 (TB, 8L) @ (8L, 32)
// dot on the MXU, and the fold moves each chunk CRC to the end of its block
// with zero-extension matrices and XORs them.
//
// Bound on this card: device-memory bytes, B * block_len read once at
// 3.35 TB/s (the output is 4 bytes a block). What stands between a CRC and
// that bound on a GPU is the serial chain of one table lookup per byte, the
// lookups' shared-memory bank conflicts and uncoalesced loads; the design
// removes all three.
//
// Design. The raw CRC (init 0, no final XOR) is linear in the message,
// and crc32(m) = raw(m) ^ crc32(0^len). A warp owns a span of 1024 * rows
// bytes of one block (rows <= 8: 8 KiB spans, so 8 x 4 MiB gives 4096
// warps, 131,072 lanes). Lane l reads the 32-byte pieces at span offsets
// 32 l + 1024 i as two 16-byte loads: each load instruction of the warp
// covers 1 KiB in 16-byte steps that L1 merges, and the next row's piece is
// loaded before the current one is folded in, 1 KiB a warp in flight. Per
// piece the lane updates its raw CRC state
//   s = A^1024 s ^ raw(piece),
// A^1024 moving the state across its 32 bytes and the other lanes' 992
// (leading zeros do not change a raw CRC), so no lane waits on another.
// Both terms are table lookups by 5-bit field: raw(piece) is the XOR of 52
// entries, one per 5 bits of its 256 (a field that straddles two words is
// joined by one funnel shift), and A^1024 s of 7 more. A 32-word table
// spans the 32 banks, so a warp's lookups into one table never conflict:
// 59 conflict-free lookups, 59 shift/mask pairs and about 30 three-input
// XORs per 32 bytes, 1.84 lookups and about 4.6 ALU operations a byte,
// against one dependent, 3.5-way conflicted lookup a byte with a 256-word
// table, or 2.5 lookups with nibble tables. The tables, 11.4 KiB with
// the lane columns below, are built on the host once and copied to shared
// memory per block.
// Fold in two levels: each lane's state moves to the span end by
// A^(32 (31 - l)) (32 column masks per lane, bit-major in shared memory,
// conflict-free), the warp XORs its lanes with __shfl_xor_sync, then lane i
// applies column i of the span's own shift A^(1024 rows (n_spans - 1 - s))
// (n_spans x 32 masks in device memory, resident in L2), the warp XORs
// again, and lane 0 adds the result to the block's word with one atomicXor
// per span; span 0 adds crc32(0^block_len), the affine part, once.
// Spans are laid out from the END of the block: the first span starts up
// to 1024 * rows - 1 bytes before the block, and those bytes read as
// zeros, so any block length takes the same path with no correction at
// the end. Loads are 16-byte vectors when the end of the first block and
// both strides are multiples of 16 (every shard the codec CRCs, and the
// blob framing's 65,532-byte payloads, which start 4 bytes into their
// 64 KiB block and end on its end), the one vector that straddles a
// block's start masked; single bytes otherwise. Warps walk (block, span)
// items in a grid-stride loop over as many blocks as fit on the card at
// once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRow = 1024;  // bytes a warp reads per row; a lane's stride
constexpr int kPiece = 32;  // bytes a lane reads per row
// shared-memory layout of the tables (uint32 words), 32 entries a table
constexpr int kData = 0;         // 52 tables: raw CRC of a piece, by 5-bit field
constexpr int kGap = 52 * 32;    // 7 tables: A^1024, by 5-bit field
constexpr int kLaneCols = kGap + 7 * 32;  // [bit][lane] 32 x 32: A^(32 (31 - lane))
constexpr int kTables = kLaneCols + 32 * 32;

// XOR of one table entry per 5-bit field of the kWords little-endian words.
template <int kFields, int kWords>
__device__ __forceinline__ uint32_t lookup_fields(const uint32_t* t, const uint32_t (&w)[kWords]) {
  uint32_t r = 0;
#pragma unroll
  for (int f = 0; f < kFields; ++f) {
    const int q = 5 * f / 32, o = 5 * f % 32;
    const uint32_t bits =
        (o <= 27 || q + 1 >= kWords) ? w[q] >> o : __funnelshift_r(w[q], w[q + 1], o);
    r ^= t[f * 32 + (bits & 31)];
  }
  return r;
}

// Zero the bytes of a word loaded at block offset o that lie before the
// block (o < 0).
__device__ __forceinline__ uint32_t drop_before_block(uint32_t w, long long o) {
  return o >= 0 ? w : o <= -4 ? 0u : w & (0xffffffffu << (8 * (int)-o));
}

// The 32 bytes at block offset off; bytes before the block read as zeros.
// off + 32 <= block_len always, since spans end at the block's end, and
// vector loads are aligned to the block's END: a 16-byte load that
// straddles the block's start lies in the aligned unit that holds its
// first byte, so it stays inside the allocation and is masked.
template <bool kVec>
__device__ __forceinline__ void load_piece(const uint8_t* __restrict__ p, long long off,
                                           uint32_t (&w)[8]) {
  if (kVec) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long o = off + 16 * h;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (o > -16) v = *reinterpret_cast<const uint4*>(p + o);
      w[4 * h] = v.x; w[4 * h + 1] = v.y; w[4 * h + 2] = v.z; w[4 * h + 3] = v.w;
      if (o < 0)
#pragma unroll
        for (int q = 0; q < 4; ++q) w[4 * h + q] = drop_before_block(w[4 * h + q], o + 4 * q);
    }
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      w[q] = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (off + 4 * q + b >= 0) w[q] |= (uint32_t)p[off + 4 * q + b] << (8 * b);
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
crc32_span_kernel(const uint8_t* __restrict__ in, long long outer_stride, int inner,
                  long long inner_stride, unsigned long long* __restrict__ out,
                  const uint32_t* __restrict__ tables, const uint32_t* __restrict__ span_cols,
                  uint32_t zeros_crc, long long block_len, int rows, int n_spans,
                  long long n_items) {
  __shared__ uint32_t tab[kTables];
  for (int i = threadIdx.x; i < kTables; i += kThreads) tab[i] = tables[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long span_len = (long long)kRow * rows;
  const long long first = block_len - n_spans * span_len;  // <= 0
  for (long long item = (long long)blockIdx.x * kWarps + threadIdx.x / 32; item < n_items;
       item += (long long)gridDim.x * kWarps) {
    const long long blk = item / n_spans;
    const int s = (int)(item - blk * n_spans);
    const long long i = blk / inner;
    const uint8_t* p = in + i * outer_stride + (blk - i * inner) * inner_stride;
    long long off = first + s * span_len + kPiece * lane;

    uint32_t crc = 0, w[8];
    load_piece<kVec>(p, off, w);
    for (int r = 0; r < rows; ++r) {
      uint32_t next[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (r + 1 < rows) load_piece<kVec>(p, off + kRow, next);
      const uint32_t state[1] = {crc};
      crc = lookup_fields<7>(tab + kGap, state) ^ lookup_fields<52>(tab + kData, w);
#pragma unroll
      for (int q = 0; q < 8; ++q) w[q] = next[q];
      off += kRow;
    }

    uint32_t moved = 0;  // lane -> span end
#pragma unroll
    for (int b = 0; b < 32; ++b)
      moved ^= tab[kLaneCols + b * 32 + lane] & (0u - ((crc >> b) & 1u));
#pragma unroll
    for (int d = 16; d; d >>= 1) moved ^= __shfl_xor_sync(0xffffffffu, moved, d);
    // span -> block end: lane b applies column b
    uint32_t part = span_cols[(long long)s * 32 + lane] & (0u - ((moved >> lane) & 1u));
    if (s == 0 && lane == 0) part ^= zeros_crc;
#pragma unroll
    for (int d = 16; d; d >>= 1) part ^= __shfl_xor_sync(0xffffffffu, part, d);
    if (lane == 0) atomicXor(out + blk, (unsigned long long)part);
  }
}

// Blocks of the kernel resident on the card at once, asked once per
// process (the port runs on one kind of card).
template <bool kVec>
cudaError_t resident_blocks(long long* n) {
  static long long cached = 0;
  if (!cached) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, crc32_span_kernel<kVec>,
                                                        kThreads, 0);
    if (e != cudaSuccess) return e;
    cached = (long long)sms * (per_sm > 0 ? per_sm : 1);
  }
  *n = cached;
  return cudaSuccess;
}

template <bool kVec>
cudaError_t launch(const uint8_t* x, long long outer_stride, int inner, long long inner_stride,
                   unsigned long long* y, const uint32_t* tables, const uint32_t* cols,
                   uint32_t zeros_crc, long long block_len, int rows, int n_spans,
                   long long n_items, cudaStream_t st) {
  long long fit = 0;
  const cudaError_t e = resident_blocks<kVec>(&fit);
  if (e != cudaSuccess) return e;
  const long long want = (n_items + kWarps - 1) / kWarps;
  const unsigned grid = (unsigned)(want < fit ? want : fit);
  crc32_span_kernel<kVec><<<grid, kThreads, 0, st>>>(x, outer_stride, inner, inner_stride, y,
                                                     tables, cols, zeros_crc, block_len, rows,
                                                     n_spans, n_items);
  return cudaGetLastError();
}

}  // namespace

extern "C" int crc32_blocks_launch(const void* in, int outer, int inner,
                                   long long outer_stride, long long inner_stride, void* out,
                                   const void* tables, const void* span_cols,
                                   unsigned int zeros_crc, long long block_len, int rows,
                                   int n_spans, void* stream) {
  if (outer <= 0 || inner <= 0 || block_len <= 0 || rows <= 0 || n_spans <= 0) return 0;
  if ((long long)n_spans * kRow * rows < block_len) return (int)cudaErrorInvalidValue;
  const long long n_items = (long long)outer * inner * n_spans;
  // every piece lies a multiple of 32 bytes before its block's end
  const uintptr_t align =
      ((uintptr_t)in + (uintptr_t)block_len) | (uintptr_t)outer_stride | (uintptr_t)inner_stride;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* x = (const uint8_t*)in;
  unsigned long long* y = (unsigned long long*)out;
  const uint32_t* t = (const uint32_t*)tables;
  const uint32_t* c = (const uint32_t*)span_cols;
  return (int)(align % 16 == 0
                   ? launch<true>(x, outer_stride, inner, inner_stride, y, t, c, zeros_crc,
                                  block_len, rows, n_spans, n_items, st)
                   : launch<false>(x, outer_stride, inner, inner_stride, y, t, c, zeros_crc,
                                   block_len, rows, n_spans, n_items, st));
}

extern "C" const char* crc32_blocks_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
