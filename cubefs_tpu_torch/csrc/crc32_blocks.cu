// Batched CRC32 (IEEE, bit-identical to zlib.crc32) of equal-length blocks:
//   out[i * inner + j] = crc32(in[i, j, 0:block_len]),
//   block_len = n_chunks * chunk_len
// in (outer, inner, block_len) uint8 with byte strides (outer_stride,
// inner_stride, 1), so strided views (a frame's payloads past their CRC
// words, some rows of a stripe) are read in place; out (outer * inner,)
// uint32 zeroed by the caller.
//
// Replaces cubefs_tpu/ops/pallas_crc.py:_crc_kernel (launched by _parts_fn
// for crc32_blocks_pallas) together with its jnp epilogue _fold_fn: the TPU
// kernel computes each chunk's raw CRC bits as an int8 (TB, 8L) @ (8L, 32)
// dot on the MXU, and the fold moves each chunk CRC to the end of its block
// with zero-extension matrices and XORs them.
//
// Bound on this card: device-memory bytes, B * block_len read once (the
// output is 4 bytes a block). Per byte the kernel does one shared-memory
// lookup and a few integer operations.
//
// Design: one thread per chunk of chunk_len bytes. The CRC is affine in
// the message, so the chunks of a block are independent: each thread runs
// the reflected byte-table CRC (256-word table in shared memory, init 0, no
// final XOR) over its own chunk, which cuts the serial dependency from
// block_len bytes to chunk_len. It then moves its raw CRC to the end of the
// block with the 32 x 32 matrix A^((n_chunks - 1 - k) * chunk_len), passed
// as 32 column masks per chunk position k, and XORs the result into the
// block's word with atomicXor: XOR commutes, so the order of the atomics
// does not change a bit. The k = 0 thread also XORs in crc32 of block_len
// zero bytes, the affine part, so no second pass is needed. Loads are
// 16-byte vectors when chunk_len, the base and both strides are 16-byte
// aligned, single bytes otherwise (the blob framing's 65,532-byte payloads
// give chunk_len = 762, and start 4 bytes into their block).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kPolyReflected = 0xEDB88320u;

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
crc32_chunks_kernel(const uint8_t* __restrict__ in, long long outer_stride, int inner,
                    long long inner_stride, uint32_t* __restrict__ out,
                    const uint32_t* __restrict__ shift_cols, uint32_t zeros_crc,
                    long long total_chunks, int n_chunks, int chunk_len) {
  __shared__ uint32_t table[256];
  for (int i = threadIdx.x; i < 256; i += kThreads) {
    uint32_t c = (uint32_t)i;
#pragma unroll
    for (int k = 0; k < 8; ++k) c = (c >> 1) ^ ((c & 1) ? kPolyReflected : 0u);
    table[i] = c;
  }
  __syncthreads();

  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= total_chunks) return;
  const long long blk = g / n_chunks;
  const int k = (int)(g - blk * n_chunks);
  const long long i = blk / inner;
  const uint8_t* p = in + i * outer_stride + (blk - i * inner) * inner_stride +
                     (long long)k * chunk_len;

  uint32_t crc = 0;
  if (kVec) {
    const uint4* v = reinterpret_cast<const uint4*>(p);
    for (int i = 0; i < chunk_len / 16; ++i) {
      const uint4 q = v[i];
      const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          crc = (crc >> 8) ^ table[(crc ^ (w[j] >> (8 * b))) & 0xFF];
    }
  } else {
    for (int i = 0; i < chunk_len; ++i)
      crc = (crc >> 8) ^ table[(crc ^ p[i]) & 0xFF];
  }

  const uint32_t* cols = shift_cols + (long long)k * 32;
  uint32_t moved = k == 0 ? zeros_crc : 0u;
#pragma unroll
  for (int i = 0; i < 32; ++i)
    if ((crc >> i) & 1) moved ^= cols[i];
  atomicXor(out + blk, moved);
}

}  // namespace

extern "C" int crc32_blocks_launch(const void* in, int outer, int inner,
                                   long long outer_stride, long long inner_stride,
                                   void* out, const void* shift_cols,
                                   unsigned int zeros_crc, int n_chunks, int chunk_len,
                                   void* stream) {
  if (outer <= 0 || inner <= 0 || n_chunks <= 0) return 0;
  const long long total = (long long)outer * inner * n_chunks;
  const unsigned grid = (unsigned)((total + kThreads - 1) / kThreads);
  const bool vec = chunk_len % 16 == 0 && (uintptr_t)in % 16 == 0 &&
                   outer_stride % 16 == 0 && inner_stride % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* x = (const uint8_t*)in;
  uint32_t* y = (uint32_t*)out;
  const uint32_t* cols = (const uint32_t*)shift_cols;
  if (vec)
    crc32_chunks_kernel<true><<<grid, kThreads, 0, st>>>(
        x, outer_stride, inner, inner_stride, y, cols, zeros_crc, total, n_chunks, chunk_len);
  else
    crc32_chunks_kernel<false><<<grid, kThreads, 0, st>>>(
        x, outer_stride, inner, inner_stride, y, cols, zeros_crc, total, n_chunks, chunk_len);
  return (int)cudaGetLastError();
}

extern "C" const char* crc32_blocks_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
