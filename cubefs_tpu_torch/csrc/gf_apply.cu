// GF(2^8) matrix times shards on Hopper:
//   out[b, r, s] = XOR over c of coeff[r, c] * in[b, c, s]
// in (B, C, S) uint8 (stripe stride given, rows contiguous); out (B, R, S)
// uint8 with its own stripe and row strides (bytes contiguous), so parity
// lands straight in the parity rows of the stripes that hold the data;
// products (R, C, 8) uint32 on the device, entry [r, c, k] holding
// coeff[r, c] * 2^k in each of its four bytes (gf_cuda.swar_table).
//
// Replaces cubefs_tpu/ops/pallas_gf.py:_kernel (launched by _apply_fn for
// gf_matrix_apply_pallas): the TPU kernel unpacks each (C, T) byte tile to
// plane-major bits and runs an int8 (8R, 8C) bit-matrix dot on the MXU.
//
// Bound on this card: device-memory bytes, (C + R) * S * B read or written
// once at 3.35 TB/s. What stands between a GF apply and that bound on
// Hopper is integer throughput: an SM retires 64 32-bit integer results a
// clock (LOP3, shifts, PRMT and IMAD alike), half its float rate, so at
// 1.8 GHz the card does about 15 T integer operations a second, 4.5 for
// every byte it can read. Split-nibble tables took about 10 of them per
// byte per output row (extract, two dependent shared-memory lookups,
// reinsert).
//
// Design: SWAR bit masks. Multiplying by a constant a is GF(2)-linear,
// a * x = XOR over k of bit_k(x) * (a * 2^k). For each word of 4 input
// bytes the kernel builds the 8 byte masks m_k (0xFF in each byte whose
// bit k is set) once, for all output rows: a left shift by 7 - k puts bit
// k in each byte's top bit, and prmt's sign-replicate mode spreads it over
// the byte (2 operations). Each (row, coefficient) pair then costs 8
// updates acc ^= m_k & P[r][c][k], one LOP3 each. The products, 32 bytes
// per coefficient (R * C * 32 bytes, as the nibble tables were), are
// copied into shared memory per block and read as warp-uniform 16-byte
// broadcasts, so the coefficient matrix stays a runtime argument and a
// new erasure pattern compiles nothing. Each thread owns 16 contiguous
// bytes of one stripe, loads them as one 16-byte vector per input row
// (the next row's vector is loaded before the current one is folded in)
// and keeps 4 output rows in registers: every repair and RS(12+4) encode
// has R <= 4, so each input byte leaves device memory once; a larger R
// re-reads the input from L2 and rebuilds the masks once per further
// group of 4 rows. Per input byte that is about 4 + 2R integer operations
// up to R = 4 (12 at R = 4, C = 12: 0.16 ms of the card's integer rate
// for the repair shape, B = 4, against 0.08 ms of bytes) and 3R above
// (108 at 36 x 36), and no per-byte shared-memory lookup. The ragged tail
// of S is masked byte by byte, with no padding to a tile; when S, a
// stride or a base pointer is not 16-byte aligned the whole launch takes
// the byte-load path.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBytesPerThread = 16;
constexpr int kRowTile = 4;  // output rows a thread keeps in registers

// 0xFF in each byte whose top bit is set, 0 elsewhere.
__device__ __forceinline__ uint32_t spread_top_bits(uint32_t x) {
  uint32_t r;
  // selector nibbles 8..11: bytes 0..3, bit 3 set = replicate the byte's sign
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(x), "r"(0u), "r"(0xBA98u));
  return r;
}

template <bool kVec>
__device__ __forceinline__ void load16(const uint8_t* p, int n, uint32_t w[4]) {
  if (kVec) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = 0;
#pragma unroll
    for (int i = 0; i < kBytesPerThread; ++i)
      if (i < n) w[i >> 2] |= (uint32_t)p[i] << (8 * (i & 3));
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gf_apply_kernel(const uint8_t* __restrict__ in, long long in_stride, uint8_t* __restrict__ out,
                long long out_stride, long long out_row_stride,
                const uint4* __restrict__ products, int R, int C, long long S) {
  extern __shared__ uint4 prod[];  // [R * C][2]: a * 2^k, k = 0..7, 4 bytes each
  const int n_prod = R * C * 2;
  for (int i = threadIdx.x; i < n_prod; i += kThreads) prod[i] = products[i];
  __syncthreads();

  const long long s0 =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * kBytesPerThread;
  if (s0 >= S) return;
  const uint8_t* src = in + (long long)blockIdx.y * in_stride + s0;
  uint8_t* dst = out + (long long)blockIdx.y * out_stride + s0;
  const long long left = S - s0;
  const int n = left < kBytesPerThread ? (int)left : kBytesPerThread;

  for (int r0 = 0; r0 < R; r0 += kRowTile) {
    uint32_t acc[kRowTile][4];
#pragma unroll
    for (int t = 0; t < kRowTile; ++t)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[t][j] = 0;

    uint32_t w[4];
    load16<kVec>(src, n, w);
    for (int c = 0; c < C; ++c) {
      uint32_t next[4] = {0, 0, 0, 0};
      if (c + 1 < C) load16<kVec>(src + (long long)(c + 1) * S, n, next);
      uint32_t m[4][8];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < 8; ++k) m[j][k] = spread_top_bits(w[j] << (7 - k));
#pragma unroll
      for (int t = 0; t < kRowTile; ++t) {
        if (r0 + t >= R) break;
        const uint4* pp = prod + ((r0 + t) * C + c) * 2;
        const uint4 lo = pp[0], hi = pp[1];
        const uint32_t p[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[t][j] ^= m[j][k] & p[k];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = next[j];
    }

#pragma unroll
    for (int t = 0; t < kRowTile; ++t) {
      if (r0 + t >= R) break;
      uint8_t* q = dst + (long long)(r0 + t) * out_row_stride;
      if (kVec) {
        *reinterpret_cast<uint4*>(q) =
            make_uint4(acc[t][0], acc[t][1], acc[t][2], acc[t][3]);
      } else {
#pragma unroll
        for (int i = 0; i < kBytesPerThread; ++i)
          if (i < n) q[i] = (uint8_t)(acc[t][i >> 2] >> (8 * (i & 3)));
      }
    }
  }
}

template <bool kVec>
void launch(dim3 grid, size_t smem, cudaStream_t st, const uint8_t* x, long long in_stride,
            uint8_t* y, long long out_stride, long long out_row_stride, const uint4* p, int R,
            int C, long long S) {
  gf_apply_kernel<kVec><<<grid, kThreads, smem, st>>>(
      x, in_stride, y, out_stride, out_row_stride, p, R, C, S);
}

}  // namespace

extern "C" int gf_apply_launch(const void* in, long long in_stride, void* out,
                               long long out_stride, long long out_row_stride,
                               const void* products, int R, int C, long long S, int B,
                               void* stream) {
  if (B <= 0 || S <= 0 || R <= 0) return 0;
  const long long per_block = (long long)kThreads * kBytesPerThread;
  const dim3 grid((unsigned)((S + per_block - 1) / per_block), (unsigned)B);
  const size_t smem = (size_t)R * C * 32;
  const bool vec = ((uintptr_t)in | (uintptr_t)out | (uintptr_t)S | (uintptr_t)in_stride |
                    (uintptr_t)out_stride | (uintptr_t)out_row_stride) % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* x = (const uint8_t*)in;
  uint8_t* y = (uint8_t*)out;
  const uint4* p = (const uint4*)products;
  if (vec)
    launch<true>(grid, smem, st, x, in_stride, y, out_stride, out_row_stride, p, R, C, S);
  else
    launch<false>(grid, smem, st, x, in_stride, y, out_stride, out_row_stride, p, R, C, S);
  return (int)cudaGetLastError();
}

extern "C" const char* gf_apply_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
