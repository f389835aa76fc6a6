// GF(2^8) matrix times shards on Hopper:
//   out[b, r, s] = XOR over c of coeff[r, c] * in[b, c, s]
// in (B, C, S) uint8 (stripe stride given, rows contiguous), coeff (R, C)
// uint8 on the device, out (B, R, S) uint8 contiguous.
//
// Replaces cubefs_tpu/ops/pallas_gf.py:_kernel (launched by _apply_fn for
// gf_matrix_apply_pallas): the TPU kernel unpacks each (C, T) byte tile to
// plane-major bits and runs an int8 (8R, 8C) bit-matrix dot on the MXU.
//
// Bound on this card: device-memory bytes. Each input byte is read once and
// each output byte written once, (C + R) * S * B bytes at 3.35 TB/s; the work
// per byte is two table lookups and an XOR per output row, below the rate
// of the card's integer units at the shapes the codec uses (R <= 4).
//
// Design: split-nibble tables, the GPU form of the reference CPU engine's
// nibble shuffles. GF multiply distributes over XOR, so
// a * x = lo[x & 15] ^ hi[x >> 4] with lo[i] = a * i and hi[i] = a * (i << 4).
// Each block builds both 16-entry tables for every (r, c) in shared memory
// (R * C * 32 bytes, 41,472 at 36 x 36) from the coefficient matrix, which
// is a runtime argument: a new erasure pattern costs a table build per
// block, not a recompilation as on the TPU. A table of 16 bytes spans four
// banks, so a warp's lookups broadcast and never conflict. Each thread owns
// 16 contiguous bytes of one stripe, loads them as one 16-byte vector per
// input row and keeps kRowTile output rows of accumulators in registers:
// with R <= kRowTile (every repair and RS(12+4) encode) each input byte
// leaves device memory once; larger R re-reads the input from L2 once per
// further group of rows. The ragged tail of S is masked byte by byte, with
// no padding to a tile; when S or a base pointer is not 16-byte aligned the
// whole launch takes the byte-load path.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBytesPerThread = 16;
constexpr int kRowTile = 4;

__device__ __forceinline__ uint8_t gf_mul(uint8_t a, uint8_t b) {
  uint8_t p = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (b & 1) p ^= a;
    b >>= 1;
    a = (uint8_t)((a << 1) ^ ((a & 0x80) ? 0x1D : 0));  // reduce by 0x11D
  }
  return p;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gf_apply_kernel(const uint8_t* __restrict__ in, long long in_stride,
                uint8_t* __restrict__ out, const uint8_t* __restrict__ coeff,
                int R, int C, long long S) {
  extern __shared__ uint8_t tab[];  // [R * C][lo 16 | hi 16]
  const int n_tab = R * C * 32;
  for (int i = threadIdx.x; i < n_tab; i += kThreads) {
    const int k = i & 31;
    const uint8_t x = k < 16 ? (uint8_t)k : (uint8_t)((k - 16) << 4);
    tab[i] = gf_mul(coeff[i >> 5], x);
  }
  __syncthreads();

  const long long s0 =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * kBytesPerThread;
  if (s0 >= S) return;
  const uint8_t* src = in + (long long)blockIdx.y * in_stride + s0;
  uint8_t* dst = out + (long long)blockIdx.y * R * S + s0;
  const long long left = S - s0;
  const int n = left < kBytesPerThread ? (int)left : kBytesPerThread;

  for (int r0 = 0; r0 < R; r0 += kRowTile) {
    uint32_t acc[kRowTile][4];
#pragma unroll
    for (int t = 0; t < kRowTile; ++t)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[t][j] = 0;

    for (int c = 0; c < C; ++c) {
      const uint8_t* p = src + (long long)c * S;
      uint32_t w[4];
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
#pragma unroll
      for (int t = 0; t < kRowTile; ++t) {
        if (r0 + t >= R) break;
        const uint8_t* lo = tab + ((r0 + t) * C + c) * 32;
        const uint8_t* hi = lo + 16;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t y = 0;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const uint32_t b = (w[j] >> (8 * k)) & 0xFF;
            y |= (uint32_t)(lo[b & 15] ^ hi[b >> 4]) << (8 * k);
          }
          acc[t][j] ^= y;
        }
      }
    }

#pragma unroll
    for (int t = 0; t < kRowTile; ++t) {
      if (r0 + t >= R) break;
      uint8_t* q = dst + (long long)(r0 + t) * S;
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

}  // namespace

extern "C" int gf_apply_launch(const void* in, long long in_stride, void* out,
                               const void* coeff, int R, int C, long long S,
                               int B, void* stream) {
  if (B <= 0 || S <= 0 || R <= 0) return 0;
  const long long per_block = (long long)kThreads * kBytesPerThread;
  const dim3 grid((unsigned)((S + per_block - 1) / per_block), (unsigned)B);
  const size_t smem = (size_t)R * C * 32;
  const bool vec = S % 16 == 0 && in_stride % 16 == 0 &&
                   (uintptr_t)in % 16 == 0 && (uintptr_t)out % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* x = (const uint8_t*)in;
  uint8_t* y = (uint8_t*)out;
  const uint8_t* m = (const uint8_t*)coeff;
  if (vec)
    gf_apply_kernel<true><<<grid, kThreads, smem, st>>>(x, in_stride, y, m, R, C, S);
  else
    gf_apply_kernel<false><<<grid, kThreads, smem, st>>>(x, in_stride, y, m, R, C, S);
  return (int)cudaGetLastError();
}

extern "C" const char* gf_apply_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
