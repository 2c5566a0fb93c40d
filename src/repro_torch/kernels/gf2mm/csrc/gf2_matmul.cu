// K2 — (A @ B) mod 2 for 0/1 matrices, for Hopper (sm_90a).
//
// Replaces the TPU kernel of the reference package,
// src/repro/kernels/gf2mm/gf2mm.py::gf2_matmul (kernel body _gf2mm_kernel),
// the classic bit-matrix encode C2[8(n-k), B] = G2[8(n-k), 8k] @ D2[8k, B]
// mod 2 on bitplanes the caller packs and unpacks:
//
//   out[i, j] = XOR_t ( a[i, t] & b[t, j] ) & 1
//
// for uint8 A (M, K) and B (K, N). Each entry counts by its lowest bit, which
// is the exact mod-2 value of the integer product for any integer input (the
// wrapper casts other dtypes to uint8 first).
//
// What bounds it on this card. At the encode shape (48, 48) @ (48, 524,288)
// the function moves ~50 MB (each operand read once, the output written
// once): ~15 us at 3.35 TB/s, against ~1 us for its 2.4e9 operations at the
// int8 peak — bytes. At (1024, 1024) @ (1024, 65,536) it is 1.4e11
// operations, ~69 us at 1,979 TOP/s, against ~40 us for 135 MB — operations.
//
// Design. The TPU kernel feeds bf16 copies of both tiles to the MXU and
// takes the float sum mod 2 in the epilogue. Here the product runs in the
// integer pipe on byte lanes instead, exact by construction: a thread owns
// 8 output rows by 16 adjacent columns, held as 8 x 4 uint32 words (one
// byte lane per column). The block packs its 64 rows of A, one k-tile of
// 1,024 at a time, into shared memory as bits (k = 32w + j at bit 31 - j of
// word w), so one word serves 32 values of k. For each k a thread loads its
// 16 bytes of row k of B once (one 16-byte load on the aligned path; the 8
// warps of a block read the same row, so 7 of 8 loads hit L1) and, for each
// of its rows, turns the next bit of A into an all-ones or all-zeros mask
// (arithmetic shift of the word's sign bit) and folds
//   acc ^= mask & b      (one LOP3 per word).
// The lowest bit of each byte lane of acc is the output. Blocks walk the
// row blocks fastest, so the blocks that share a strip of B columns run
// together and B streams from device memory about once. The kernel masks
// its ragged edges itself (rows past M and k past K pack as zero bits;
// columns past N, or any row when N or a pointer is not 16-byte aligned,
// take byte-wise loads and stores) and pads nothing in device memory. The
// tensor-core form (int8 mma with int32 accumulation), or bits packed along
// N as well, is left for later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColThreads = 32;                              // one warp along N
constexpr int kRowThreads = kThreads / kColThreads;          // 8 warps along M
constexpr int kWords = 4;                                    // uint32 words a thread holds per row
constexpr int kColsPerThread = kWords * 4;                   // 16 columns
constexpr int kColsPerBlock = kColThreads * kColsPerThread;  // 512
constexpr int kRowsPerThread = 8;
constexpr int kRowsPerBlock = kRowThreads * kRowsPerThread;  // 64
constexpr int kTileK = 1024;                                 // k per shared-memory tile
constexpr int kTileWords = kTileK / 32;

__global__ void __launch_bounds__(kThreads)
gf2_matmul_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                  uint8_t* __restrict__ out, int M, int K, long long N, int row_blocks,
                  int aligned) {
  // abits[r][w], bit 31 - j = lowest bit of a[row0 + r, k0 + 32w + j].
  __shared__ uint32_t abits[kRowsPerBlock][kTileWords];
  const int tx = threadIdx.x % kColThreads;
  const int ty = threadIdx.x / kColThreads;
  const int row0 = (blockIdx.x % row_blocks) * kRowsPerBlock;
  const long long col0 = (long long)(blockIdx.x / row_blocks) * kColsPerBlock +
                         (long long)tx * kColsPerThread;
  const int trow0 = row0 + ty * kRowsPerThread;  // this thread's first row
  const bool active = trow0 < M && col0 < N;
  const bool full = aligned && col0 + kColsPerThread <= N;

  uint32_t acc[kRowsPerThread][kWords];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
    for (int w = 0; w < kWords; ++w) acc[r][w] = 0u;

  for (int k0 = 0; k0 < K; k0 += kTileK) {
    const int kt = min(kTileK, K - k0);
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = threadIdx.x; idx < kRowsPerBlock * kTileWords; idx += kThreads) {
      const int r = idx / kTileWords;
      const int w = idx - r * kTileWords;
      const int nk = min(32, kt - 32 * w);
      uint32_t v = 0u;
      if (row0 + r < M && nk > 0) {
        const uint8_t* src = a + (long long)(row0 + r) * K + k0 + 32 * w;
        for (int j = 0; j < nk; ++j) v |= (uint32_t)(src[j] & 1u) << (31 - j);
      }
      abits[r][w] = v;
    }
    __syncthreads();
    if (!active) continue;
    for (int w = 0; 32 * w < kt; ++w) {
      uint32_t am[kRowsPerThread];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) am[r] = abits[ty * kRowsPerThread + r][w];
      const int nk = min(32, kt - 32 * w);
      const uint8_t* src = b + (long long)(k0 + 32 * w) * N + col0;
#pragma unroll 4
      for (int j = 0; j < nk; ++j, src += N) {
        uint32_t d[kWords];
        if (full) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
          d[0] = v.x;
          d[1] = v.y;
          d[2] = v.z;
          d[3] = v.w;
        } else {  // constant indices after unrolling keep d in registers
#pragma unroll
          for (int q = 0; q < kWords; ++q) d[q] = 0u;
#pragma unroll
          for (int c = 0; c < kColsPerThread; ++c)
            if (col0 + c < N) d[c >> 2] |= (uint32_t)src[c] << (8 * (c & 3));
        }
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
          const uint32_t mask = (uint32_t)((int32_t)am[r] >> 31);
          am[r] <<= 1;
#pragma unroll
          for (int q = 0; q < kWords; ++q) acc[r][q] ^= mask & d[q];
        }
      }
    }
  }
  if (!active) return;

#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    if (trow0 + r >= M) break;
    uint8_t* dst = out + (long long)(trow0 + r) * N + col0;
    uint32_t o[kWords];
#pragma unroll
    for (int q = 0; q < kWords; ++q) o[q] = acc[r][q] & 0x01010101u;
    if (full) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c)
        if (col0 + c < N) dst[c] = (uint8_t)(o[c >> 2] >> (8 * (c & 3)));
    }
  }
}

}  // namespace

// Launches K2 on `stream` for contiguous uint8 tensors a (M, K), b (K, N) and
// out (M, N); the caller checks shapes. The 1-D grid holds one block per
// (64-row, 512-column) output tile, row tiles fastest.
// Returns cudaGetLastError() after the launch: 0 when it was accepted.
extern "C" int gf2_matmul_launch(const void* a, const void* b, void* out, int M, int K,
                                 long long N, void* stream) {
  if (M == 0 || N == 0) return 0;
  const int aligned = (N % 16 == 0) && ((uintptr_t)b % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const int row_blocks = (M + kRowsPerBlock - 1) / kRowsPerBlock;
  const long long col_blocks = (N + kColsPerBlock - 1) / kColsPerBlock;
  const long long blocks = (long long)row_blocks * col_blocks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  gf2_matmul_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
      static_cast<uint8_t*>(out), M, K, N, row_blocks, aligned);
  return (int)cudaGetLastError();
}
