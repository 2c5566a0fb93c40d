// K1 — fused GF(2) Reed-Solomon product on raw bytes, for Hopper (sm_90a).
//
// Replaces the TPU kernel of the reference package,
// src/repro/kernels/gf2mm/gf2mm.py::gf2_rs_matmul_bytes (kernel body
// _rs_bytes_kernel). Same function, bytes in and bytes out:
//
//   out[b, i, c] = XOR_t  gf256_mul(mats[b, i, t], data[b, t, c])
//
// given through the GF(2) expansion bitmats (batch, 8m, 8k) of the per-item
// coding matrices: bit j of output byte row i is the parity of
//   sum_{t, q} bitmats[b, 8i + j, 8t + q] * bit_q(data[b, t, c])
// (LSB-first bitplanes; a bitmats entry counts by its lowest bit, as the
// TPU kernel's exact bf16 products reduced mod 2 do).
//
// What bounds it on this card: bytes. Every data byte is read once and
// every output byte written once; at the main path's decode shape (batch 32,
// k 6, m bucket 8, B 524,288) that is ~235 MB, ~70 us at 3.35 TB/s, while
// the same work as a 0/1 int8 product is ~1.0e11 operations, ~52 us at
// 1,979 TOP/s.
//
// Design. The TPU kernel unpacks bitplanes and runs a 0/1 matmul on the MXU.
// Here the product is done bit-sliced in the integer pipe instead, with the
// unpack and repack folded away: the block packs its tile of bitmats into
// shared memory as one byte per (bit-row r, input byte t) — the 8 columns
// 8t..8t+7 — and each thread owns 16 adjacent columns as four uint32 words.
// For each input row t it loads its 16 data bytes once (one 16-byte load on
// the aligned path) and, for each bit-row r, accumulates
//   acc_r ^= (mask[r][t] * 0x01010101) & d
// (one LOP3 per word). The parity of each byte lane of acc_r is bit r of the
// output byte; eight bit-rows are ORed into one output word and stored with
// one 16-byte store. Nothing but the input and the output touches device
// memory, and the data tile is re-read per output row from L1. The kernel
// masks the ragged edge of B itself (byte-wise loads and stores on the last
// partial group of columns, or everywhere when B or a pointer is not 16-byte
// aligned). The tensor-core form (int8 mma with int32 accumulation) is left
// for later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWords = 4;                              // uint32 words per thread
constexpr int kColsPerThread = kWords * 4;             // 16 columns
constexpr int kColsPerBlock = kThreads * kColsPerThread;  // 4096
constexpr int kRowsPerBlock = 8;                       // output byte rows = 64 bit-rows

// Parity of each byte lane of a, in bit 0 of that lane.
__device__ __forceinline__ uint32_t lane_parity(uint32_t a) {
  a ^= a >> 4;
  a ^= a >> 2;
  a ^= a >> 1;
  return a & 0x01010101u;
}

__global__ void __launch_bounds__(kThreads)
gf2_rs_bytes_kernel(const uint8_t* __restrict__ bitmats,
                    const uint8_t* __restrict__ data,
                    uint8_t* __restrict__ out,
                    int m8, int k, long long B, int aligned) {
  // mask[r * k + t], bit q = lowest bit of bitmats[item, row0 + r, 8t + q].
  extern __shared__ uint8_t mask[];
  const int item = blockIdx.z;
  const int m = m8 >> 3;
  const int orow0 = blockIdx.y * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, m - orow0);
  const long long k8 = 8LL * k;
  const uint8_t* bm = bitmats + ((long long)item * m8 + 8LL * orow0) * k8;
  for (int idx = threadIdx.x; idx < rows * 8 * k; idx += kThreads) {
    const int r = idx / k;
    const int t = idx - r * k;
    const uint8_t* src = bm + r * k8 + 8 * t;
    uint32_t v = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) v |= (uint32_t)(src[q] & 1u) << q;
    mask[idx] = (uint8_t)v;
  }
  __syncthreads();

  const long long col0 =
      (long long)blockIdx.x * kColsPerBlock + (long long)threadIdx.x * kColsPerThread;
  if (col0 >= B) return;
  const bool full = aligned && (col0 + kColsPerThread <= B);
  const uint8_t* dp = data + (long long)item * k * B + col0;
  uint8_t* op = out + ((long long)item * m + orow0) * B + col0;

  for (int i = 0; i < rows; ++i) {
    uint32_t acc[8][kWords];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int w = 0; w < kWords; ++w) acc[r][w] = 0u;
    const uint8_t* mrow = mask + i * 8 * k;
    for (int t = 0; t < k; ++t) {
      const uint8_t* src = dp + (long long)t * B;
      uint32_t d[kWords];
      if (full) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
        d[0] = v.x;
        d[1] = v.y;
        d[2] = v.z;
        d[3] = v.w;
      } else {
#pragma unroll
        for (int w = 0; w < kWords; ++w) d[w] = 0u;
        for (int c = 0; c < kColsPerThread && col0 + c < B; ++c)
          d[c >> 2] |= (uint32_t)src[c] << (8 * (c & 3));
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const uint32_t mk = (uint32_t)mrow[r * k + t] * 0x01010101u;
#pragma unroll
        for (int w = 0; w < kWords; ++w) acc[r][w] ^= mk & d[w];
      }
    }
    uint32_t o[kWords];
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      o[w] = 0u;
#pragma unroll
      for (int r = 0; r < 8; ++r) o[w] |= lane_parity(acc[r][w]) << r;
    }
    uint8_t* dst = op + (long long)i * B;
    if (full) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
    } else {
      for (int c = 0; c < kColsPerThread && col0 + c < B; ++c)
        dst[c] = (uint8_t)(o[c >> 2] >> (8 * (c & 3)));
    }
  }
}

}  // namespace

// Launches K1 on `stream` for contiguous uint8 tensors bitmats (batch, m8, 8k),
// data (batch, k, B) and out (batch, m8 / 8, B). The caller checks shapes.
// Returns cudaGetLastError() after the launch: 0 when it was accepted.
extern "C" int gf2_rs_bytes_launch(const void* bitmats, const void* data, void* out,
                                   int batch, int m8, int k, long long B, void* stream) {
  if (batch == 0 || m8 == 0 || B == 0) return 0;
  const int m = m8 / 8;
  const int aligned = (B % 16 == 0) && ((uintptr_t)data % 16 == 0) &&
                      ((uintptr_t)out % 16 == 0);
  const dim3 grid((unsigned)((B + kColsPerBlock - 1) / kColsPerBlock),
                  (unsigned)((m + kRowsPerBlock - 1) / kRowsPerBlock), (unsigned)batch);
  const size_t smem = (size_t)kRowsPerBlock * 8 * k;
  gf2_rs_bytes_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(bitmats), static_cast<const uint8_t*>(data),
      static_cast<uint8_t*>(out), m8, k, B, aligned);
  return (int)cudaGetLastError();
}
