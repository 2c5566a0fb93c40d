// K1 — fused GF(2) Reed-Solomon product on raw bytes, on Hopper's int8
// tensor cores (sm_90a).
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
// What bounds it on this card. At the main path's decode shape (batch 32,
// k 6, m bucket 8, B 524,288) every data byte is read once and every output
// byte written once: ~235 MB, 70 us at 3.35 TB/s; the same work as a 0/1
// int8 product is ~1.0e11 operations, 52 us at 1,979 TOP/s. The earlier
// bit-sliced form (masked XOR of byte lanes and a parity fold, ~30 integer
// ops per output byte) was bound by the integer pipe. Here the products run
// on the tensor cores, and the unpack and repack are a few integer ops per
// output byte in registers. What is left is not the bytes: the time of the
// mma.sync phase and of the integer work add up instead of overlapping
// (k1_ablation.py, PERF.md).
//
// Design, k <= 8 (the whole main path). One warp computes 8 output byte rows
// x 64 columns per step with mma.sync m16n8k32 (and m16n8k16 for a remainder
// of 2 data rows) .row.col.s32.u8.u8.s32; B's bit-columns k = 8t + q.
// - A: the item's bit-matrix, rows paired and weighted, in registers for the
//   block's life. mma row 16*mt + 8*h + g holds output bits pi and pi + 4
//   (pi = 2*mt + h) of byte row g, as (bitmats[8g + pi] & 1) +
//   128 * (bitmats[8g + pi + 4] & 1). Two m-tiles cover the 8 rows, so lane
//   (g = lane / 4, l4 = lane % 4) holds all 8 bits of byte row g for columns
//   2*l4 and 2*l4 + 1 in the 8 accumulators of one n-tile. With B's lanes
//   exactly 0/1 a row's sum is at most 8k <= 64: bits 0..6 hold the first
//   count and bit 7 up the second, so bit 0 and bit 7 are the two parities.
//   At most 16 A words a lane (k = 8: 2 m-tiles x 2 k32 steps x 4), staged
//   once per block through shared memory.
// - B from the raw bytes, in registers: lane (g, l4) holds B rows
//   k = 4*l4 .. 4*l4 + 3 (and + 16) of column g, one nibble of one data
//   byte per register, ((d >> q0) & 0xF) * 0x00204081 & 0x01010101 putting
//   bit q0 + i in byte lane i.
// - Epilogue: y = sum over pi of (acc_pi & 0x81) << pi holds output bits
//   0..3 at 0..3 and 4..7 at 7..10; two columns' y go into one word and one
//   shift and mask close the gap; prmt packs the bytes.
// - Columns permuted so each lane's output is one 16-byte store: logical
//   (n-tile j, column 2*l4 + e) is physical column 16*l4 + 2*j + e of the
//   warp's 64. The B lane of column g then reads byte 2*j + (g % 2) of the
//   16-byte chunk at column 16*(g / 2): one 16-byte __ldg per data row it
//   needs (rows of one parity, 4 lanes share a chunk), reused by all 8
//   n-tiles and prefetched one warp step ahead.
// k > 8 (up to 256, off the main path) takes a general path: sums reach
// 2,048, so rows are not paired; mma row 16*mt + 8*h + g holds bit-row
// 8*g + j, j = 2*mt + h, weighted (bitmats & 1) << j, so accumulator j
// carries its parity at bit j with zeros below and B's lanes may carry
// anything above bit 0 (sums stay below 2^31: 2,048 products of 128 x 255);
// the epilogue is one AND-OR per accumulator. A's fragments come per k32
// step from a shared tile of the permuted, weighted rows (dynamic shared
// memory, 64 x (8k rounded up to 32, + 16) bytes).
// Edges, nothing padded in device memory: rows past m are zero in A and
// their stores are skipped; data rows past k are zero columns of A and are
// never read; a chunk past B is zero and its store skipped. Where
// B % 16 != 0 or the data or out pointer is not 16-byte aligned, loads and
// stores go byte by byte.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                               // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kWarpCols = 64;                               // 8 n-tiles of 8 columns
constexpr int kIters = 8;                                   // warp steps per block
constexpr int kBlockCols = kWarps * kIters * kWarpCols;     // 4096
constexpr int kRowGroup = 8;                                // output byte rows a block
constexpr uint32_t kSpread = 0x00204081u;

__device__ __forceinline__ void mma_k32(int (&c)[4], const uint32_t* a, uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_k16(int (&c)[4], const uint32_t* a, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

// The 16 bytes of one data row at column c, as 4 little-endian words; zero
// past B.
template <bool kVec>
__device__ __forceinline__ void load_chunk(uint32_t (&w)[4], const uint8_t* __restrict__ row,
                                           long long c, long long B) {
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = 0u;
  if (kVec) {  // B % 16 == 0: a chunk lies wholly inside or outside B
    if (c < B) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + c));
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (c + j < B) w[j >> 2] |= (uint32_t)__ldg(row + c + j) << (8 * (j & 3));
  }
}

// A lane's chunks at column c: chunk r is data row 2r + p (zero for rows
// past KT, or everywhere when !on).
template <int KT, bool kVec, int NR>
__device__ __forceinline__ void load_rows(uint32_t (&w)[NR][4], const uint8_t* __restrict__ drow,
                                          int p, long long c, long long B, bool on) {
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    if (on && 2 * r + p < KT) {
      load_chunk<kVec>(w[r], drow + (long long)(2 * r + p) * B, c, B);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) w[r][i] = 0u;
    }
  }
}

// B register of n-tile j from a chunk pre-shifted by 8*(g % 2) + 4*(l4 % 2):
// the nibble of byte 2j + (g % 2), spread to bit 0 of four byte lanes (the
// lanes' upper bits hold anything; the general path's weights allow it).
__device__ __forceinline__ uint32_t b_frag(const uint32_t (&ws)[4], int j) {
  return ((ws[j >> 1] >> (16 * (j & 1))) & 0xFu) * kSpread;
}

// General path: folds n-tile j's 16 accumulators (accumulator j carries
// its parity at bit j) into output bytes 2j, 2j + 1 of o.
__device__ __forceinline__ void epilogue_bits(const int (&acc)[4][4], int j, uint32_t (&o)[4]) {
  uint32_t v[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    v[e] = 0u;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        v[e] |= (uint32_t)acc[mt][2 * h + e] & (1u << (2 * mt + h));
  }
  const uint32_t pair = __byte_perm(v[0], v[1], 0x0040);
  o[j >> 1] = (j & 1) ? __byte_perm(o[j >> 1], pair, 0x5410) : pair;
}

// One lane's 16 output bytes: row pointer dst at column c; nothing past B.
template <bool kVec>
__device__ __forceinline__ void store_chunk(uint8_t* __restrict__ dst, const uint32_t (&o)[4],
                                            long long c, long long B) {
  if (kVec) {
    if (c < B) *reinterpret_cast<uint4*>(dst + c) = make_uint4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (c + j < B) dst[c + j] = (uint8_t)(o[j >> 2] >> (8 * (j & 3)));
  }
}

// General path: A's weighted, lowest-bit word for bit-matrix row j of
// output byte row orow, bit-columns kk0 .. kk0 + 3 (zero past k8 and for
// orow >= m).
__device__ __forceinline__ uint32_t a_word(const uint8_t* __restrict__ bm, int m, int k8,
                                           int orow, int j, int kk0) {
  uint32_t w = 0u;
  if (orow < m) {
    const uint8_t* src = bm + ((long long)8 * orow + j) * k8;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (kk0 + i < k8) w |= (((uint32_t)src[kk0 + i] & 1u) << j) << (8 * i);
  }
  return w;
}

// Register path: A's word for the paired rows pi (weight 1) and pi + 4
// (weight 128) of output byte row orow, bit-columns kk0 .. kk0 + 3 (zero
// past k8 and for orow >= m).
__device__ __forceinline__ uint32_t a_pair_word(const uint8_t* __restrict__ bm, int m, int k8,
                                                int orow, int pi, int kk0) {
  uint32_t w = 0u;
  if (orow < m) {
    const uint8_t* lo = bm + ((long long)8 * orow + pi) * k8;
    const uint8_t* hi = lo + 4LL * k8;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (kk0 + i < k8)
        w |= (((uint32_t)lo[kk0 + i] & 1u) | (((uint32_t)hi[kk0 + i] & 1u) << 7)) << (8 * i);
  }
  return w;
}

// Register path: b_frag with every byte lane exactly 0 or 1.
__device__ __forceinline__ uint32_t b_clean(const uint32_t (&ws)[4], int j) {
  return (((ws[j >> 1] >> (16 * (j & 1))) & 0xFu) * kSpread) & 0x01010101u;
}

// Register path: folds n-tile j's 8 accumulators (bit 0: output bit pi,
// bit 7: output bit pi + 4) into output bytes 2j, 2j + 1 of o.
__device__ __forceinline__ void epilogue_pairs(const int (&acc)[2][4], int j, uint32_t (&o)[4]) {
  uint32_t y[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    y[e] = 0u;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        y[e] += ((uint32_t)acc[mt][2 * h + e] & 0x81u) << (2 * mt + h);
  }
  const uint32_t w2 = y[0] | (y[1] << 16);
  const uint32_t z = (w2 & 0x000F000Fu) | ((w2 >> 3) & 0x00F000F0u);
  o[j >> 1] = (j & 1) ? __byte_perm(o[j >> 1], z, 0x6410) : __byte_perm(z, 0u, 0x0020);
}

// k <= 8: A's paired rows held in registers for the whole block.
// Steps: S32 k32 steps of 4 data rows (the last one short when k % 4 == 3)
// and S16 k16 steps of 2 (k % 4 in {1, 2}). A lane reads data rows of one
// parity, p = l4 / 2: chunk r holds row 2r + p.
template <int KT, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
k1_regs_kernel(const uint8_t* __restrict__ bitmats, const uint8_t* __restrict__ data,
               uint8_t* __restrict__ out, int m, long long B) {
  constexpr int S32 = KT / 4 + (KT % 4 == 3);
  constexpr int S16 = (KT % 4 == 1 || KT % 4 == 2);
  constexpr int RPM = 4 * S32 + 2 * S16;  // A words of one m-tile
  constexpr int NR = (KT + 1) / 2;        // data rows a lane reads
  __shared__ uint32_t afrag[2 * RPM * 32];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, l4 = lane & 3, p = l4 >> 1;
  const int item = blockIdx.z, rg = blockIdx.y;
  const uint8_t* bm = bitmats + (long long)item * (8 * m) * (8 * KT);

  for (int idx = threadIdx.x; idx < 2 * RPM * 32; idx += kThreads) {
    const int ln = idx & 31, q = idx >> 5;
    const int mt = q / RPM, r = q % RPM;
    const int lg = ln >> 2, ll4 = ln & 3;
    int h, kk0;
    if (r < 4 * S32) {
      h = r & 1;
      kk0 = 32 * (r >> 2) + 16 * ((r >> 1) & 1) + 4 * ll4;
    } else {
      h = r - 4 * S32;
      kk0 = 32 * S32 + 4 * ll4;
    }
    afrag[idx] = a_pair_word(bm, m, 8 * KT, kRowGroup * rg + lg, 2 * mt + h, kk0);
  }
  __syncthreads();
  uint32_t a[2][RPM];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int r = 0; r < RPM; ++r) a[mt][r] = afrag[(mt * RPM + r) * 32 + lane];

  const int orow = kRowGroup * rg + g;
  const uint8_t* drow = data + (long long)item * KT * B;
  uint8_t* orow_ptr = out + ((long long)item * m + min(orow, m - 1)) * B;
  const int sh = 8 * (g & 1) + 4 * (l4 & 1);
  const long long cb = (long long)blockIdx.x * kBlockCols + (long long)warp * kWarpCols;

  uint32_t w[NR][4];
  load_rows<KT, kVec>(w, drow, p, cb + 16 * (g >> 1), B, true);
#pragma unroll 1
  for (int it = 0; it < kIters; ++it) {
    const long long c0 = cb + (long long)it * kWarps * kWarpCols;
    if (c0 >= B) break;
    const long long cn = c0 + kWarps * kWarpCols;
    const bool more = it + 1 < kIters && cn < B;
    uint32_t wn[NR][4];  // the next warp step's chunks, in flight during this one
    load_rows<KT, kVec>(wn, drow, p, cn + 16 * (g >> 1), B, more);
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) w[r][i] >>= sh;

    uint32_t o[4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int acc[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][e] = 0;
#pragma unroll
      for (int s = 0; s < S32; ++s) {
        const uint32_t b0 = b_clean(w[2 * s], j);
        const uint32_t b1 = b_clean(w[2 * s + 1], j);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_k32(acc[mt], &a[mt][4 * s], b0, b1);
      }
      if (S16) {
        const uint32_t b0 = b_clean(w[2 * S32], j);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_k16(acc[mt], &a[mt][4 * S32], b0);
      }
      epilogue_pairs(acc, j, o);
    }
    if (orow < m) store_chunk<kVec>(orow_ptr, o, c0 + 16 * l4, B);
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) w[r][i] = wn[r][i];
  }
}

// k > 8: A's permuted, weighted rows in a shared tile [64][stride], read
// per k32 step; B's chunks loaded per step and n-tile (L1 serves repeats).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
k1_general_kernel(const uint8_t* __restrict__ bitmats, const uint8_t* __restrict__ data,
                  uint8_t* __restrict__ out, int m, int k, long long B) {
  extern __shared__ __align__(16) uint8_t sa[];
  const int steps = (k + 3) / 4;
  const int stride = 32 * steps + 16;  // bytes; an odd multiple of 4 words: no bank conflicts
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, l4 = lane & 3, p = l4 >> 1;
  const int item = blockIdx.z, rg = blockIdx.y;
  const int k8 = 8 * k;
  const uint8_t* bm = bitmats + (long long)item * (8 * m) * k8;

  for (int idx = threadIdx.x; idx < 64 * 8 * steps; idx += kThreads) {
    const int row = idx / (8 * steps), kq = idx % (8 * steps);
    const int mt = row >> 4, h = (row >> 3) & 1, lg = row & 7;
    *reinterpret_cast<uint32_t*>(sa + row * stride + 4 * kq) =
        a_word(bm, m, k8, kRowGroup * rg + lg, 2 * mt + h, 4 * kq);
  }
  __syncthreads();

  const int orow = kRowGroup * rg + g;
  const uint8_t* drow = data + (long long)item * k * B;
  uint8_t* orow_ptr = out + ((long long)item * m + min(orow, m - 1)) * B;
  const int sh = 8 * (g & 1) + 4 * (l4 & 1);
  for (int it = 0; it < kIters; ++it) {
    const long long c0 =
        (long long)blockIdx.x * kBlockCols + (long long)(it * kWarps + warp) * kWarpCols;
    if (c0 >= B) break;
    const long long cl = c0 + 16 * (g >> 1);
    uint32_t o[4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int acc[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][e] = 0;
      for (int s = 0; s < steps; ++s) {
        uint32_t bw[2][4], bf[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int t = 4 * s + 2 * r + p;
#pragma unroll
          for (int i = 0; i < 4; ++i) bw[r][i] = 0u;
          if (t < k) load_chunk<kVec>(bw[r], drow + (long long)t * B, cl, B);
#pragma unroll
          for (int i = 0; i < 4; ++i) bw[r][i] >>= sh;
          bf[r] = b_frag(bw[r], j);
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          uint32_t af[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            af[r] = *reinterpret_cast<const uint32_t*>(
                sa + (16 * mt + 8 * (r & 1) + g) * stride + 32 * s + 16 * (r >> 1) + 4 * l4);
          mma_k32(acc[mt], af, bf[0], bf[1]);
        }
      }
      epilogue_bits(acc, j, o);
    }
    if (orow < m) store_chunk<kVec>(orow_ptr, o, c0 + 16 * l4, B);
  }
}

template <int KT, bool kVec>
int launch_regs(const void* bitmats, const void* data, void* out, int m, long long B, dim3 grid,
                cudaStream_t stream) {
  k1_regs_kernel<KT, kVec><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(bitmats), static_cast<const uint8_t*>(data),
      static_cast<uint8_t*>(out), m, B);
  return (int)cudaGetLastError();
}

template <bool kVec>
int launch_k(const void* bitmats, const void* data, void* out, int m, int k, long long B,
             dim3 grid, cudaStream_t stream) {
  switch (k) {
    case 1: return launch_regs<1, kVec>(bitmats, data, out, m, B, grid, stream);
    case 2: return launch_regs<2, kVec>(bitmats, data, out, m, B, grid, stream);
    case 3: return launch_regs<3, kVec>(bitmats, data, out, m, B, grid, stream);
    case 4: return launch_regs<4, kVec>(bitmats, data, out, m, B, grid, stream);
    case 5: return launch_regs<5, kVec>(bitmats, data, out, m, B, grid, stream);
    case 6: return launch_regs<6, kVec>(bitmats, data, out, m, B, grid, stream);
    case 7: return launch_regs<7, kVec>(bitmats, data, out, m, B, grid, stream);
    case 8: return launch_regs<8, kVec>(bitmats, data, out, m, B, grid, stream);
    default: break;
  }
  const size_t smem = (size_t)64 * (32 * ((k + 3) / 4) + 16);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        k1_general_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  k1_general_kernel<kVec><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(bitmats), static_cast<const uint8_t*>(data),
      static_cast<uint8_t*>(out), m, k, B);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches K1 on `stream` for contiguous uint8 tensors bitmats (batch, m8, 8k),
// data (batch, k, B) and out (batch, m8 / 8, B); the caller checks shapes
// (batch <= 65535, k <= 256; k = 0 writes zeros). The grid is
// (B / 4096, m / 8, batch), rounded up. The 16-byte paths run where B % 16 == 0 and data and out are
// 16-byte aligned; byte-wise loads and stores take the rest.
// Returns cudaGetLastError() after the launch: 0 when it was accepted.
extern "C" int gf2_rs_bytes_launch(const void* bitmats, const void* data, void* out,
                                   int batch, int m8, int k, long long B, void* stream) {
  if (batch == 0 || m8 == 0 || B == 0) return 0;
  const int m = m8 / 8;
  if (k == 0)  // an empty XOR: zero rows
    return (int)cudaMemsetAsync(out, 0, (size_t)batch * m * B, (cudaStream_t)stream);
  if (k < 0 || k > 256) return (int)cudaErrorInvalidValue;
  const bool vec = (B % 16 == 0) && ((uintptr_t)data % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const dim3 grid((unsigned)((B + kBlockCols - 1) / kBlockCols),
                  (unsigned)((m + kRowGroup - 1) / kRowGroup), (unsigned)batch);
  auto s = (cudaStream_t)stream;
  return vec ? launch_k<true>(bitmats, data, out, m, k, B, grid, s)
             : launch_k<false>(bitmats, data, out, m, k, B, grid, s);
}
