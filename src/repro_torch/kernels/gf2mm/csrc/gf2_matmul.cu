// K2 — (A @ B) mod 2 on Hopper's int8 tensor cores (sm_90a).
//
// Replaces the TPU kernel of the reference package,
// src/repro/kernels/gf2mm/gf2mm.py::gf2_matmul (:77; kernel body
// _gf2mm_kernel, :60-74), the classic bit-matrix encode
// C2[8(n-k), B] = G2[8(n-k), 8k] @ D2[8k, B] mod 2 on bitplanes the caller
// packs and unpacks:
//
//   out[i, j] = ( sum_t (a[i, t] & 1) * (b[t, j] & 1) ) & 1
//
// for uint8 A (M, K) and B (K, N). Each entry counts by its lowest bit, which
// is the exact mod-2 value of the integer product for any integer input (the
// wrapper casts other dtypes to uint8 first). The TPU kernel takes the same
// value as the lowest bit of a float32 sum of bf16 products.
//
// What bounds it on this card. At the encode shape (48, 48) @ (48, 524,288)
// the function moves ~50 MB (each operand read once, the output written
// once): 0.0150 ms at 3.35 TB/s, against ~1 us for its 2.4e9 operations at
// the int8 peak — bytes. At (1024, 1024) @ (1024, 65,536) it is 1.4e11
// operations, 0.0694 ms at 1,979 TOP/s, against ~40 us for 135 MB —
// operations.
//
// Design.
// - Tensor cores: mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 on 0/1
//   bytes with s32 accumulators. Each sum is at most K, so it is exact for
//   any K < 2^31; the epilogue keeps acc & 1.
// - Lowest bit: every operand word is masked with & 0x01010101 — B's in
//   registers during the transpose, before they enter shared memory; A's
//   fragment registers after ldmatrix, since cp.async copies raw bytes.
// - K-major shared tiles. 8-bit mma.sync takes both operands K-major. A
//   (M, K) row-major already is; B (K, N) is not, so a thread loads 16-byte
//   words from 4 consecutive k-rows of the B tile (4 rows x 16 columns),
//   transposes its four 4x4 byte blocks in registers with __byte_perm (prmt,
//   8 per block) and stores 16 words into the [n][k] tile. Both tiles are
//   [128][128] bytes whose row r keeps its 16-byte chunk c at chunk
//   c ^ ((r ^ (r >> 4)) & 7): ldmatrix (8 rows of one chunk), the transposed
//   32-bit stores (16 rows apart) and cp.async are all free of bank conflicts.
//   Fragments come from ldmatrix.x4 (no .trans: it has no 8-bit form).
// - Overlap: A tiles come in by 16-byte cp.async, double-buffered. B passes
//   through registers, one k-tile ahead: the loads of tile t+1 are issued
//   before the mma loop of tile t and stored to shared memory after it.
// - Tiles: a 128 x 128 output block, k-tiles of 128, 8 warps as 2 (M) x 4
//   (N) with a 64 x 32 warp tile (4 x 4 mma tiles, 64 s32 accumulators a
//   thread). Shared memory: two A stages and one B tile, 16 KB each, 48 KB
//   static; A's stage 0 stages the output block in the epilogue, so the
//   stores are 16 bytes wide and coalesced. __launch_bounds__(256, 2) caps
//   ptxas at 128 registers, so two blocks fit on an SM; the [build] K2
//   ptxas lines of chip_smoke.py print registers, spills and shared memory
//   (PERF.md keeps them).
// - Grid: 1-D, row tiles fastest, so the blocks that share a strip of B
//   run together and the strip comes from L2, not device memory, after its
//   first read. At the encode shape M = 48 fills one row tile; warps whose
//   rows all lie past M skip the mma loop.
// - Ragged edges are masked in the kernel and nothing is padded in device
//   memory: rows past M and k past K are zero in shared memory (cp.async
//   zero-fill, or zero words), columns past N are zero on load and their
//   stores are skipped. Where K % 16 != 0 or A's pointer is not 16-byte
//   aligned, A takes a byte-wise load path; where N % 16 != 0 or B's or
//   out's pointer is not, B and out do. K = 0 writes zeros.
//
// What holds it back (k2_ablation.py, PERF.md): the mma phase alone
// (ldmatrix, mask, mma.sync) takes about two thirds of the time at
// (1024, 1024) @ (1024, 65,536) and the loads and transposes about a
// third, and the two barely overlap: every k-tile passes two block-wide
// barriers, and the same warps load, transpose and issue the mma. At the
// encode shape the global loads of B dominate.
//
// Left for a wgmma/TMA version: warpgroup mma from shared-memory
// descriptors (this K-major swizzled layout is what it reads), TMA loads
// with an mbarrier ring of several stages, a producer warp that keeps them
// in flight while the consumers compute, persistent blocks and clusters
// that share a strip of B.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                         // 8 warps
constexpr int kBM = 128, kBN = 128, kBK = 128;        // output block, k-tile
constexpr int kWM = 2, kWN = 4;                       // warps along M and N
constexpr int kWarpM = kBM / kWM, kWarpN = kBN / kWN;  // warp tile, 64 x 32
constexpr int kMT = kWarpM / 16, kNT = kWarpN / 8;    // m16 and n8 mma tiles a warp
constexpr int kATile = kBM * kBK, kBTile = kBN * kBK;  // 16 KB each
constexpr uint32_t kLowBits = 0x01010101u;

// Byte offset of 16-byte chunk `chunk` of row `r` in a swizzled tile.
__device__ __forceinline__ int tile_off(int r, int chunk) {
  return r * kBK + ((chunk ^ ((r ^ (r >> 4)) & 7)) << 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from src to shared dst; the bytes past src_bytes are zero.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_u8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A's k-tile `k0` into the shared tile dst: thread chunks tid + 256p, row
// idx / 8, chunk idx % 8; rows past M and k past K are zero.
template <bool kFastA>
__device__ __forceinline__ void load_a(uint8_t* dst, const uint8_t* __restrict__ a, int M,
                                       int K, int row0, int k0) {
#pragma unroll
  for (int p = 0; p < kATile / 16 / kThreads; ++p) {
    const int idx = threadIdx.x + p * kThreads;
    const int r = idx >> 3, ch = idx & 7;
    const int m = row0 + r, k = k0 + 16 * ch;
    uint8_t* d = dst + tile_off(r, ch);
    if (kFastA) {  // K % 16 == 0: a chunk lies wholly inside or outside K
      const bool in = m < M && k < K;
      cp_async16(d, in ? a + (long long)m * K + k : a, in ? 16 : 0);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (m < M) {
        const uint8_t* src = a + (long long)m * K;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (k + j < K) w[j >> 2] |= (uint32_t)src[k + j] << (8 * (j & 3));
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// This thread's 4 k-rows x 16 columns of B's k-tile into breg[row][word];
// k past K and columns past N are zero.
template <bool kFastB>
__device__ __forceinline__ void load_b(uint32_t (&breg)[4][4], const uint8_t* __restrict__ b,
                                       int K, long long N, int k, long long c) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int q = 0; q < 4; ++q) breg[r][q] = 0u;
    if (k + r >= K) continue;
    const uint8_t* src = b + (long long)(k + r) * N + c;
    if (kFastB) {  // N % 16 == 0: the 16 columns lie wholly inside or outside N
      if (c < N) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
        breg[r][0] = v.x;
        breg[r][1] = v.y;
        breg[r][2] = v.z;
        breg[r][3] = v.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (c + j < N) breg[r][j >> 2] |= (uint32_t)src[j] << (8 * (j & 3));
    }
  }
}

// Masks breg, transposes its 4x4 byte blocks and stores the 16 columns'
// 4-k words into the [n][k] tile: column n0 + j at k-quad kq.
__device__ __forceinline__ void store_b(uint8_t* bs, const uint32_t (&breg)[4][4], int n0,
                                        int kq) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t w0 = breg[0][q] & kLowBits, w1 = breg[1][q] & kLowBits;
    const uint32_t w2 = breg[2][q] & kLowBits, w3 = breg[3][q] & kLowBits;
    const uint32_t t0 = __byte_perm(w0, w1, 0x5140), t1 = __byte_perm(w0, w1, 0x7362);
    const uint32_t t2 = __byte_perm(w2, w3, 0x5140), t3 = __byte_perm(w2, w3, 0x7362);
    const uint32_t col[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                             __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<uint32_t*>(bs + tile_off(n0 + 4 * q + c, kq >> 2) + 4 * (kq & 3)) =
          col[c];
  }
}

template <bool kFastA, bool kFastB>
__global__ void __launch_bounds__(kThreads, 2)
gf2_matmul_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                  uint8_t* __restrict__ out, int M, int K, long long N, int row_blocks) {
  __shared__ __align__(128) uint8_t smem[2 * kATile + kBTile];  // A stages 0, 1; B
  uint8_t* const bs = smem + 2 * kATile;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int row0 = (blockIdx.x % row_blocks) * kBM;
  const long long col0 = (long long)(blockIdx.x / row_blocks) * kBN;
  const int wm = (wid / kWN) * kWarpM, wn = (wid % kWN) * kWarpN;
  const bool warp_active = row0 + wm < M;
  // B loads: k-quad bq (warp w takes quads 4w..4w+3, 8 lanes each) and
  // column group bn: 8 lanes read 128 contiguous bytes of one k-row.
  const int bq = 4 * wid + (lane >> 3), bn = 16 * (lane & 7);

  int acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  uint32_t breg[4][4];
  const int ntiles = (K + kBK - 1) / kBK;
  if (ntiles > 0) {
    load_a<kFastA>(smem, a, M, K, row0, 0);
    asm volatile("cp.async.commit_group;\n" ::);
    load_b<kFastB>(breg, b, K, N, 4 * bq, col0 + bn);
  }
  for (int t = 0; t < ntiles; ++t) {
    store_b(bs, breg, bn, bq);  // the previous tile's mma is done (barrier below)
    if (t + 1 < ntiles) {       // next tile in flight during this tile's mma
      load_a<kFastA>(smem + ((t + 1) & 1) * kATile, a, M, K, row0, (t + 1) * kBK);
      load_b<kFastB>(breg, b, K, N, (t + 1) * kBK + 4 * bq, col0 + bn);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);  // tile t's A has landed
    __syncthreads();
    if (warp_active) {  // k-steps of 32 up to K: the zeros past it add nothing
      const uint8_t* as = smem + (t & 1) * kATile;
      const int kt = min(kBK, K - t * kBK);
      const int lj = lane >> 3, lr = lane & 7;  // ldmatrix.x4: row lr of matrix lj
#pragma unroll
      for (int ks = 0; ks < kBK / 32; ++ks) {
        if (32 * ks >= kt) break;
        uint32_t bf[kNT][2];
#pragma unroll
        for (int p = 0; p < kNT / 2; ++p)
          ldsm_x4(bs + tile_off(wn + 16 * p + lr + 8 * (lj >> 1), 2 * ks + (lj & 1)),
                  bf[2 * p][0], bf[2 * p][1], bf[2 * p + 1][0], bf[2 * p + 1][1]);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          uint32_t af[4];
          ldsm_x4(as + tile_off(wm + 16 * mt + lr + 8 * (lj & 1), 2 * ks + (lj >> 1)), af[0],
                  af[1], af[2], af[3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) af[e] &= kLowBits;
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) mma_u8(acc[mt][nt], af, bf[nt][0], bf[nt][1]);
        }
      }
    }
    __syncthreads();
  }

  // Epilogue: acc & 1 as bytes into A's stage 0 (free: the loop ended on a
  // barrier and every copy has landed), then 16-byte rows out.
  if (warp_active) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int m = wm + 16 * mt + (lane >> 2), n = wn + 8 * nt + 2 * (lane & 3);
        const int* c = acc[mt][nt];
        *reinterpret_cast<uint16_t*>(smem + tile_off(m, n >> 4) + (n & 15)) =
            (uint16_t)((c[0] & 1) | (c[1] & 1) << 8);
        *reinterpret_cast<uint16_t*>(smem + tile_off(m + 8, n >> 4) + (n & 15)) =
            (uint16_t)((c[2] & 1) | (c[3] & 1) << 8);
      }
  }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < kBM * kBN / 16 / kThreads; ++p) {
    const int idx = threadIdx.x + p * kThreads;
    const int r = idx >> 3, ch = idx & 7;
    const int m = row0 + r;
    const long long c = col0 + 16 * ch;
    if (m >= M || c >= N) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(smem + tile_off(r, ch));
    uint8_t* dst = out + (long long)m * N + c;
    if (kFastB) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (c + j < N) dst[j] = (uint8_t)(w[j >> 2] >> (8 * (j & 3)));
    }
  }
}

template <bool kFastA, bool kFastB>
int launch(const void* a, const void* b, void* out, int M, int K, long long N, int row_blocks,
           unsigned blocks, cudaStream_t stream) {
  gf2_matmul_kernel<kFastA, kFastB><<<blocks, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
      static_cast<uint8_t*>(out), M, K, N, row_blocks);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches K2 on `stream` for contiguous uint8 tensors a (M, K), b (K, N) and
// out (M, N); the caller checks shapes. The 1-D grid holds one block per
// 128 x 128 output block, row blocks fastest. The 16-byte paths run where
// K % 16 == 0 and a is 16-byte aligned (A), and where N % 16 == 0 and b and
// out are (B and out); byte-wise paths take the rest.
// Returns cudaGetLastError() after the launch: 0 when it was accepted.
extern "C" int gf2_matmul_launch(const void* a, const void* b, void* out, int M, int K,
                                 long long N, void* stream) {
  if (M == 0 || N == 0) return 0;
  const bool fast_a = K % 16 == 0 && (uintptr_t)a % 16 == 0;
  const bool fast_b =
      N % 16 == 0 && (uintptr_t)b % 16 == 0 && (uintptr_t)out % 16 == 0;
  const int row_blocks = (M + kBM - 1) / kBM;
  const long long blocks = (long long)row_blocks * ((N + kBN - 1) / kBN);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  auto s = (cudaStream_t)stream;
  const unsigned nb = (unsigned)blocks;
  if (fast_a && fast_b) return launch<true, true>(a, b, out, M, K, N, row_blocks, nb, s);
  if (fast_a) return launch<true, false>(a, b, out, M, K, N, row_blocks, nb, s);
  if (fast_b) return launch<false, true>(a, b, out, M, K, N, row_blocks, nb, s);
  return launch<false, false>(a, b, out, M, K, N, row_blocks, nb, s);
}
