// A decode step's absorbed latent attention (MLA, DeepSeek-V2/V3), read
// straight from the bfloat16 latent cache on the tensor cores (sm_90a).
//
// Replaces no TPU kernel: the reference package has no MLA. It was added
// because the port's plain version (kernels/attention/latent_attention.py::
// latent_attention_plain, the body of models/mla.py::absorbed_attention
// before this kernel) writes a float32 score tensor of B * H * Smax and
// passes over it five times (the scale, the mask, the softmax, the cast to
// bfloat16) before the second product reads the latent again: at DeepSeek-V3's
// serving shape (32 rows, 128 heads, 4,352 slots) ~0.96 GB moved a layer to
// read a 160 MB latent, 0.37 ms a layer on an H100.
//
// For each batch row b and head h, over the slots s = 0..pos of the row's
// latent (B, Smax, 576) = [c_kv (512), k_pe (64)], with q (B, H, 576) =
// [q_lat, q_pe]:
//
//   score[s] = (sum_d q[h, d] * latent[s, d]) * scale      (float32 sums)
//   p[s]     = round_to_bf16(exp(score[s] - m))            (m: a running max)
//   out[h]   = round_to_bf16(sum_s p[s] * c_kv[s, :] / sum_s exp(score[s] - m))
//
// The rounding points are the plain version's: bfloat16 operands, float32
// score sums, the same scale multiply, a float32 softmax (exp by the card's
// fast float32 exp, a few ulp), p rounded to bfloat16 for P * c_kv, float32
// sums of that product, one rounding of the output. The one departure is the
// online softmax's: p is rounded against the running max of the block's
// slots so far (rescaled in float32 as the max grows), and the sum that
// divides it is taken in the same pass.
//
// What bounds it on this card: 2 * H * (576 + 512) operations a cached slot
// against 1,152 bytes, ~242 operations a byte for 128 heads, near the H100's
// ridge (~295): at (32, 128, 4,352) the latent's 160 MB take 0.048 ms at
// 3.35 TB/s and its 38.8 GFLOP 0.039 ms at 989 TFLOP/s. So both products run
// on the tensor cores by wgmma, the latent streams in by TMA, and it is read
// from device memory once.
//
// Design: three warpgroups a block, after FlashMLA's split of the work.
// - A block owns 64 heads of one batch row and one range of its slots (a
//   split). Heads beyond H are computed from whatever q rows follow and are
//   not written.
// - TMA copies q's 64 rows once and the latent in tiles of 32 slots x 576
//   channels, four in flight, each as nine boxes of 64 channels (128-byte
//   rows, swizzled 128B: wgmma's K-major layout for the scores and its
//   MN-major one for P * c_kv), completing on a stage's "full" mbarrier; a
//   stage is refilled once its "empty" mbarrier has every thread's arrival.
//   A tile that ends before its 32 slots (the last of a range) is copied by
//   cp.async into the same layout, zero past pos, so no slot above pos is
//   read.
// - Warpgroup 0 computes the scores of a tile, 36 wgmma m64n32k16 over the
//   576 channels (q and the tile from shared memory, float32 sums), and the
//   online softmax in the accumulators' own layout (a thread holds 2 head
//   rows x 8 slots; a row's 4 threads meet by shuffles): the tile's max, the
//   new running max, exp, the float32 sums, p rounded to bfloat16. It writes
//   p and the factors exp(m_old - m_new) to one of two shared buffers and
//   goes on to the next tile's scores.
// - Warpgroups 1 and 2 each hold 64 heads x 256 of the 512 output columns
//   in float32 registers (128 a thread): for each tile they rescale them
//   where the max moved and add 2 wgmma m64n256k16 (p and the tile's c_kv
//   rows from shared memory), while warpgroup 0 works on the next tile.
// - The two head blocks of a (row, split) are neighbours in the grid, so
//   they run together and the second one's reads of each tile hit L2: the
//   latent comes from device memory once. A cluster of the two sharing each
//   tile by TMA multicast replayed 1.6x slower on an H100: with four stages
//   in flight, each stage waits for the slower block of the pair.
// - A row's slots 0..pos are cut into n_split ranges of whole tiles (from
//   the wrapper's plan: B * ceil(H / 64) * n_split blocks to fill the SMs),
//   computed here from pos read on the device, so a CUDA graph may capture
//   the launch. With one split the block writes the output; with more, each
//   writes its float32 partial (the unnormalised 512 sums, its max and its
//   sum) and `combine_kernel` merges them in split order and rounds once.

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kD = 576;               // latent width: c_kv, then k_pe
constexpr int kDV = 512;              // value width: c_kv
constexpr int kHB = 64;               // heads a block (wgmma's M)
constexpr int kTS = 32;               // slots a tile
constexpr int kStages = 4;            // tiles in flight
constexpr int kThreads = 384;         // three warpgroups
constexpr int kBoxW = 64;             // channels a box: one 128-byte swizzled row
constexpr int kBoxes = kD / kBoxW;    // boxes a row
constexpr int kKSteps = kD / 16;      // wgmma k-steps of the width
constexpr int kBoxQ = kHB * 128;      // bytes of q's box of 64 channels
constexpr int kBoxT = kTS * 128;      // bytes of a tile's box
constexpr int kSmemQ = kBoxes * kBoxQ;
constexpr int kSmemT = kBoxes * kBoxT;
constexpr int kSmemP = kHB * kTS * 2;  // a buffer of p, unswizzled core matrices
// q, the stages, two buffers of p and of the rescale factors, the rows' max
// and sum, the mbarriers: a stage's full and empty, a p buffer's full and
// empty, q's
constexpr int kSmem =
    1024 + kSmemQ + kStages * kSmemT + 2 * kSmemP + 4 * kHB * 4 + 8 * (2 * kStages + 4 + 1);
constexpr int kPart = kDV + 2;        // a split's partial: 512 sums, max, sum
constexpr uint64_t kSwizzle128 = 1ull << 62;

static_assert(kTS * kD / 8 % 128 == 0, "a tile's pieces divide among a warpgroup");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Makes this thread's shared-memory writes visible to wgmma (the async proxy).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box of a 2-D tensor map (x: channel, y: row) into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int x, int y,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving uses of an accumulator across a wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// A wgmma shared-memory descriptor: the start, the byte strides along the
// leading dimension and between 8-row groups; 128B-swizzled (atoms at
// 1,024-byte bounds) or not (core matrices of 8 rows x 16 bytes).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lead, uint32_t stride,
                                         uint64_t swizzle = kSwizzle128) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lead >> 4) << 16 |
         (uint64_t)(stride >> 4) << 32 | swizzle;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (64 x 32, float32) += a (64 x 16) * b (16 x 32), both from shared memory
// through descriptors, K-major. scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n32_ss(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                                int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 256, float32) += a (64 x 16) * b (16 x 256), both from shared memory
// through descriptors: a K-major, b MN-major (transposed).
__device__ __forceinline__ void wgmma_m64n256_ss(float (&d)[128], uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

struct Args {
  const __nv_bfloat16* latent;  // (B, Smax, 576)
  const int* pos;               // 0-d, on the device
  __nv_bfloat16* out;           // (B, H, 512)
  float* part;                  // (B, H, n_split, 514) where n_split > 1
  int H, Smax, n_hb, n_split;
  float scale;
};

// The slots [lo, hi) of split `sp`: the tiles that cover 0..pos, cut into
// n_split runs of `per` whole tiles (latent_attention.py::split_ranges).
__device__ __forceinline__ void split_range(int pos, int n_split, int sp, int& lo, int& hi) {
  const int tiles = pos / kTS + 1;
  const int per = (tiles + n_split - 1) / n_split;
  lo = min(sp * per * kTS, pos + 1);
  hi = min(lo + per * kTS, pos + 1);
}

// map_q: q as (B * H, 576) rows, boxes of 64 rows; map_latent: the latent as
// (B * Smax, 576) rows, boxes of 32 rows; both 64 channels a box, swizzled 128B.
__global__ void __launch_bounds__(kThreads, 1)
    latent_attention_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_latent, const Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzled atoms start at 1,024-byte bounds
  const uint32_t sQ = base, sT = base + kSmemQ, sP = sT + kStages * kSmemT;
  float* sAlpha = reinterpret_cast<float*>(smem_raw + (sP + 2 * kSmemP - raw));  // 2 x 64
  float* sML = sAlpha + 2 * kHB;                                                  // max, sum
  const uint32_t bars = sP + 2 * kSmemP + 4 * kHB * 4;
  // mbarriers: a stage's full (TMA bytes) and empty (every thread done with
  // it), a p buffer's full (warpgroup 0 wrote it) and empty (1 and 2 read it)
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (kStages + st); };
  auto p_full = [&](int pb) { return bars + 8 * (2 * kStages + pb); };
  auto p_empty = [&](int pb) { return bars + 8 * (2 * kStages + 2 + pb); };
  const uint32_t bar_q = bars + 8 * (2 * kStages + 4);

  const int hb = blockIdx.x % a.n_hb;
  const int sp = (blockIdx.x / a.n_hb) % a.n_split;
  const int b = blockIdx.x / (a.n_hb * a.n_split);
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127, w = t >> 5, lane = tid & 31;
  const int h0 = hb * kHB;
  // this thread's rows of a warpgroup's accumulators: 16 w + lane / 4 and 8
  // below; its columns of each 8-wide block: 2 (lane % 4) and the next
  const int r0 = 16 * w + (lane >> 2);

  const int pos = min(max(*a.pos, 0), a.Smax - 1);
  int lo, hi;
  split_range(pos, a.n_split, sp, lo, hi);
  const int n_tiles = (hi - lo + kTS - 1) / kTS;
  const __nv_bfloat16* lat = a.latent + (size_t)b * a.Smax * kD;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kThreads);
    }
    for (int pb = 0; pb < 2; ++pb) {
      mbar_init(p_full(pb), 128);
      mbar_init(p_empty(pb), 256);
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float acc[128];
#pragma unroll
  for (int k = 0; k < 128; ++k) acc[k] = 0.f;

  if (wg == 0) {
    // Tile i into its stage, once every thread is done with the stage's last
    // tile: by TMA from thread 0, or (a tile that ends before 32 slots) by
    // cp.async from the warpgroup, zero past hi.
    auto load_tile = [&](int i) {
      const int s0 = lo + i * kTS, st = i % kStages;
      const uint32_t dst = sT + st * kSmemT;
      if (s0 + kTS <= hi) {
        if (t == 0) {
          mbar_wait(empty(st), ((i / kStages) & 1) ^ 1);
          mbar_expect_tx(full(st), kSmemT);
          for (int j = 0; j < kBoxes; ++j)
            tma_load(dst + j * kBoxT, &map_latent, j * kBoxW, b * a.Smax + s0, full(st));
        }
      } else {
        mbar_wait(empty(st), ((i / kStages) & 1) ^ 1);
#pragma unroll
        for (int k = 0; k < kTS * kD / 8 / 128; ++k) {
          const int c = t + k * 128, r = c / (kD / 8), g = c % (kD / 8), slot = s0 + r;
          cp_async16(dst + (g >> 3) * kBoxT + r * 128 + (((g & 7) ^ (r & 7)) << 4),
                     lat + (size_t)(slot < hi ? slot : lo) * kD + g * 8, slot < hi ? 16 : 0);
        }
        cp_async_wait_all();
        fence_async_shared();
        asm volatile("bar.sync 1, 128;\n" ::: "memory");
        if (t == 0) mbar_arrive(full(st));
      }
    };
    if (t == 0) {
      mbar_expect_tx(bar_q, kSmemQ);
      for (int j = 0; j < kBoxes; ++j)
        tma_load(sQ + j * kBoxQ, &map_q, j * kBoxW, b * a.H + h0, bar_q);
    }
    for (int i = 0; i < kStages - 1 && i < n_tiles; ++i) load_tile(i);
    mbar_wait(bar_q, 0);

    float s[16];
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages, pb = i & 1;
      mbar_wait(full(st), (i / kStages) & 1);
      const uint32_t tile = sT + st * kSmemT;
      // scores: k-step k of the width is 32 bytes into box k / 4
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kKSteps; ++k)
        wgmma_m64n32_ss(s, desc(sQ + (k >> 2) * kBoxQ + (k & 3) * 32, 16, 1024),
                        desc(tile + (k >> 2) * kBoxT + (k & 3) * 32, 16, 1024), k > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      mbar_arrive(empty(st));

      // online softmax of this thread's two rows; l_run holds the sum of this
      // thread's own columns, the row's four threads add theirs at the end
      const int s0 = lo + i * kTS;
#pragma unroll
      for (int k = 0; k < 16; ++k) s[k] *= a.scale;
      if (s0 + kTS > hi) {
#pragma unroll
        for (int k = 0; k < 16; ++k)
          if (s0 + (k >> 2) * 8 + (lane & 3) * 2 + (k & 1) >= hi) s[k] = -INFINITY;
      }
      float mx[2] = {-INFINITY, -INFINITY}, alpha[2];
#pragma unroll
      for (int k = 0; k < 16; ++k) mx[(k >> 1) & 1] = fmaxf(mx[(k >> 1) & 1], s[k]);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
        mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
        const float m_new = fmaxf(m_run[hf], mx[hf]);  // finite: a tile holds a slot <= pos
        alpha[hf] = __expf(m_run[hf] - m_new);
        m_run[hf] = m_new;
        l_run[hf] *= alpha[hf];
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        s[k] = __expf(s[k] - m_run[(k >> 1) & 1]);
        l_run[(k >> 1) & 1] += s[k];
      }

      // p into buffer pb as unswizzled core matrices (a core matrix: 8 heads
      // x 8 slots, 16 bytes a head; 8-slot groups 1,024 bytes apart)
      mbar_wait(p_empty(pb), ((i >> 1) & 1) ^ 1);
      const uint32_t dst = sP + pb * kSmemP + (r0 >> 3) * 128 + (r0 & 7) * 16 + (lane & 3) * 4;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst + n * 1024 + hf * 128),
                       "r"(pack_bf16(s[4 * n + 2 * hf], s[4 * n + 2 * hf + 1]))
                       : "memory");
      if ((lane & 3) == 0) {
        sAlpha[pb * kHB + r0] = alpha[0];
        sAlpha[pb * kHB + r0 + 8] = alpha[1];
      }
      fence_async_shared();
      mbar_arrive(p_full(pb));

      if (i + kStages - 1 < n_tiles) load_tile(i + kStages - 1);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      l_run[hf] += __shfl_xor_sync(0xffffffffu, l_run[hf], 1);
      l_run[hf] += __shfl_xor_sync(0xffffffffu, l_run[hf], 2);
    }
    if ((lane & 3) == 0) {  // the rows' max and sum, for the epilogue
      sML[r0] = m_run[0];
      sML[r0 + 8] = m_run[1];
      sML[kHB + r0] = l_run[0];
      sML[kHB + r0 + 8] = l_run[1];
    }
  } else {
    // P * c_kv into this warpgroup's 256 columns (4 boxes), 16 slots a k-step
    const int c0 = (wg - 1) * 4;
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages, pb = i & 1;
      mbar_wait(full(st), (i / kStages) & 1);
      mbar_wait(p_full(pb), (i >> 1) & 1);
      const float a0 = sAlpha[pb * kHB + r0], a1 = sAlpha[pb * kHB + r0 + 8];
      if (a0 != 1.f || a1 != 1.f) {
#pragma unroll
        for (int k = 0; k < 128; ++k) acc[k] *= (k & 2) ? a1 : a0;
      }
      const uint32_t tile = sT + st * kSmemT;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        wgmma_m64n256_ss(acc, desc(sP + pb * kSmemP + ks * 2048, 1024, 128, 0),
                         desc(tile + c0 * kBoxT + ks * 2048, kBoxT, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(p_empty(pb));
      mbar_arrive(empty(st));
    }
  }
  __syncthreads();  // the rows' max and sum

  if (wg == 0) return;
  const int c0 = (wg - 1) * 256;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + 8 * hf, h = h0 + r;
    if (h >= a.H) continue;
    const size_t bh = (size_t)b * a.H + h;
    const float m = sML[r], l = sML[kHB + r];
    if (a.n_split == 1) {
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const int col = c0 + 8 * k + (lane & 3) * 2;
        *reinterpret_cast<uint32_t*>(a.out + bh * kDV + col) =
            pack_bf16(acc[4 * k + 2 * hf] / l, acc[4 * k + 2 * hf + 1] / l);
      }
    } else {
      float* dst = a.part + (bh * a.n_split + sp) * kPart;
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const int col = c0 + 8 * k + (lane & 3) * 2;
        *reinterpret_cast<float2*>(dst + col) =
            make_float2(acc[4 * k + 2 * hf], acc[4 * k + 2 * hf + 1]);
      }
      if (wg == 1 && (lane & 3) == 0) {
        dst[kDV] = m;
        dst[kDV + 1] = l;
      }
    }
  }
}

// The splits of one (row, head): weights exp(m_i - M) against the largest
// max M, sums and divisor added in split order, one rounding. A split with
// no slot holds max -inf and sum 0, so its weight is 0.
__global__ void combine_kernel(const Args a) {
  const size_t bh = blockIdx.x;
  const float* src = a.part + bh * a.n_split * kPart;
  float M = -INFINITY;
  for (int i = 0; i < a.n_split; ++i) M = fmaxf(M, src[i * kPart + kDV]);
  float L = 0.f;
  for (int i = 0; i < a.n_split; ++i) L += src[i * kPart + kDV + 1] * expf(src[i * kPart + kDV] - M);
  for (int d = threadIdx.x * 2; d < kDV; d += blockDim.x * 2) {
    float o0 = 0.f, o1 = 0.f;
    for (int i = 0; i < a.n_split; ++i) {
      const float wt = expf(src[i * kPart + kDV] - M);
      const float2 v = *reinterpret_cast<const float2*>(src + i * kPart + d);
      o0 += wt * v.x;
      o1 += wt * v.y;
    }
    *reinterpret_cast<uint32_t*>(a.out + bh * kDV + d) = pack_bf16(o0 / L, o1 / L);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (no link to libcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (rows, 576) bfloat16 rows of 1,152 bytes in boxes of 64 channels x box_rows.
CUresult make_map(CUtensorMap* map, const void* ptr, uint64_t rows, uint32_t box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)kD, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)kD * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBoxW, box_rows};
  const cuuint32_t steps[2] = {1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                   box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace

// q (B, H, 576), latent (B, Smax, 576) and out (B, H, 512) bfloat16; pos a
// 0-d int32 on the device; part a float32 (B, H, n_split, 514) scratch where
// n_split > 1 (else unused). Returns cudaGetLastError() after the launches
// (0 on success), or -1 where libcuda's tensor-map encoder is missing and
// -1000 - the CUresult where it refuses a map.
extern "C" int latent_attention_launch(const void* q, const void* latent, const void* pos,
                                       void* out, void* part, int B, int H, int Smax,
                                       int n_split, float scale, void* stream) {
  if (B == 0 || H == 0) return 0;
  const int n_hb = (H + kHB - 1) / kHB;
  if (Smax < 1 || n_split < 1 || (n_split > 1 && part == nullptr) ||
      (long long)B * n_hb * n_split > 0x7fffffffLL || (long long)B * Smax > 0x7fffffffLL ||
      (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (encoder() == nullptr) return -1;
  CUtensorMap map_q, map_latent;
  CUresult r = make_map(&map_q, q, (uint64_t)B * H, kHB);
  if (r == CUDA_SUCCESS) r = make_map(&map_latent, latent, (uint64_t)B * Smax, kTS);
  if (r != CUDA_SUCCESS) return -1000 - (int)r;
  // Raised once per device, at the first launch (a graph's warm-up steps
  // come before its capture).
  constexpr int kDevices = 64;
  static bool smem_set[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kDevices) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(latent_attention_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = true;
  }
  const Args a{(const __nv_bfloat16*)latent, (const int*)pos, (__nv_bfloat16*)out, (float*)part,
               H, Smax, n_hb, n_split, scale};
  auto st = (cudaStream_t)stream;
  latent_attention_kernel<<<(unsigned)(B * n_hb * n_split), kThreads, kSmem, st>>>(map_q,
                                                                                   map_latent, a);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  combine_kernel<<<(unsigned)(B * H), 128, 0, st>>>(a);
  return (int)cudaGetLastError();
}
