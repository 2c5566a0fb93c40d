// One decode step's attention, read straight from the ring KV cache (sm_90a).
//
// Replaces no TPU kernel: the reference package's decode attention is plain
// jnp (repro/models/layers.py::decode_attention). It was added because the
// port's plain version (kernels/attention/decode_attention.py::
// decode_attention_plain) moves the whole cache several times a step at
// every attention layer: it upcasts the K ring to float32, each einsum then
// copies its operand ring (float32 K, bfloat16 V) into a permuted layout
// that one bmm can take, and the two bmms read those copies again. For a
// zamba2-2.7b batch site (32 rows, 192 slots, 32 KV heads of 80) that is
// ~380 MB moved to read 63 MB of cache. This kernel reads the cache where it
// lies, once.
//
// For each batch row b, KV head j and query head g of its G (h = j * G + g),
// over the slots s of the ring (rows of cache_k / cache_v, (B, Smax, Hkv, hd)):
//
//   score[s] = capped(sum_d q[h, d] * k[s, j, d] / sqrt(hd))   (float32)
//   score[s] = MASKED unless 0 <= slot_pos[s] <= pos (and > pos - window)
//   p[s]     = round_to_cache_dtype(exp(score[s] - max) / sum_s' exp(...))
//   out[h]   = round_to_cache_dtype(sum_s p[s] * v[s, j, :])   (float32 sum)
//
// The rounding points are the plain version's: float32 products (exact for
// bfloat16 operands) and float32 sums; the divide by the float32 sqrt(hd)
// and by the softcap are the plain path's own operations on the card (a
// multiply by the float32 reciprocal, see `Args::inv_scale`); an exact
// softmax over the whole row (its true max, exp, the sum, a divide), with
// no online rescaling; p rounded to the cache's dtype as p.to(cache_v.dtype)
// does; one rounding of the output. Only the order of the sums differs, so
// the result holds to the plain version within a float32 reordering.
//
// What bounds it on this card: bytes. K and V are read once (2 * B * Smax *
// Hkv * hd * itemsize), plus q, slot_pos and the output; 4 * hd operations a
// (slot, query head) pair, under 2 * G / itemsize operations a cache byte
// against the H100's ~295 (G <= 16). Least time at 3.35 TB/s: 0.019 ms for a
// zamba2-2.7b batch site (63 MB), 0.103 ms for its chat site (346 MB, 1,056
// slots), 0.013 ms for a Nemotron-3-Nano layer (B 64, 640 slots, 2 x 128).
//
// Design.
// - A block owns one (batch row, KV head) and a range of at most `chunk`
//   slots; it serves all G query heads of that KV head from the same tiles,
//   so the cache is read once whatever G is.
// - Tiles of TS slots of one head's K (then V) rows are copied into shared
//   memory by cp.async, 16 bytes a thread, consecutive threads on
//   consecutive bytes of a row, kStages tiles in flight. The K tiles and the
//   V tiles are one stream: the V prefetch overlaps the softmax. A tile row
//   is padded (by the wrapper) so that the DP threads of one row and those
//   of the next, which read 16 * DP bytes each, meet no bank conflict.
// - Scores: a thread takes two slots (rows r and r + TS / 2) and GT query
//   heads, over every DP-th 16-byte chunk of the row; the DP partial dots
//   meet by warp shuffles. q is held in shared memory as float32.
// - Softmax: the block's 8 warps share the G rows (all 8 on one row where
//   G = 1); partial maxima and sums meet in shared memory in warp order.
// - P.V: a thread takes one 16-byte chunk of the V row (VE dims), GT query
//   heads and every SL-th slot; the SL partial sums meet in shared memory,
//   added in order of the slot lane.
// - A row is split across blocks (chosen by the wrapper) where the (batch
//   row, KV head) pairs alone fill less than half the card, or where one
//   block could not hold a whole row's scores. The split takes three
//   launches: kScores writes each chunk's scores to a float32 scratch row;
//   kAttend reads the whole row back (from L2) for its exact max and sum,
//   the same in every block of the row, rounds p for its own chunk and
//   writes the float32 partial P.V; `combine` adds the partials in chunk
//   order and rounds once. One launch (kFused) does all of it where a row
//   is one chunk.
// - GT is 1 where G <= 4 (the cache's bytes bound those rows) and 8 above,
//   so a thread's q and p loads serve 8 query heads (Nemotron's 16); G is
//   padded to a multiple of GT (the padded heads read q = 0 and are not
//   written). Two values keep the build short: it runs at a program's first
//   decode.
// - `pos` is read from the device; nothing here syncs with the host, so a
//   CUDA graph may capture the launches.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 3;

enum Mode { kFused = 0, kScores = 1, kAttend = 2 };

struct Args {
  const void* q;        // (B, H, hd), contiguous
  const void* k;        // (B, Smax, Hkv, hd), contiguous
  const void* v;        // (B, Smax, Hkv, hd), contiguous
  const int* slot_pos;  // (Smax,)
  const int* pos;       // the new token's position (0-d)
  void* out;            // (B, H, hd), contiguous
  float* scores;        // (B, H, Smax) scratch of the split path
  float* part;          // (B, H, n_split, hd) scratch of the split path
  int Smax, Hkv, G, Gp, hd, window;
  int rs;  // bytes of a tile row in shared memory: hd * itemsize and a pad
  // The plain path's x / sqrt(hd) and x / softcap on the card: a tensor over a
  // Python float is multiplied by the float32 reciprocal of the float32 divisor.
  float inv_scale, softcap, inv_softcap, masked;
  int chunk, n_split, ts, dp;
};

template <typename T> struct Elt;
template <> struct Elt<float> {
  static constexpr int kVec = 4;  // elements in 16 bytes
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ float load(const void* p, size_t i) {
    return static_cast<const float*>(p)[i];
  }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ void store(void* p, size_t i, float x) {
    static_cast<float*>(p)[i] = x;
  }
};
template <> struct Elt<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // element 2j is the low half of word j
      f[2 * j] = __uint_as_float(w[j] << 16);
      f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ float load(const void* p, size_t i) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ void store(void* p, size_t i, float x) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
// A butterfly: every lane ends with the same sum (float addition commutes).
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

constexpr int kBatch = 8;  // loads a lane has in flight over a score row

// Each query head's exact softmax over its row of scores: the row's max
// and sum of exp(x - max) over `n` scores at `row(g)[i * stride]`, then
// p[s] = round(exp(x[off + s] - max) / sum) into sc[s * Gp + g] for s < n_p.
// The block's warps share the heads, WPH warps a head (all of them where
// G = 1); warp w of a head takes x[32 w + lane], x[32 (w + WPH) + lane], ...
// in order, kBatch loads at a time, and the WPH partials meet in `red`,
// taken in warp order. Called by every thread of the block.
template <typename T, int NW>
__device__ __forceinline__ void softmax_rows(const float* rows, size_t row_stride, int stride,
                                             int n, int off, int n_p, int G, float* sc, int Gp,
                                             float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int wph = G >= NW ? 1 : NW / G;  // warps a head
  const int per_round = NW / wph;         // heads a round
  const float neg_inf = __int_as_float(0xff800000);
  for (int g0 = 0; g0 < G; g0 += per_round) {
    const int g = g0 + warp / wph, wi = warp % wph, first = warp - wi;
    const bool has = warp < per_round * wph && g < G;
    const float* row = rows + (has ? g : 0) * row_stride;
    float m = neg_inf;
    if (has)
      for (int s = 32 * wi + lane; s < n; s += 32 * wph * kBatch) {
        float x[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int i = s + 32 * wph * j;
          x[j] = i < n ? row[(size_t)i * stride] : neg_inf;
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) m = fmaxf(m, x[j]);
      }
    m = warp_max(m);
    if (lane == 0) red[warp] = m;
    __syncthreads();
    if (has)
      for (int i = 0; i < wph; ++i) m = fmaxf(m, red[first + i]);
    __syncthreads();
    float sum = 0.f;
    if (has)
      for (int s = 32 * wi + lane; s < n; s += 32 * wph * kBatch) {
        float x[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int i = s + 32 * wph * j;
          x[j] = i < n ? row[(size_t)i * stride] : neg_inf;
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j)
          if (s + 32 * wph * j < n) sum += expf(x[j] - m);
      }
    sum = warp_sum(sum);
    if (lane == 0) red[warp] = sum;
    __syncthreads();
    if (has) {
      sum = 0.f;
      for (int i = 0; i < wph; ++i) sum += red[first + i];
      for (int s = 32 * wi + lane; s < n_p; s += 32 * wph * kBatch) {
        float x[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int i = s + 32 * wph * j;
          x[j] = i < n_p ? row[(size_t)(off + i) * stride] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int i = s + 32 * wph * j;
          if (i < n_p) sc[i * Gp + g] = Elt<T>::round(__fdiv_rn(expf(x[j] - m), sum));
        }
      }
    }
    __syncthreads();
  }
}

// The shared-memory layout below is the one the wrapper sizes
// (decode_attention.py::plan): tiles, the reduction buffer, scores, q, slot_pos.
__host__ __device__ __forceinline__ int align4(int n) { return (n + 3) & ~3; }

template <typename T, int GT, int MODE>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(const Args a) {
  using E = Elt<T>;
  constexpr int VE = E::kVec;
  constexpr int NT = kThreads;
  constexpr int NW = NT / 32;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int b = blockIdx.x / a.Hkv, kvh = blockIdx.x - b * a.Hkv;
  const int split = blockIdx.y;
  const int s0 = split * a.chunk;
  const int L = min(a.Smax - s0, a.chunk);  // this block's slots: [s0, s0 + L)
  const int H = a.Hkv * a.G;
  const int DV = a.hd / VE;                 // 16-byte chunks of a row
  const int RS = a.rs;
  const int TS = a.ts;
  const int NGC = a.Gp / GT;

  unsigned char* tiles = smem;                                        // kStages * TS * RS
  float* red = reinterpret_cast<float*>(tiles + kStages * TS * RS);  // NT * VE
  float* sc = red + NT * VE;                        // [slot][Gp]: scores, then p
  float* qs = sc + (MODE == kScores ? 0 : align4(a.chunk * a.Gp));  // [Gp][hd]
  int* sp = reinterpret_cast<int*>(qs + (MODE == kAttend ? 0 : a.Gp * a.hd));  // [chunk]

  const int nk = MODE == kAttend ? 0 : (L + TS - 1) / TS;  // K tiles, then
  const int nv = MODE == kScores ? 0 : (L + TS - 1) / TS;  // V tiles
  const int nt = nk + nv;
  const size_t row_bytes = (size_t)a.hd * sizeof(T);

  auto fetch = [&](int j) {
    if (j >= nt) return;
    const bool is_k = j < nk;
    const int base = (is_k ? j : j - nk) * TS;  // within the block's slots
    const int rows = min(TS, L - base);
    const char* src = static_cast<const char*>(is_k ? a.k : a.v) +
                      (((size_t)b * a.Smax + s0 + base) * a.Hkv + kvh) * row_bytes;
    const size_t src_rs = (size_t)a.Hkv * row_bytes;
    unsigned char* dst = tiles + (j % kStages) * TS * RS;
    for (int c = tid; c < rows * DV; c += NT) {
      const int r = c / DV, col = c - r * DV;
      cp_async16(dst + r * RS + col * 16, src + r * src_rs + col * 16);
    }
  };
  // tile t is in shared memory, and every thread is done with tile t - 1,
  // whose buffer takes tile t + kStages - 1
  auto next_tile = [&](int t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    fetch(t + kStages - 1);
    cp_async_commit();
    return tiles + (t % kStages) * TS * RS;
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    fetch(j);
    cp_async_commit();
  }

  const int P = *a.pos;
  if (MODE != kAttend) {
    // this KV head's G rows of q are contiguous: 16 bytes a thread
    const uint4* qg = reinterpret_cast<const uint4*>(
        static_cast<const T*>(a.q) + ((size_t)b * H + kvh * a.G) * a.hd);
    for (int i = tid; i < a.G * DV; i += NT) {
      float f[VE];
      E::unpack(__ldg(qg + i), f);
#pragma unroll
      for (int e = 0; e < VE; ++e) qs[i * VE + e] = f[e];
    }
    for (int i = a.G * a.hd + tid; i < a.Gp * a.hd; i += NT) qs[i] = 0.f;
    for (int i = tid; i < L; i += NT) sp[i] = a.slot_pos[s0 + i];
  }
  if (MODE == kAttend) {  // p of this chunk, from the whole row's max and sum
    for (int i = tid; i < L * (a.Gp - a.G); i += NT)
      sc[(i / (a.Gp - a.G)) * a.Gp + a.G + i % (a.Gp - a.G)] = 0.f;
    softmax_rows<T, NW>(a.scores + ((size_t)b * H + kvh * a.G) * a.Smax, a.Smax, 1, a.Smax,
                        s0, L, a.G, sc, a.Gp, red);
  }

  // Scores: item (dp, slot pair, gc); the dp threads of an item are
  // neighbouring lanes. Every lane runs the same trips (the shuffles).
  const int pairs = TS / 2;
  const int n_qk = a.dp * pairs * NGC;
  for (int t = 0; t < nk; ++t) {
    const unsigned char* tile = next_tile(t);
    const int toff = t * TS, rows = min(TS, L - toff);
    for (int base = 0; base < n_qk; base += NT) {
      const int it = base + tid;
      const bool live = it < n_qk;
      const int dp = it % a.dp, pr = (it / a.dp) % pairs;
      const int gc = min(it / (a.dp * pairs), NGC - 1);
      float s0a[GT], s1a[GT];
#pragma unroll
      for (int g = 0; g < GT; ++g) s0a[g] = s1a[g] = 0.f;
      const unsigned char* k0p = tile + pr * RS;
      const unsigned char* k1p = tile + (pr + pairs) * RS;
      for (int c = dp; c < DV; c += a.dp) {
        float k0[VE], k1[VE];
        E::unpack(*reinterpret_cast<const uint4*>(k0p + c * 16), k0);
        E::unpack(*reinterpret_cast<const uint4*>(k1p + c * 16), k1);
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          const float4* qv =
              reinterpret_cast<const float4*>(qs + (gc * GT + g) * a.hd + c * VE);
#pragma unroll
          for (int j = 0; j < VE / 4; ++j) {
            const float4 x = qv[j];
            const float qf[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              s0a[g] = fmaf(qf[e], k0[4 * j + e], s0a[g]);
              s1a[g] = fmaf(qf[e], k1[4 * j + e], s1a[g]);
            }
          }
        }
      }
      for (int off = a.dp / 2; off > 0; off >>= 1)
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          s0a[g] += __shfl_xor_sync(0xffffffffu, s0a[g], off);
          s1a[g] += __shfl_xor_sync(0xffffffffu, s1a[g], off);
        }
      if (live && dp == 0) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = pr + half * pairs;
          if (r >= rows) continue;
          const int sl = toff + r;  // slot within the block's
          const int spv = sp[sl];
          const bool ok = spv <= P && spv >= 0 && (a.window <= 0 || spv > P - a.window);
#pragma unroll
          for (int g = 0; g < GT; ++g) {
            const int gg = gc * GT + g;
            float s = (half ? s1a[g] : s0a[g]) * a.inv_scale;
            if (a.softcap != 0.f) s = a.softcap * tanhf(s * a.inv_softcap);
            s = ok ? s : a.masked;
            if (MODE == kFused) {
              sc[sl * a.Gp + gg] = gg < a.G ? s : 0.f;
            } else if (gg < a.G) {
              a.scores[((size_t)b * H + kvh * a.G + gg) * a.Smax + s0 + sl] = s;
            }
          }
        }
      }
    }
  }
  if (MODE == kScores) {
    cp_async_wait<0>();
    return;
  }

  // P.V: item (dv, gc) and slot lane, SL lanes an item (the wrapper keeps
  // DV * NGC <= NT); a thread's sums live only in this phase
  const int n_items = DV * NGC;
  const int SL = NT / n_items;
  const int item = tid % n_items, slane = tid / n_items;
  const int pv_dv = item % DV, pv_gc = item / DV;
  float acc[GT][VE];
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[g][e] = 0.f;
  for (int t = nk; t < nt; ++t) {
    const unsigned char* tile = next_tile(t);
    if (MODE == kFused && t == nk)  // every score is in: the softmax of each row
      softmax_rows<T, NW>(sc, 1, a.Gp, L, 0, L, a.G, sc, a.Gp, red);
    const int toff = (t - nk) * TS, rows = min(TS, L - toff);
    if (slane < SL) {
      for (int r = slane; r < rows; r += SL) {
        float vv[VE];
        E::unpack(*reinterpret_cast<const uint4*>(tile + r * RS + pv_dv * 16), vv);
        float pg[GT];
        const float* p = sc + (toff + r) * a.Gp + pv_gc * GT;
        if (GT % 4 == 0) {  // 16-byte aligned: Gp and the offset are multiples of 4
#pragma unroll
          for (int j = 0; j < GT / 4; ++j) {
            const float4 x = reinterpret_cast<const float4*>(p)[j];
            pg[4 * j] = x.x;
            pg[4 * j + 1] = x.y;
            pg[4 * j + 2] = x.z;
            pg[4 * j + 3] = x.w;
          }
        } else {
#pragma unroll
          for (int g = 0; g < GT; ++g) pg[g] = p[g];
        }
#pragma unroll
        for (int g = 0; g < GT; ++g)
#pragma unroll
          for (int e = 0; e < VE; ++e) acc[g][e] = fmaf(pg[g], vv[e], acc[g][e]);
      }
    }
  }
  cp_async_wait<0>();

  // the SL partial sums of each output, added in order of the slot lane
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    __syncthreads();
#pragma unroll
    for (int e = 0; e < VE; ++e) red[tid * VE + e] = acc[g][e];
    __syncthreads();
    for (int o = tid; o < n_items * VE; o += NT) {
      const int it = o / VE, e = o - it * VE;
      const int gg = (it / DV) * GT + g;
      if (gg >= a.G) continue;
      float s = 0.f;
      for (int l = 0; l < SL; ++l) s += red[(l * n_items + it) * VE + e];
      const size_t bh = (size_t)b * H + kvh * a.G + gg;
      const int d = (it % DV) * VE + e;
      if (MODE == kFused)
        E::store(a.out, bh * a.hd + d, s);
      else
        a.part[(bh * a.n_split + split) * a.hd + d] = s;
    }
  }
}

// The split path's last pass: the chunks' float32 partials of each output,
// added in chunk order and rounded once.
template <typename T>
__global__ void combine_kernel(const Args a) {
  const size_t bh = blockIdx.x;
  for (int d = threadIdx.x; d < a.hd; d += blockDim.x) {
    float s = 0.f;
    for (int i = 0; i < a.n_split; ++i) s += a.part[(bh * a.n_split + i) * a.hd + d];
    Elt<T>::store(a.out, bh * a.hd + d, s);
  }
}

template <typename T, int GT, int MODE>
int launch_mode(const Args& a, dim3 grid, int smem, cudaStream_t stream) {
  // Raised once per instance and device, at the first launch (a graph's
  // warm-up steps come before its capture).
  constexpr int kDevices = 64;
  static int smem_set[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kDevices) return (int)cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(decode_attention_kernel<T, GT, MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = smem;
  }
  decode_attention_kernel<T, GT, MODE><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int GT>
int launch_gt(const Args& a, int B, const int* smem, cudaStream_t stream) {
  const dim3 grid((unsigned)(B * a.Hkv), (unsigned)a.n_split);
  if (a.n_split == 1) return launch_mode<T, GT, kFused>(a, grid, smem[kFused], stream);
  int rc = launch_mode<T, GT, kScores>(a, grid, smem[kScores], stream);
  if (rc) return rc;
  rc = launch_mode<T, GT, kAttend>(a, grid, smem[kAttend], stream);
  if (rc) return rc;
  combine_kernel<T><<<(unsigned)(B * a.Hkv * a.G), a.hd, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(const Args& a, int B, int gt, const int* smem, cudaStream_t stream) {
  if (gt == 1) return launch_gt<T, 1>(a, B, smem, stream);
  if (gt == 8) return launch_gt<T, 8>(a, B, smem, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 for float32 q, caches and output; 1 for bfloat16. The plan (gt,
// gp, rs, ts, dp, chunk, n_split and each mode's shared memory in bytes) comes
// from the wrapper (decode_attention.py::plan). Returns cudaGetLastError()
// after the launches (0 on success).
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* slot_pos, const void* pos, void* out,
                                       void* scores, void* part, int B, int Smax, int Hkv,
                                       int G, int hd, int window, float inv_scale, float softcap,
                                       float inv_softcap, float masked, int dtype, int gt, int gp,
                                       int rs, int ts, int dp, int chunk, int n_split, int smem_fused,
                                       int smem_scores, int smem_attend, void* stream) {
  if (B == 0) return 0;
  if (hd % 8 || hd > 256 || rs % 16 || rs < hd * (dtype ? 2 : 4) || ts % 2 || dp < 1 ||
      dp > 32 || gp % gt || gp < G ||
      (long long)chunk * n_split < Smax || (long long)B * Hkv > 0x7fffffffLL || n_split > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, (const int*)slot_pos, (const int*)pos, out, (float*)scores,
               (float*)part, Smax, Hkv, G, gp, hd, window, rs, inv_scale, softcap,
               inv_softcap, masked, chunk, n_split, ts, dp};
  const int smem[3] = {smem_fused, smem_scores, smem_attend};
  auto st = (cudaStream_t)stream;
  if (dtype == 0) return launch_t<float>(a, B, gt, smem, st);
  if (dtype == 1) return launch_t<__nv_bfloat16>(a, B, gt, smem, st);
  return (int)cudaErrorInvalidValue;
}
