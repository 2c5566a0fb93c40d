// Mamba2's decode recurrence, one streaming pass over the float32 state (sm_90a).
//
// Replaces no TPU kernel: the reference package computes this step in plain
// JAX (repro/models/ssm.py::linear_recurrence_step, normalize=False), and the
// port's plain version, repro_torch/models/ssm.py::linear_recurrence_step,
// computes it in PyTorch. It was added because the plain step made about 11
// passes over the state X of one layer a decode step: k v^T materialised
// (write X), a*S (read X, write X), gi*kv (read X, write X), the add (read
// 2X, write X), q^T S (read X), and the model's copy of S' into its cache
// stack (read X, write X). This kernel reads S once and writes S' once.
//
// For each batch row b and head h, with k and q read by group h / (H / G):
//
//   S'[n, p] = a * S[n, p] + gi * (k[n] * v[p])    (a = exp(log_a), passed in)
//   n'[n]    = a * n[n]    + gi * k[n]
//   y[p]     = sum_n q[n] * S'[n, p]
//
// S' and n' are rounded as the plain version rounds them: every product and
// the add by __fmul_rn / __fadd_rn, so nothing is contracted into an FMA and
// the new state is bit-equal to the plain version's. y is a float32 sum in
// another order than the plain einsum's (FMAs over this thread's rows of n,
// then a sum over threads in shared memory); it holds to a float32 tolerance.
//
// What bounds it on this card: bytes. A step reads S and n and writes S' and
// n' (8 bytes and 6 operations an element of S: four for S', two for y),
// under one operation a byte against the H100's ~295, so its least time is
// 2X / 3.35 TB/s:
// 0.080 ms for a Nemotron-3-Nano layer's (64, 64, 128, 64) state (268 MB
// read and written), 0.025 ms for a zamba2-2.7b layer's (32, 32, 64, 160).
//
// Design: one streaming pass, in place.
// - Blocks over (b, h, P tile): a block owns columns [p0, p0 + CX * VEC) of
//   one (b, h) slab and all N rows of them, so y needs no sum across blocks.
//   A block is CX x TNY threads: CX vectors of the P tile (the largest of
//   16, 8, 4 that divides P / VEC) and TNY = 256 / CX rows; both follow the
//   shapes the kernel is given (Nemotron-3-Nano's P 64: 16 x 16, one tile;
//   zamba2's P 160: 8 x 32, five tiles).
// - Each thread owns VEC = 4 consecutive p (one float4; VEC = 1 where P is
//   not a multiple of 4 or a state pointer is not 16-byte aligned) and rows
//   n = ty, ty + TNY, ...: a warp's loads and stores are 16 bytes a lane and
//   contiguous along P, rows next to each other.
// - A thread's rows, ceil(N / TNY) of them (at most kMaxRows = 8 at a
//   time), are all loaded before any is used: with N 128 a block has 32 KB
//   in flight, with N 64 and TNY 32 8 KB, in eight times the blocks. The
//   row count is a template parameter (1, 2, 4, 8), so registers follow
//   it. Loads and stores are streaming (ld.global.cs / st.global.cs): the
//   state is not read again before the next step, after gigabytes of other
//   traffic.
// - y: each thread sums its rows in registers; the TNY partial sums of a
//   column meet in shared memory and one thread a column adds them in order.
// - n' is written by the blocks of P tile 0.
// - In place: the destinations may be the sources themselves. Each element
//   of S and of n is read and then written by one thread, and no thread
//   reads an element that another writes, so updating in place is safe.
//   Partly overlapping destinations are not (the wrapper refuses them).
// - Ragged P and N are masked: columns past P and rows past N are neither
//   read nor written.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 8;  // rows of N a thread has in flight, at most

struct Args {
  const void* q;     // (B, G, N) rows, batch stride q_bs elements
  const void* k;     // (B, G, N) rows, batch stride k_bs
  const void* v;     // (B, H, P) rows, batch stride v_bs
  long long q_bs, k_bs, v_bs;
  const float* a;    // (B, H) decay exp(log_a)
  const float* gi;   // (B, H) input gate
  const float* s;    // (B, H, N, P) state
  const float* n;    // (B, H, N) normalizer state
  float* s_out;      // (B, H, N, P), may be s
  float* n_out;      // (B, H, N), may be n
  float* y;          // (B, H, P)
  int H, G, N, P;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <int VEC> struct Vec;
template <> struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T load(const float* p) { return __ldcs((const float4*)p); }
  static __device__ __forceinline__ void store(float* p, T x) { __stcs((float4*)p, x); }
};
template <> struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T load(const float* p) { return __ldcs(p); }
  static __device__ __forceinline__ void store(float* p, T x) { __stcs(p, x); }
};

template <typename T, int VEC, int kRows>
__global__ void __launch_bounds__(kThreads) mamba2_step_kernel(Args p) {
  using V = typename Vec<VEC>::T;
  __shared__ float red[kThreads * VEC];

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh - b * p.H;
  const int g = h / (p.H / p.G);
  const int tx = threadIdx.x, ty = threadIdx.y, CX = blockDim.x, TNY = blockDim.y;
  const int tid = ty * CX + tx;
  const int col = (blockIdx.y * CX + tx) * VEC;  // this thread's first p
  const bool live = col < p.P;                   // VEC divides P, so col + VEC <= P
  const float a = p.a[bh], gi = p.gi[bh];
  const T* kp = (const T*)p.k + b * p.k_bs + (long long)g * p.N;
  const T* qp = (const T*)p.q + b * p.q_bs + (long long)g * p.N;
  const T* vp = (const T*)p.v + b * p.v_bs + (long long)h * p.P;
  const size_t slab = (size_t)bh * p.N * p.P;
  const float* s = p.s + slab;
  float* so = p.s_out + slab;

  float v[VEC], acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    v[j] = live ? to_f32(vp[col + j]) : 0.f;
    acc[j] = 0.f;
  }
  if (live) {
    for (int n0 = ty; n0 < p.N; n0 += TNY * kRows) {
      V sv[kRows];
      float kn[kRows], qn[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int n = n0 + r * TNY;
        if (n < p.N) {
          sv[r] = Vec<VEC>::load(s + (size_t)n * p.P + col);
          kn[r] = to_f32(kp[n]);
          qn[r] = to_f32(qp[n]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int n = n0 + r * TNY;
        if (n < p.N) {
          float* e = reinterpret_cast<float*>(&sv[r]);
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            // the plain version's order: (a * S) + (gi * (k * v))
            e[j] = __fadd_rn(__fmul_rn(a, e[j]), __fmul_rn(gi, __fmul_rn(kn[r], v[j])));
            acc[j] = fmaf(qn[r], e[j], acc[j]);
          }
          Vec<VEC>::store(so + (size_t)n * p.P + col, sv[r]);
        }
      }
    }
  }
  // y: the TNY partial sums of each column, added in order of ty
#pragma unroll
  for (int j = 0; j < VEC; ++j) red[tid * VEC + j] = acc[j];
  __syncthreads();
  const int cols = CX * VEC;
  if (tid < cols && blockIdx.y * cols + tid < p.P) {
    float sum = 0.f;
    for (int t = 0; t < TNY; ++t) sum += red[t * cols + tid];
    p.y[(size_t)bh * p.P + blockIdx.y * cols + tid] = sum;
  }
  if (blockIdx.y == 0) {
    const float* nn = p.n + (size_t)bh * p.N;
    float* no = p.n_out + (size_t)bh * p.N;
    for (int i = tid; i < p.N; i += CX * TNY)
      no[i] = __fadd_rn(__fmul_rn(a, nn[i]), __fmul_rn(gi, to_f32(kp[i])));
  }
}

template <typename T, int VEC>
int launch_rows(const Args& args, dim3 grid, dim3 block, int rows, cudaStream_t stream) {
  if (rows <= 1)
    mamba2_step_kernel<T, VEC, 1><<<grid, block, 0, stream>>>(args);
  else if (rows == 2)
    mamba2_step_kernel<T, VEC, 2><<<grid, block, 0, stream>>>(args);
  else if (rows <= 4)
    mamba2_step_kernel<T, VEC, 4><<<grid, block, 0, stream>>>(args);
  else
    mamba2_step_kernel<T, VEC, kMaxRows><<<grid, block, 0, stream>>>(args);
  return (int)cudaGetLastError();
}

// The tile follows the shape: CX, the P tile's vectors, is the largest of
// 16, 8, 4 that divides P's vectors (else all of them up to 16, the last
// tile masked), TNY = 256 / CX rows of threads, and each thread holds
// ceil(N / TNY) rows (at most kMaxRows at a time) in flight.
template <typename T>
int launch(const Args& args, int B, bool vec4, cudaStream_t stream) {
  const int vec = vec4 ? 4 : 1;
  const int p_vecs = args.P / vec;
  const int widths[] = {16, 8, 4};
  int cx = p_vecs < 16 ? (p_vecs > 0 ? p_vecs : 1) : 16;
  for (int c : widths)
    if (p_vecs > 0 && p_vecs % c == 0) {
      cx = c;
      break;
    }
  const int tny = kThreads / cx;
  const int rows = (args.N + tny - 1) / tny;
  const long long bh = (long long)B * args.H;
  const int tiles = p_vecs > 0 ? (p_vecs + cx - 1) / cx : 1;  // P = 0 still writes n'
  if (bh > 0x7fffffffLL || tiles > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)bh, (unsigned)tiles), block(cx, tny);
  return vec4 ? launch_rows<T, 4>(args, grid, block, rows, stream)
              : launch_rows<T, 1>(args, grid, block, rows, stream);
}

}  // namespace

// dtype: 0 for float32 q, k, v; 1 for bfloat16. Batch strides in elements.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mamba2_step_launch(const void* q, const void* k, const void* v, long long q_bs,
                                  long long k_bs, long long v_bs, const void* a, const void* gi,
                                  const void* s, const void* n, void* s_out, void* n_out, void* y,
                                  int B, int H, int G, int N, int P, int dtype, void* stream) {
  if (B == 0 || H == 0) return 0;
  const Args args{q, k, v, q_bs, k_bs, v_bs, (const float*)a, (const float*)gi,
                  (const float*)s, (const float*)n, (float*)s_out, (float*)n_out, (float*)y,
                  H, G, N, P};
  const bool vec4 = P % 4 == 0 && (uintptr_t)s % 16 == 0 && (uintptr_t)s_out % 16 == 0;
  auto st = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(args, B, vec4, st);
  if (dtype == 1) return launch<__nv_bfloat16>(args, B, vec4, st);
  return (int)cudaErrorInvalidValue;
}
