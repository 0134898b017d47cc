// One-token GQA decode attention over a monolithic (B, T) KV cache, for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention/kernel.py::decode_attention_pallas
// (body _decode_kernel), which streams the cache through VMEM once per
// (batch, kv-head) with the G query heads of the group resident.  The JAX
// engine runs its XLA twin models/attention.py::_decode_attend on this path;
// both compute the same function.
//
// What bounds it on the H100: device-memory bytes.  Each cached K and V row
// is read once per step and used for 2*G FMAs per element (G = 3 for
// smollm-135m, 4 for llama3-8b): a few operations per byte, far below the
// ~295 where the card would be compute-bound.
//
// Design: one block (4 warps) per (b, kv-head).  The G queries are loaded
// once into shared memory.  The block walks the cache in tiles of 32 slots:
// K and V of the tile are staged in shared memory (K rows padded by one float
// so that lane t reading row t is free of bank conflicts), lane t scores
// slot t for each query the warp owns, and the warp keeps an f32 online
// softmax (running max, sum and a D-wide accumulator spread over the lanes)
// in registers.  A slot is valid when 0 <= pos <= index, and also
// index - pos < window for windowed layers.  Invalid slots get the finite
// -1e30 of the reference, so a row with no valid slot comes out as the mean
// of V over all T slots, like the Pallas kernel and the XLA oracle.  Slots
// past T in the last tile get -inf and weigh exactly zero.  The output is
// divided by max(l, 1e-30).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TILE = 32;           // cache slots per tile: one per lane
constexpr int GPW_MAX = 4;         // queries per warp: G <= WARPS * GPW_MAX
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// NDL = number of D-elements each lane owns (D <= 32 * NDL).
template <typename T, int NDL>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ pos,
              const int* __restrict__ index, T* __restrict__ out, int Tlen,
              int K, int G, int D, int window, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                          // (G, D)
  float* ks = qs + G * D;                    // (TILE, D + 1)
  float* vs = ks + TILE * (D + 1);           // (TILE, D)

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int idx = index[b];

  const long long q_off = (static_cast<long long>(b) * K + kh) * G * D;
  for (int e = tid; e < G * D; e += THREADS) qs[e] = to_f32(q[q_off + e]);

  float m[GPW_MAX], l[GPW_MAX], acc[GPW_MAX][NDL];
#pragma unroll
  for (int i = 0; i < GPW_MAX; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NDL; ++j) acc[i][j] = 0.f;
  }

  const long long row_stride = static_cast<long long>(K) * D;
  const long long kv_base = static_cast<long long>(b) * Tlen * row_stride +
                            static_cast<long long>(kh) * D;

  for (int t0 = 0; t0 < Tlen; t0 += TILE) {
    __syncthreads();                         // previous tile fully consumed
    for (int e = tid; e < TILE * D; e += THREADS) {
      const int r = e / D;
      const int d = e - r * D;
      const int t = t0 + r;
      float kv = 0.f, vv = 0.f;
      if (t < Tlen) {
        const long long off = kv_base + t * row_stride + d;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      ks[r * (D + 1) + d] = kv;
      vs[r * D + d] = vv;
    }
    __syncthreads();

    const int t = t0 + lane;
    const bool in_range = t < Tlen;
    bool valid = false;
    if (in_range) {
      const int p = pos[static_cast<long long>(b) * Tlen + t];
      valid = p >= 0 && p <= idx && (window <= 0 || idx - p < window);
    }
#pragma unroll
    for (int i = 0; i < GPW_MAX; ++i) {
      const int g = warp + WARPS * i;
      if (g >= G) break;                     // warp-uniform
      const float* qg = qs + g * D;
      const float* kr = ks + lane * (D + 1);
      float sc = 0.f;
      for (int d = 0; d < D; ++d) sc += qg[d] * kr[d];
      sc *= scale;
      sc = in_range ? (valid ? sc : NEG) : -CUDART_INF_F;
      const float mn = fmaxf(m[i], warp_max(sc));
      const float pe = expf(sc - mn);
      const float corr = expf(m[i] - mn);
      l[i] = l[i] * corr + warp_sum(pe);
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < NDL; ++j) acc[i][j] *= corr;
#pragma unroll 8
      for (int tt = 0; tt < TILE; ++tt) {
        const float pt = __shfl_sync(0xffffffffu, pe, tt);
#pragma unroll
        for (int j = 0; j < NDL; ++j) {
          const int d = lane + 32 * j;
          if (d < D) acc[i][j] += pt * vs[tt * D + d];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < GPW_MAX; ++i) {
    const int g = warp + WARPS * i;
    if (g >= G) break;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NDL; ++j) {
      const int d = lane + 32 * j;
      if (d < D) store(out + q_off + g * D + d, acc[i][j] * inv);
    }
  }
}

template <typename T, int NDL>
int launch(const void* q, const void* k, const void* v, const void* pos,
           const void* index, void* out, int B, int Tlen, int K, int G, int D,
           int window, float scale, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(G) * D + TILE * (D + 1) + TILE * D);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, NDL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(K, B);
  decode_kernel<T, NDL><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pos),
      static_cast<const int*>(index), static_cast<T*>(out), Tlen, K, G, D,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const void* pos,
               const void* index, void* out, int B, int Tlen, int K, int G,
               int D, int window, float scale, cudaStream_t st) {
  if (D <= 32)
    return launch<T, 1>(q, k, v, pos, index, out, B, Tlen, K, G, D, window, scale, st);
  if (D <= 64)
    return launch<T, 2>(q, k, v, pos, index, out, B, Tlen, K, G, D, window, scale, st);
  if (D <= 128)
    return launch<T, 4>(q, k, v, pos, index, out, B, Tlen, K, G, D, window, scale, st);
  return launch<T, 8>(q, k, v, pos, index, out, B, Tlen, K, G, D, window, scale, st);
}

}  // namespace

// q (B, K, G, D); k, v (B, T, K, D); pos (B, T) int32; index (B,) int32;
// out (B, K, G, D) in q's type: f32 (dtype 0) or bf16 (dtype 1).
// window <= 0 means no window.  Returns cudaGetLastError().
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* pos, const void* index, void* out,
                                int B, int Tlen, int K, int G, int D,
                                int window, float scale, int dtype,
                                void* stream) {
  if (B < 1 || Tlen < 1 || K < 1 || G < 1 || G > WARPS * GPW_MAX || D < 1 ||
      D > 256)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, pos, index, out, B, Tlen, K, G, D, window, scale, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, pos, index, out, B, Tlen, K, G, D, window,
                                     scale, st);
  return cudaErrorInvalidValue;
}
