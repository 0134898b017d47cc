// One-token GQA decode attention for Hopper (sm_90a), two entry points that
// share one tile body (tile_step):
//
// * decode_attention: over a monolithic (B, T) KV cache.
//   Replaces: src/repro/kernels/decode_attention/kernel.py::
//   decode_attention_pallas (body _decode_kernel).
// * paged_decode_attention: through a (B, nb) block table over a block pool
//   (N, L, K, D), plus this dispatch's delta rows, with bf16/f32 or int8/fp8
//   pools.  Replaces: src/repro/kernels/decode_attention/kernel.py::
//   paged_decode_attention_pallas (body _paged_decode_kernel).
//
// What bounds them on the H100: device-memory bytes.  Each cached K and V
// row is read once per step and used for 2*G FMAs per element (G = 3 for
// smollm-135m, 4 for llama3-8b): a few operations per byte, far below the
// ~295 where the card would be compute-bound.  An int8/fp8 pool halves the
// bytes of a bf16 one (plus one f32 scale per row and head).
//
// Design: one block (4 warps) per (b, kv-head).  The G queries are loaded
// once into shared memory.  The block walks its keys in tiles of 32 rows:
// K and V of the tile are staged in shared memory as f32 (K rows padded by
// one float so that lane t reading row t is free of bank conflicts), lane t
// scores row t for each query the warp owns, and the warp keeps an f32
// online softmax (running max, sum and a D-wide accumulator spread over the
// lanes) in registers.  Masked rows get the finite -1e30 of the reference,
// so a row with no valid key comes out as the mean of V over the rows the
// block visited; rows past the end of a tile get -inf and weigh exactly
// zero.  The output is divided by max(l, 1e-30).
//
// The paged kernel visits the row's table entries in order.  A sentinel
// entry (id < 0 or >= N: an empty serve slot) is skipped without a load, so
// unlike the plain version (which gathers a clamped block and masks it) a
// row with no valid key averages V over the visited blocks only.  A visited
// block's rows are valid when 0 <= pos <= index (and index - pos < window)
// and the dispatch has not rewritten the slot ("covered": linear slots
// [p0, index], or for ring layers (slot - p0) mod (nb*L) <= index - p0, a
// floor modulo written ((x % n) + n) % n).  The last step attends the S
// delta rows (valid when 0 <= dpos <= index, within the window and, for
// ring layers, dpos > index - nb*L) and emits.  With a quantized pool the
// k-scale multiplies the score after the QK product, the mask comes after
// that, the softmax sum takes the unscaled weight, and the v-scale
// multiplies the weight before the PV product; delta rows take neither.
// All offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TILE = 32;           // key rows per tile: one per lane
constexpr int GPW_MAX = 4;         // queries per warp: G <= WARPS * GPW_MAX
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
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

// Per-warp online-softmax state: NDL = D-elements each lane owns
// (D <= 32 * NDL).
template <int NDL>
struct SoftmaxState {
  float m[GPW_MAX], l[GPW_MAX], acc[GPW_MAX][NDL];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < GPW_MAX; ++i) {
      m[i] = NEG;
      l[i] = 0.f;
#pragma unroll
      for (int j = 0; j < NDL; ++j) acc[i][j] = 0.f;
    }
  }
};

// Stage rows [0, nrows) of a tile in shared memory (f32) and fold them into
// the softmax.  Row r lies at elem[row0 + r * row_stride + d].  Lane r's
// row is valid per ``valid`` (masked to -1e30 otherwise) and carries the
// score and weight factors kscale / vscale (1 for unquantized rows).
// Called by every thread of the block.
template <typename TK, int NDL>
__device__ __forceinline__ void tile_step(
    const TK* __restrict__ k, const TK* __restrict__ v, long long row0,
    long long row_stride, int nrows, bool valid, float kscale, float vscale,
    const float* qs, float* ks, float* vs, int G, int D, float scale,
    SoftmaxState<NDL>& st) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  __syncthreads();                           // previous tile fully consumed
  for (int e = tid; e < TILE * D; e += THREADS) {
    const int r = e / D;
    const int d = e - r * D;
    float kv = 0.f, vv = 0.f;
    if (r < nrows) {
      const long long off = row0 + r * row_stride + d;
      kv = to_f32(k[off]);
      vv = to_f32(v[off]);
    }
    ks[r * (D + 1) + d] = kv;
    vs[r * D + d] = vv;
  }
  __syncthreads();

  const bool in_range = lane < nrows;
#pragma unroll
  for (int i = 0; i < GPW_MAX; ++i) {
    const int g = warp + WARPS * i;
    if (g >= G) break;                       // warp-uniform
    const float* qg = qs + g * D;
    const float* kr = ks + lane * (D + 1);
    float sc = 0.f;
    for (int d = 0; d < D; ++d) sc += qg[d] * kr[d];
    sc = sc * scale * kscale;
    sc = in_range ? (valid ? sc : NEG) : -CUDART_INF_F;
    const float mn = fmaxf(st.m[i], warp_max(sc));
    const float pe = expf(sc - mn);
    const float corr = expf(st.m[i] - mn);
    st.l[i] = st.l[i] * corr + warp_sum(pe);
    st.m[i] = mn;
    const float pv = pe * vscale;
#pragma unroll
    for (int j = 0; j < NDL; ++j) st.acc[i][j] *= corr;
#pragma unroll 8
    for (int tt = 0; tt < TILE; ++tt) {
      const float pt = __shfl_sync(0xffffffffu, pv, tt);
#pragma unroll
      for (int j = 0; j < NDL; ++j) {
        const int d = lane + 32 * j;
        if (d < D) st.acc[i][j] += pt * vs[tt * D + d];
      }
    }
  }
}

template <typename T, int NDL>
__device__ __forceinline__ void load_q(const T* __restrict__ q,
                                       long long q_off, int G, int D,
                                       float* qs) {
  for (int e = threadIdx.x; e < G * D; e += THREADS)
    qs[e] = to_f32(q[q_off + e]);
}

template <typename T, int NDL>
__device__ __forceinline__ void emit(const SoftmaxState<NDL>& st,
                                     T* __restrict__ out, long long q_off,
                                     int G, int D) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < GPW_MAX; ++i) {
    const int g = warp + WARPS * i;
    if (g >= G) break;
    const float inv = 1.f / fmaxf(st.l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NDL; ++j) {
      const int d = lane + 32 * j;
      if (d < D) store(out + q_off + g * D + d, st.acc[i][j] * inv);
    }
  }
}

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
  const int lane = threadIdx.x & 31;
  const int idx = index[b];
  const long long q_off = (static_cast<long long>(b) * K + kh) * G * D;
  load_q<T, NDL>(q, q_off, G, D, qs);
  SoftmaxState<NDL> st;
  st.init();

  const long long row_stride = static_cast<long long>(K) * D;
  const long long kv_base = static_cast<long long>(b) * Tlen * row_stride +
                            static_cast<long long>(kh) * D;
  for (int t0 = 0; t0 < Tlen; t0 += TILE) {
    const int t = t0 + lane;
    bool valid = false;
    if (t < Tlen) {
      const int p = pos[static_cast<long long>(b) * Tlen + t];
      valid = p >= 0 && p <= idx && (window <= 0 || idx - p < window);
    }
    tile_step<T, NDL>(k, v, kv_base + t0 * row_stride, row_stride,
                      min(TILE, Tlen - t0), valid, 1.f, 1.f, qs, ks, vs, G,
                      D, scale, st);
  }
  emit<T, NDL>(st, out, q_off, G, D);
}

// T: q, delta and out type; TP: pool element type (T itself, or int8 /
// fp8 with f32 scales).
template <typename T, typename TP, int NDL>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const TP* __restrict__ kp,
                    const TP* __restrict__ vp,
                    const float* __restrict__ ksc,
                    const float* __restrict__ vsc,
                    const int* __restrict__ pos_pool,
                    const int* __restrict__ table,
                    const int* __restrict__ index,
                    const int* __restrict__ p0s, const T* __restrict__ dk,
                    const T* __restrict__ dv, const int* __restrict__ dpos,
                    T* __restrict__ out, int N, int L, int nb, int S, int K,
                    int G, int D, int window, int ring, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                          // (G, D)
  float* ks = qs + G * D;                    // (TILE, D + 1)
  float* vs = ks + TILE * (D + 1);           // (TILE, D)

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int idx = index[b];
  const int p0 = S > 0 ? p0s[b] : 0;
  const int ring_len = nb * L;
  const long long q_off = (static_cast<long long>(b) * K + kh) * G * D;
  load_q<T, NDL>(q, q_off, G, D, qs);
  SoftmaxState<NDL> st;
  st.init();

  const long long row_stride = static_cast<long long>(K) * D;
  for (int t = 0; t < nb; ++t) {
    const int blk = table[static_cast<long long>(b) * nb + t];
    if (blk < 0 || blk >= N) continue;       // sentinel: block-uniform skip
    const long long blk_row = static_cast<long long>(blk) * L;
    for (int r0 = 0; r0 < L; r0 += TILE) {
      const int r = r0 + lane;
      bool valid = false;
      float kscale = 1.f, vscale = 1.f;
      if (r < L) {
        const int p = pos_pool[blk_row + r];
        const int sl = t * L + r;
        bool covered = false;             // nothing without delta rows
        if (S > 0 && ring) {
          const int x = (sl - p0) % ring_len;
          covered = ((x + ring_len) % ring_len) <= idx - p0;
        } else if (S > 0) {
          covered = sl >= p0 && sl <= idx;
        }
        valid = p >= 0 && p <= idx && (window <= 0 || idx - p < window) &&
                !covered;
        if (ksc != nullptr) {
          const long long so = (blk_row + r) * K + kh;
          kscale = ksc[so];
          vscale = vsc[so];
        }
      }
      tile_step<TP, NDL>(kp, vp, (blk_row + r0) * row_stride + kh * D,
                         row_stride, min(TILE, L - r0), valid, kscale,
                         vscale, qs, ks, vs, G, D, scale, st);
    }
  }
  for (int s0 = 0; s0 < S; s0 += TILE) {     // this dispatch's delta rows
    const int s = s0 + lane;
    bool valid = false;
    if (s < S) {
      const int p = dpos[static_cast<long long>(b) * S + s];
      valid = p >= 0 && p <= idx && (window <= 0 || idx - p < window) &&
              (!ring || p > idx - ring_len);
    }
    tile_step<T, NDL>(dk, dv,
                      (static_cast<long long>(b) * S + s0) * row_stride +
                          kh * D,
                      row_stride, min(TILE, S - s0), valid, 1.f, 1.f, qs, ks,
                      vs, G, D, scale, st);
  }
  emit<T, NDL>(st, out, q_off, G, D);
}

size_t smem_bytes(int G, int D) {
  return sizeof(float) *
         (static_cast<size_t>(G) * D + TILE * (D + 1) + TILE * D);
}

template <typename T, int NDL>
int launch(const void* q, const void* k, const void* v, const void* pos,
           const void* index, void* out, int B, int Tlen, int K, int G, int D,
           int window, float scale, cudaStream_t st) {
  const size_t smem = smem_bytes(G, D);
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

struct PagedArgs {
  const void *q, *kp, *vp, *ksc, *vsc, *pos, *table, *index, *p0, *dk, *dv,
      *dpos;
  void* out;
  int B, N, L, nb, S, K, G, D, window, ring;
  float scale;
};

template <typename T, typename TP, int NDL>
int launch_paged(const PagedArgs& a, cudaStream_t st) {
  const size_t smem = smem_bytes(a.G, a.D);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T, TP, NDL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(a.K, a.B);
  paged_decode_kernel<T, TP, NDL><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(a.q), static_cast<const TP*>(a.kp),
      static_cast<const TP*>(a.vp), static_cast<const float*>(a.ksc),
      static_cast<const float*>(a.vsc), static_cast<const int*>(a.pos),
      static_cast<const int*>(a.table), static_cast<const int*>(a.index),
      static_cast<const int*>(a.p0), static_cast<const T*>(a.dk),
      static_cast<const T*>(a.dv), static_cast<const int*>(a.dpos),
      static_cast<T*>(a.out), a.N, a.L, a.nb, a.S, a.K, a.G, a.D, a.window,
      a.ring, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TP>
int paged_dispatch_d(const PagedArgs& a, cudaStream_t st) {
  if (a.D <= 32) return launch_paged<T, TP, 1>(a, st);
  if (a.D <= 64) return launch_paged<T, TP, 2>(a, st);
  if (a.D <= 128) return launch_paged<T, TP, 4>(a, st);
  return launch_paged<T, TP, 8>(a, st);
}

template <typename T>
int paged_dispatch_pool(const PagedArgs& a, int pool_dtype, int dtype,
                        cudaStream_t st) {
  if (pool_dtype == dtype) return paged_dispatch_d<T, T>(a, st);
  if (pool_dtype == 2) return paged_dispatch_d<T, int8_t>(a, st);
  if (pool_dtype == 3) return paged_dispatch_d<T, __nv_fp8_e4m3>(a, st);
  return cudaErrorInvalidValue;
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

// q (B, K, G, D); k_pool, v_pool (N, L, K, D) of pool_dtype (0 f32, 1 bf16,
// 2 int8, 3 fp8 e4m3; 2 and 3 need k_scale, v_scale (N, L, K) f32, else
// null); pos_pool (N, L) int32; table (B, nb) int32; index, p0 (B,) int32;
// delta_k, delta_v (B, S, K, D) and out (B, K, G, D) of dtype (0 f32,
// 1 bf16); delta_pos (B, S) int32.  S = 0 attends the pool alone and masks
// no slot as covered (the delta pointers may then be null, p0 is unread).
// window <= 0 means no window; ring != 0 takes the table as a ring of nb*L
// slots.  Returns cudaGetLastError().
extern "C" int paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* pos_pool,
    const void* table, const void* index, const void* p0,
    const void* delta_k, const void* delta_v, const void* delta_pos,
    void* out, int B, int N, int L, int nb, int S, int K, int G, int D,
    int window, int ring, float scale, int dtype, int pool_dtype,
    void* stream) {
  if (B < 1 || N < 1 || L < 1 || nb < 1 || S < 0 || K < 1 || G < 1 ||
      G > WARPS * GPW_MAX || D < 1 || D > 256)
    return cudaErrorInvalidValue;
  const bool quantized = pool_dtype == 2 || pool_dtype == 3;
  if (quantized != (k_scale != nullptr && v_scale != nullptr))
    return cudaErrorInvalidValue;
  PagedArgs a{q,    k_pool, v_pool, k_scale, v_scale, pos_pool, table,
              index, p0,    delta_k, delta_v, delta_pos, out, B, N, L, nb,
              S,    K,      G,      D,       window,  ring,     scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return paged_dispatch_pool<float>(a, pool_dtype, 0, st);
  if (dtype == 1)
    return paged_dispatch_pool<__nv_bfloat16>(a, pool_dtype, 1, st);
  return cudaErrorInvalidValue;
}
