// GQA flash attention for Hopper (sm_90a), two mask modes of one tile body.
//
// Replaces, in src/repro/kernels/flash_attention/kernel.py:
//
// * flash_attention_positions_pallas (body _flash_positions_kernel), the
//   serving prefill: causal and window masks come from per-token
//   q_positions (S,) / kv_positions (T,) shared across the batch, a
//   negative position means padding or an empty slot, and every KV block is
//   visited (entry point flash_attention_positions);
// * flash_attention_pallas (body _flash_kernel), the full-sequence forward
//   of the safety encoder (bidirectional) and of transformer.forward
//   (causal): masks come from grid offsets, query row i and key column j
//   counted from 0, and KV tiles that no row of a q tile can see are skipped
//   -- past the diagonal in causal mode, below the window with one (entry
//   point flash_attention).
//
// Both run the softmax online in f32 with the scale D**-0.5, fill masked
// scores with the finite -1e30 and divide the output by max(l, 1e-30).
//
// What bounds it on the H100: at the prefill and forward shapes (S = T of a
// few hundred to a few thousand, D = 32, 64 or 128) the work is 4*S*T*D
// operations per head (half of that when causal) against
// 2*(S*H + 2*T*K)*D bytes, so the tensor-core bound is operations and the
// memory bound is far lower.  This first kernel runs the products on the
// CUDA cores in f32, like the Pallas kernel and the *_ref oracles after
// their loads, and is compute-bound on those cores; wgmma and TMA staging
// are left for a later kernel.
//
// Design: one block (4 warps) per (b, head, 64-row q tile); each warp owns 16
// query rows.  The q tile stays in shared memory; the block walks K/V in
// tiles of 32 slots staged in shared memory (K rows padded by one float so
// lane t reading row t is free of bank conflicts) over the range of tiles
// its rows can see: all of them in positions mode, [first tile the first
// row's window reaches, last tile the last row's diagonal reaches] in grid
// mode.  For each of its rows a warp scores slot t on lane t, takes the
// tile max and sum by shuffles, and updates the row's running (max, sum)
// and its D-wide accumulator (kept in shared memory, lane j owning columns
// j, j+32, ...).  Head h reads KV head h / G, for any G.  S and T need not be
// multiples of a tile: rows past S are skipped and slots past T take -inf,
// so they weigh exactly zero.  Masked scores take the finite -1e30 of the
// reference, so a row with nothing valid (a padding row in positions mode)
// comes out as the mean of V over the visited slots, never NaN.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BQ = 64;             // query rows per block
constexpr int ROWS = BQ / WARPS;   // query rows per warp
constexpr int BK = 32;             // KV slots per tile: one per lane
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

// NDL = number of D-elements each lane owns (D <= 32 * NDL).  GRID: masks
// from grid offsets (qpos/kvpos unused) with tile skipping; else from the
// position operands, every tile visited.
template <typename T, int NDL, bool GRID>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ qpos,
             const int* __restrict__ kvpos, T* __restrict__ out, int S,
             int Tlen, int H, int K, int D, int causal, int window,
             float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                          // (BQ, D)
  float* acc = qs + BQ * D;                  // (BQ, D)
  float* ks = acc + BQ * D;                  // (BK, D + 1)
  float* vs = ks + BK * (D + 1);             // (BK, D)
  float* ms = vs + BK * D;                   // (BQ,)
  float* ls = ms + BQ;                       // (BQ,)

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);                // GQA: head h reads KV head h/G
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const long long q_row = static_cast<long long>(H) * D;     // stride of s
  const long long q_base = static_cast<long long>(b) * S * q_row +
                           static_cast<long long>(h) * D;
  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D;
    const int d = e - r * D;
    const int s = q0 + r;
    qs[e] = s < S ? to_f32(q[q_base + s * q_row + d]) : 0.f;
    acc[e] = 0.f;
  }
  for (int r = tid; r < BQ; r += THREADS) {
    ms[r] = NEG;
    ls[r] = 0.f;
  }

  const long long kv_row = static_cast<long long>(K) * D;
  const long long kv_base = static_cast<long long>(b) * Tlen * kv_row +
                            static_cast<long long>(kh) * D;

  // the KV tiles this q tile can see (grid mode skips the others)
  int t_begin = 0, t_end = Tlen;
  if (GRID) {
    if (causal) t_end = min(Tlen, min(q0 + BQ, S));   // keys <= last row
    if (window > 0) t_begin = max(0, q0 - window + 1) / BK * BK;
  }

  for (int t0 = t_begin; t0 < t_end; t0 += BK) {
    __syncthreads();                         // previous tile fully consumed
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D;
      const int d = e - r * D;
      const int t = t0 + r;
      float kv = 0.f, vv = 0.f;
      if (t < Tlen) {
        const long long off = kv_base + t * kv_row + d;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      ks[r * (D + 1) + d] = kv;
      vs[r * D + d] = vv;
    }
    __syncthreads();

    const int t = t0 + lane;
    const bool in_range = t < Tlen;
    const int kp = GRID ? t : (in_range ? kvpos[t] : -1);
    const float* kr = ks + lane * (D + 1);
    for (int i = 0; i < ROWS; ++i) {
      const int r = warp * ROWS + i;
      const int s = q0 + r;
      if (s >= S) break;                     // warp-uniform
      // grid mode: a row that sees no key of this tile skips it (it would
      // add only zero weights once the row has seen a valid key)
      if (GRID && causal && s < t0) continue;
      if (GRID && window > 0 && s - (t0 + BK - 1) >= window) continue;
      const int qp = GRID ? s : qpos[s];
      const float* qr = qs + r * D;
      float sc = 0.f;
      for (int d = 0; d < D; ++d) sc += qr[d] * kr[d];
      sc *= scale;
      bool valid = GRID || kp >= 0;
      if (causal) valid = valid && qp >= kp;
      if (window > 0) valid = valid && qp - kp < window;
      sc = in_range ? (valid ? sc : NEG) : -CUDART_INF_F;
      const float mo = ms[r];
      const float mn = fmaxf(mo, warp_max(sc));
      const float pe = expf(sc - mn);
      const float corr = expf(mo - mn);
      const float lsum = warp_sum(pe);       // also syncs the warp's reads
      float a[NDL];
#pragma unroll
      for (int j = 0; j < NDL; ++j) {
        const int d = lane + 32 * j;
        a[j] = d < D ? acc[r * D + d] * corr : 0.f;
      }
#pragma unroll 8
      for (int tt = 0; tt < BK; ++tt) {
        const float pt = __shfl_sync(0xffffffffu, pe, tt);
#pragma unroll
        for (int j = 0; j < NDL; ++j) {
          const int d = lane + 32 * j;
          if (d < D) a[j] += pt * vs[tt * D + d];
        }
      }
#pragma unroll
      for (int j = 0; j < NDL; ++j) {
        const int d = lane + 32 * j;
        if (d < D) acc[r * D + d] = a[j];
      }
      if (lane == 0) {
        ms[r] = mn;
        ls[r] = ls[r] * corr + lsum;
      }
      __syncwarp();
    }
  }

  __syncthreads();
  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D;
    const int d = e - r * D;
    const int s = q0 + r;
    if (s < S)
      store(out + q_base + s * q_row + d, acc[e] / fmaxf(ls[r], 1e-30f));
  }
}

template <typename T, int NDL, bool GRID>
int launch(const void* q, const void* k, const void* v, const void* qpos,
           const void* kvpos, void* out, int B, int S, int Tlen, int H, int K,
           int D, int causal, int window, float scale, cudaStream_t st) {
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(BQ) * D +
                                       BK * (D + 1) + BK * D + 2 * BQ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, NDL, GRID>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_kernel<T, NDL, GRID><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(qpos),
      static_cast<const int*>(kvpos), static_cast<T*>(out), S, Tlen, H, K, D,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool GRID>
int dispatch_d(const void* q, const void* k, const void* v, const void* qpos,
               const void* kvpos, void* out, int B, int S, int Tlen, int H,
               int K, int D, int causal, int window, float scale,
               cudaStream_t st) {
  if (D <= 32)
    return launch<T, 1, GRID>(q, k, v, qpos, kvpos, out, B, S, Tlen, H, K, D,
                              causal, window, scale, st);
  if (D <= 64)
    return launch<T, 2, GRID>(q, k, v, qpos, kvpos, out, B, S, Tlen, H, K, D,
                              causal, window, scale, st);
  if (D <= 128)
    return launch<T, 4, GRID>(q, k, v, qpos, kvpos, out, B, S, Tlen, H, K, D,
                              causal, window, scale, st);
  return launch<T, 8, GRID>(q, k, v, qpos, kvpos, out, B, S, Tlen, H, K, D,
                            causal, window, scale, st);
}

template <bool GRID>
int dispatch(const void* q, const void* k, const void* v, const void* qpos,
             const void* kvpos, void* out, int B, int S, int Tlen, int H,
             int K, int D, int causal, int window, float scale, int dtype,
             void* stream) {
  if (B < 1 || S < 1 || Tlen < 1 || K < 1 || H % K != 0 || D < 1 || D > 256 ||
      H > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float, GRID>(q, k, v, qpos, kvpos, out, B, S, Tlen, H,
                                   K, D, causal, window, scale, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16, GRID>(q, k, v, qpos, kvpos, out, B, S,
                                           Tlen, H, K, D, causal, window,
                                           scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, S, H, D); k, v (B, T, K, D) with H % K == 0; q_positions (S,) and
// kv_positions (T,) int32; out (B, S, H, D) in q's type: f32 (dtype 0) or
// bf16 (dtype 1).  window <= 0 means no window.  Returns cudaGetLastError().
extern "C" int flash_attention_positions(const void* q, const void* k,
                                         const void* v, const void* qpos,
                                         const void* kvpos, void* out, int B,
                                         int S, int Tlen, int H, int K, int D,
                                         int causal, int window, float scale,
                                         int dtype, void* stream) {
  return dispatch<false>(q, k, v, qpos, kvpos, out, B, S, Tlen, H, K, D,
                         causal, window, scale, dtype, stream);
}

// The same operands without positions: query row i and key column j count
// from 0 (causal: i >= j; window: i - j < window).  Returns
// cudaGetLastError().
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int S, int Tlen, int H, int K,
                               int D, int causal, int window, float scale,
                               int dtype, void* stream) {
  return dispatch<true>(q, k, v, nullptr, nullptr, out, B, S, Tlen, H, K, D,
                        causal, window, scale, dtype, stream);
}
