// Fused uncertainty probe (paper Eq. 2-3) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/swarm_uncertainty/kernel.py::uncertainty_pallas
// (body _uncertainty_kernel), the TPU kernel that streams vocab blocks of the
// (B, N, V) logits through VMEM once and keeps an online logsumexp, sum z*e^z,
// the chosen-token logit and a running top-k buffer in scratch.
//
// What bounds it on the H100: device-memory bytes.  Every logit is read once
// (4 B in f32) and costs one exp, a few FMAs and one compare against the
// thread's k-th largest value: about 2 operations per byte, far below the
// ~295 operations per byte where the card stops being memory-bound.
//
// Design: one block per (b, n) row.  Threads stride over V with coalesced
// loads; each keeps an f32 online (max, sum e^(z-max), sum z*e^(z-max)), the
// chosen logit if it owns that index, and a sorted register top-16 (ties
// kept, so duplicate logits count once per occurrence, as lax.top_k and the
// Pallas _select_topk do).  The vocab loop has a masked tail and needs no
// divisor of V (llama3's 128256, qwen's 152064).  A block merge combines the
// softmax statistics by warp shuffles and takes the top-k by k rounds of a
// block-wide argmax over the threads' list heads.  h_dist divides by log V of
// the full vocabulary.  Masked values use the finite -1e30 of the reference.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int KMAX = 16;           // largest top-k the kernel keeps
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Merge two online-softmax states (m, l = sum e^(z-m), s = sum z e^(z-m)).
__device__ __forceinline__ void merge_stats(float& m, float& l, float& s,
                                            float m2, float l2, float s2) {
  const float mn = fmaxf(m, m2);
  const float c1 = expf(m - mn);
  const float c2 = expf(m2 - mn);
  l = l * c1 + l2 * c2;
  s = s * c1 + s2 * c2;
  m = mn;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
uncertainty_kernel(const T* __restrict__ logits, const int* __restrict__ tokens,
                   float* __restrict__ h_tok, float* __restrict__ v_topk,
                   float* __restrict__ h_dist, int V, int k, float log_v) {
  __shared__ float sm_m[WARPS], sm_l[WARPS], sm_s[WARPS];
  __shared__ float sm_val[WARPS];
  __shared__ int sm_tid[WARPS];
  __shared__ float sm_top[KMAX];
  __shared__ float sm_chosen;
  __shared__ int sm_winner;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T* x = logits + static_cast<long long>(row) * V;
  const int tok = tokens[row];

  if (tid == 0) sm_chosen = NEG;
  float m = NEG, l = 0.f, s = 0.f, chosen = NEG;
  bool owns_tok = false;
  float top[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) top[j] = NEG;

  for (int i = tid; i < V; i += THREADS) {
    const float z = to_f32(x[i]);
    if (z > m) {
      const float c = expf(m - z);
      l = l * c + 1.f;
      s = s * c + z;
      m = z;
    } else {
      const float e = expf(z - m);
      l += e;
      s += e * z;
    }
    if (i == tok) {                // exactly one thread owns index tok
      chosen = z;
      owns_tok = true;
    }
    if (z > top[KMAX - 1]) {       // sorted insertion, duplicates kept
      float c = z;
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        const float hi = fmaxf(top[j], c);
        c = fminf(top[j], c);
        top[j] = hi;
      }
    }
  }

  __syncthreads();                 // orders thread 0's sm_chosen init first
  if (owns_tok) sm_chosen = chosen;

  // ---- softmax statistics: warp shuffles, then thread 0 over the warps ----
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge_stats(m, l, s, m2, l2, s2);
  }
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
    sm_s[warp] = s;
  }

  // ---- top-k: k rounds of a block argmax over each thread's list head ----
  for (int r = 0; r < k; ++r) {
    float bv = top[0];
    int bt = tid;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float v2 = __shfl_xor_sync(0xffffffffu, bv, off);
      const int t2 = __shfl_xor_sync(0xffffffffu, bt, off);
      if (v2 > bv || (v2 == bv && t2 < bt)) {
        bv = v2;
        bt = t2;
      }
    }
    if (lane == 0) {
      sm_val[warp] = bv;
      sm_tid[warp] = bt;
    }
    __syncthreads();
    if (tid == 0) {
      float wv = sm_val[0];
      int wt = sm_tid[0];
      for (int w = 1; w < WARPS; ++w) {
        if (sm_val[w] > wv || (sm_val[w] == wv && sm_tid[w] < wt)) {
          wv = sm_val[w];
          wt = sm_tid[w];
        }
      }
      sm_top[r] = wv;
      sm_winner = wt;
    }
    __syncthreads();
    if (tid == sm_winner) {        // pop the winner's head
#pragma unroll
      for (int j = 0; j < KMAX - 1; ++j) top[j] = top[j + 1];
      top[KMAX - 1] = NEG;
    }
    __syncthreads();               // sm_winner is rewritten next round
  }

  if (tid == 0) {
    float M = sm_m[0], L = sm_l[0], S = sm_s[0];
    for (int w = 1; w < WARPS; ++w) merge_stats(M, L, S, sm_m[w], sm_l[w], sm_s[w]);
    const float log_l = logf(fmaxf(L, 1e-30f));
    const float logp = sm_chosen - M - log_l;
    const float p = expf(logp);
    h_tok[row] = -p * logp;                                  // Eq. 2
    h_dist[row] = (log_l + M - S / fmaxf(L, 1e-30f)) / log_v;
    float mean = 0.f;
    for (int j = 0; j < k; ++j) mean += sm_top[j];
    mean /= static_cast<float>(k);
    float var = 0.f;
    for (int j = 0; j < k; ++j) {
      const float d = sm_top[j] - mean;
      var += d * d;
    }
    v_topk[row] = var / static_cast<float>(k);               // Eq. 3
  }
}

}  // namespace

// logits (R, V) f32 (dtype 0) or bf16 (dtype 1), tokens (R,) int32;
// outputs h_token, v_topk, h_dist (R,) f32.  Returns cudaGetLastError().
extern "C" int swarm_uncertainty(const void* logits, const void* tokens,
                                 void* h_tok, void* v_topk, void* h_dist,
                                 int R, int V, int k, int dtype, float log_v,
                                 void* stream) {
  if (k < 1 || k > KMAX || V < k || R < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tk = static_cast<const int*>(tokens);
  float* h = static_cast<float*>(h_tok);
  float* v = static_cast<float*>(v_topk);
  float* hd = static_cast<float*>(h_dist);
  if (dtype == 0) {
    uncertainty_kernel<float><<<R, THREADS, 0, st>>>(
        static_cast<const float*>(logits), tk, h, v, hd, V, k, log_v);
  } else if (dtype == 1) {
    uncertainty_kernel<__nv_bfloat16><<<R, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(logits), tk, h, v, hd, V, k, log_v);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
