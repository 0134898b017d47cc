// Fused uncertainty probe (paper Eq. 2-3) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/swarm_uncertainty/kernel.py::uncertainty_pallas
// (body _uncertainty_kernel), the TPU kernel that streams vocab blocks of the
// (B, N, V) logits through VMEM once, in grid order, and keeps an online
// logsumexp, sum z*e^z, the chosen-token logit and a running top-k buffer in
// scratch.
//
// What bounds it on the H100: device-memory bytes.  Every logit is read once
// (4 B in f32, 2 B in bf16) and costs one exp2, a few FMAs and, for the few
// that beat the warp's k-th value, a store to the warp's candidate buffer:
// about 2 operations per byte, far below the ~295 operations per byte where
// the card stops being memory-bound.  A row is 64-608 KB while the main
// path has 8-50 rows, so one block per row streams at a single SM's rate:
// the row must be split.
//
// Design (one launch, no global workspace, no atomics, nothing to reset):
// * The grid is (splits * rows) blocks; the `splits` blocks of a row are one
//   thread-block cluster, and block `rank` takes the row's logits
//   [rank * chunk, min(V, (rank + 1) * chunk)).  The wrapper's plan
//   (kernels/swarm_uncertainty/ops.py, uncertainty_plan) picks splits <= 8
//   (the portable cluster size) and a chunk that is a multiple of 8
//   elements, so every chunk start keeps its row's 16-byte phase.
// * A block streams its chunk's 16-byte aligned body with evict-first
//   16-byte loads (float4 in f32, 8 bf16 in a uint4): thread t takes vectors
//   t, t + THREADS, ..., UNROLL of them a round, and loads the next round's
//   before it folds this one's, so up to 2 * UNROLL vectors a thread are in
//   flight and no barrier stops a warp.  A scalar head (up to the first
//   16-byte boundary) and tail (V's remainder) go to threads 0-7, so odd
//   vocabularies and any element-aligned row start work.
// * Per lane, an f32 online (m, l = sum e^(z-m), s = sum z e^(z-m)),
//   rescaled at most once per vector (after the vector's max), with
//   e = ex2((z - m) * log2 e).
// * Per warp, the top-k candidates (WarpStream): a logit enters the warp's
//   shared-memory buffer (ballot, popc, one store) only if it beats `kth`, a
//   lower bound of the k-th largest in the buffer.  The first vector seeds
//   `kth` with the k-th largest of the lanes' maxima; a buffer past
//   CAP_TRIGGER entries, and the end of the chunk, compact it to the warp's
//   sorted top-k by k rounds of a warp argmax (redux.sync on an
//   order-preserving key), which raises `kth` to their k-th.  Few logits
//   ever enter, so the stream stays a stream.  Ties keep every occurrence,
//   as lax.top_k and the Pallas _select_topk do.  The lists are LK long: 10
//   for the gateway's k = 10 (UncertaintyConfig.top_k), 16 for any other
//   k <= 16.
// * Each warp leaves its sorted top-k and its (m, l, s), merged by shuffles,
//   in shared memory.  After one cluster barrier, in warp 0 of rank 0, lane
//   i reads the states of the cluster's warps i and i + 32 through
//   distributed shared memory and merges them (two sorted lists by a
//   bitonic merge); the warp takes their k largest by the same rounds, then
//   writes h (Eq. 2), the top-k variance (Eq. 3) and h_dist, the entropy
//   over log V of the full vocabulary.  A last cluster barrier keeps every
//   block's shared memory alive until rank 0 has read it.
// * The chosen logit is one scalar load by rank 0; a token outside [0, V)
//   reads as the reference's finite -1e30, so h is 0 there.  Masked values
//   use that -1e30 as well.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int KMAX = 16;           // largest top-k the kernel keeps
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;          // 16-byte vectors a thread folds a round
constexpr int CAP_TRIGGER = 64;    // a warp compacts its candidates past this
constexpr int MAX_SPLITS = 8;      // the portable cluster size
static_assert(MAX_SPLITS * WARPS <= 64, "rank 0's lanes take two warps each");
constexpr int CHUNK_ALIGN = 8;     // elements: 16 bytes of bf16, 32 of f32
constexpr float NEG = -1e30f;
constexpr float L2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// Built with -DUNCERTAINTY_TRACE (kernels/swarm_uncertainty/trace.py),
// thread 0 of each block stamps its phases into trace_buf: the global timer
// (ns) at entry, clock64 at entry and after each phase, and the global timer
// at exit; read back with uncertainty_trace_read.  Otherwise nothing.
#ifdef UNCERTAINTY_TRACE
constexpr int TRACE_MARKS = 9;
constexpr int TRACE_BLOCKS = 1 << 16;
__device__ unsigned long long trace_buf[TRACE_BLOCKS * TRACE_MARKS];

__device__ __forceinline__ void trace_mark(int i, bool global = false) {
  if (threadIdx.x != 0 || blockIdx.x >= TRACE_BLOCKS) return;
  unsigned long long t;
  if (global)
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  else
    t = static_cast<unsigned long long>(clock64());
  trace_buf[static_cast<long long>(blockIdx.x) * TRACE_MARKS + i] = t;
}
#define TRACE(...) trace_mark(__VA_ARGS__)
#else
#define TRACE(...)
#endif

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16-byte vectors: 4 f32 or 8 bf16, widened to f32
template <typename T> struct Vec;
template <> struct Vec<float> {
  using type = float4;
  static constexpr int W = 4;
  __device__ static void unpack(const float4& q, float (&z)[4]) {
    z[0] = q.x; z[1] = q.y; z[2] = q.z; z[3] = q.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  using type = uint4;
  static constexpr int W = 8;
  __device__ static void unpack(const uint4& q, float (&z)[8]) {
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {              // the lower address is low
      z[2 * j] = __uint_as_float(w[j] << 16);
      z[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
};

// An order-preserving map of f32 to u32 (redux.sync takes integers).
__device__ __forceinline__ unsigned f2key(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float key2f(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Online-softmax state: m, l = sum e^(z-m), s = sum z e^(z-m).
struct Stat {
  float m, l, s;
};

__device__ __forceinline__ void merge(Stat& a, const Stat& b) {
  const float mn = fmaxf(a.m, b.m);
  const float c1 = ex2((a.m - mn) * L2E);
  const float c2 = ex2((b.m - mn) * L2E);
  a.l = a.l * c1 + b.l * c2;
  a.s = a.s * c1 + b.s * c2;
  a.m = mn;
}

__device__ __forceinline__ void warp_merge(Stat& a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Stat b{__shfl_xor_sync(FULL, a.m, off),
                 __shfl_xor_sync(FULL, a.l, off),
                 __shfl_xor_sync(FULL, a.s, off)};
    merge(a, b);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

// A sorted (descending) register list of LK values.
template <int LK>
struct TopK {
  float v[LK];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < LK; ++j) v[j] = NEG;
  }
  __device__ __forceinline__ void insert(float z) {   // duplicates kept
    float c = z;
#pragma unroll
    for (int j = 0; j < LK; ++j) {
      const float hi = fmaxf(v[j], c);
      c = fminf(v[j], c);
      v[j] = hi;
    }
  }
  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int j = 0; j < LK - 1; ++j) v[j] = v[j + 1];
    v[LK - 1] = NEG;
  }
};

// The k largest of the union of a warp's lists, by k rounds of a warp
// argmax over the list heads; lane r (r < k) returns the r-th largest.
// The lists are consumed.
template <int LK>
__device__ __forceinline__ float warp_topk(TopK<LK>& t, int k, int lane) {
  float mine = NEG;
#pragma unroll
  for (int r = 0; r < (LK == 10 ? 10 : KMAX); ++r) {
    if (LK != 10 && r >= k) break;
    const unsigned key = f2key(t.v[0]);
    const unsigned mx = __reduce_max_sync(FULL, key);
    const int who = __ffs(__ballot_sync(FULL, key == mx)) - 1;
    if (lane == r) mine = key2f(mx);
    if (lane == who) t.pop();
  }
  return mine;
}

// The k-th largest of the lanes' x (k <= 16), by k rounds of a warp
// argmax that each drop the winner.
__device__ __forceinline__ float warp_kth(float x, int k, int lane) {
  unsigned key = f2key(x), mx = key;
  for (int r = 0; r < k; ++r) {
    mx = __reduce_max_sync(FULL, key);
    if (lane == __ffs(__ballot_sync(FULL, key == mx)) - 1) key = 0;
  }
  return key2f(mx);
}

// Two descending lists of LK values -> the LK largest of both, descending,
// in a: the elementwise max of a and b reversed is a bitonic sequence
// holding them (both padded to 16 with NEG), and a bitonic merge sorts it.
template <int LK>
__device__ __forceinline__ void merge_lists(TopK<LK>& a, const TopK<LK>& b) {
  float c[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float x = j < LK ? a.v[j] : NEG;
    const float y = 15 - j < LK ? b.v[15 - j] : NEG;
    c[j] = fmaxf(x, y);
  }
#pragma unroll
  for (int h = 8; h > 0; h >>= 1) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if ((j & h) == 0) {
        const float hi = fmaxf(c[j], c[j + h]);
        c[j + h] = fminf(c[j], c[j + h]);
        c[j] = hi;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < LK; ++j) a.v[j] = c[j];
}

// A warp's share of the stream.  Each lane keeps its online (m, l, s).
// The warp keeps the candidates for its top-k in a shared-memory buffer and
// `kth`, a lower bound of their k-th largest (warp-uniform): a logit enters
// the buffer only if it beats `kth`.  The warp's first vector seeds `kth`
// with the k-th largest of its lanes' maxima and enters every logit at or
// above it; once the buffer holds more than CAP_TRIGGER entries the warp
// compacts it to its k largest (k rounds of a warp argmax), which raises
// `kth` to their k-th.  Ties at `kth` may stay out: the buffer always holds
// k values >= kth, so its k largest values are the row's, as a multiset.
template <int LK>
struct WarpStream {
  Stat st;
  float kth;        // warp-uniform
  int cnt;          // warp-uniform: entries in buf
  float* buf;       // this warp's candidate buffer
  int k, lane;

  __device__ __forceinline__ void compact() {
    __syncwarp();
    TopK<LK> t;
    t.init();
    for (int i = lane; i < cnt; i += 32) t.insert(buf[i]);
    const float r = warp_topk<LK>(t, k, lane);
    __syncwarp();
    if (lane < k) buf[lane] = r;
    cnt = k;
    kth = __shfl_sync(FULL, r, k - 1);
    __syncwarp();
  }

  // Fold N logits (ok: this lane's are real); every lane of the warp calls
  // it together.  The caller compacts once cnt > CAP_TRIGGER, at the end of
  // a round: BUF leaves room for a round's vectors.
  template <bool SEED, int N>
  __device__ __forceinline__ void fold(const float (&z)[N], bool ok) {
    float vmax = z[0];
#pragma unroll
    for (int j = 1; j < N; ++j) vmax = fmaxf(vmax, z[j]);
    if (ok) {
      if (vmax > st.m) {                 // rescale once per vector
        const float c = ex2((st.m - vmax) * L2E);
        st.l *= c;
        st.s *= c;
        st.m = vmax;
      }
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float e = ex2((z[j] - st.m) * L2E);
        st.l += e;
        st.s = fmaf(e, z[j], st.s);
      }
    }
    if (SEED) kth = fmaxf(kth, warp_kth(ok ? vmax : NEG, k, lane));
    if (__any_sync(FULL, ok && (SEED ? vmax >= kth : vmax > kth))) {
      const unsigned below = (1u << lane) - 1u;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const bool p = ok && (SEED ? z[j] >= kth : z[j] > kth);
        const unsigned bal = __ballot_sync(FULL, p);
        if (p) buf[cnt + __popc(bal & below)] = z[j];
        cnt += __popc(bal);
      }
    }
  }
};

template <typename T, int LK>
__global__ void __launch_bounds__(THREADS, 4)   // 4 blocks an SM: 64 registers
uncertainty_kernel(const T* __restrict__ logits, const int* __restrict__ tokens,
                   float* __restrict__ h_tok, float* __restrict__ v_topk,
                   float* __restrict__ h_dist, float* __restrict__ parts,
                   int V, int k, int splits, int chunk, int col0,
                   float log_v) {
  using VT = typename Vec<T>::type;
  constexpr int W = Vec<T>::W;
  constexpr int BUF = CAP_TRIGGER + UNROLL * 32 * W;   // room for a round
  __shared__ float cand[WARPS * BUF];    // each warp's candidate buffer
  __shared__ float w_m[WARPS], w_l[WARPS], w_s[WARPS];  // read by rank 0
  __shared__ float w_top[WARPS * LK];    // each warp's top-k, descending

  TRACE(0, true);
  TRACE(1);
  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(blockIdx.x) % splits;
  const long long row = static_cast<long long>(blockIdx.x) / splits;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kk = LK == 10 ? 10 : k;
  const T* x = logits + row * V;

  // the chunk: a scalar head to the first 16-byte boundary, the vector
  // body, a scalar tail
  const int c0 = min(V, rank * chunk);
  const int c1 = min(V, c0 + chunk);
  const int mis = static_cast<int>(
      (reinterpret_cast<uintptr_t>(x + c0) & 15) / sizeof(T));
  const int b0 = min(c1, c0 + (W - mis) % W);
  const int nvec = (c1 - b0) / W;
  const int b1 = b0 + nvec * W;
  const VT* xv = reinterpret_cast<const VT*>(x + b0);

  // rank 0 reads the chosen logit now; it is used in the epilogue (the
  // row holds columns [col0, col0 + V) of the whole vocabulary)
  float chosen = NEG;
  if (rank == 0 && tid == 0) {
    const int tok = tokens[row] - col0;
    if (tok >= 0 && tok < V) chosen = to_f32(x[tok]);
  }

  WarpStream<LK> ws;
  ws.st = Stat{NEG, 0.f, 0.f};
  ws.kth = NEG;
  ws.cnt = 0;
  ws.buf = cand + warp * BUF;
  ws.k = kk;
  ws.lane = lane;
  {
    const bool ok = c0 + tid < b0;           // the head, threads 0-7
    const float z[1] = {ok ? to_f32(x[c0 + tid]) : NEG};
    ws.template fold<false>(z, ok);
  }
  {
    const bool ok = b1 + tid < c1;           // the tail, threads 0-7
    const float z[1] = {ok ? to_f32(x[b1 + tid]) : NEG};
    ws.template fold<false>(z, ok);
  }
  TRACE(2);
  constexpr int PER = THREADS * UNROLL;     // vectors a round
  VT cur[UNROLL], nxt[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u)
    if (tid + u * THREADS < nvec) cur[u] = __ldcs(xv + tid + u * THREADS);
  for (int r0 = 0; r0 < nvec; r0 += PER) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)        // the next round, in flight
      if (r0 + PER + tid + u * THREADS < nvec)
        nxt[u] = __ldcs(xv + r0 + PER + tid + u * THREADS);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const bool ok = r0 + tid + u * THREADS < nvec;
      float z[W];
      if (ok) {
        Vec<T>::unpack(cur[u], z);
      } else {
#pragma unroll
        for (int j = 0; j < W; ++j) z[j] = NEG;
      }
      if (r0 == 0 && u == 0) {
        ws.template fold<true>(z, ok);       // seeds the warp's kth
        TRACE(2);                            // the first bytes are in
      } else {
        ws.template fold<false>(z, ok);
      }
    }
    if (ws.cnt > CAP_TRIGGER) ws.compact();
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) cur[u] = nxt[u];
  }
  TRACE(3);                                  // the chunk is streamed
  ws.compact();                              // the warp's top-k

  // ---- every warp's state to shared memory: its statistics by shuffles,
  // its top-k from the last compaction
  warp_merge(ws.st);
  if (lane < LK) w_top[warp * LK + lane] = lane < kk ? ws.buf[lane] : NEG;
  if (lane == 0) {
    w_m[warp] = ws.st.m;
    w_l[warp] = ws.st.l;
    w_s[warp] = ws.st.s;
  }
  TRACE(4);                                  // the warps' states are out

  // ---- the cluster: in warp 0 of rank 0, lane i takes the states of the
  // cluster's warps i and i + 32 through DSMEM, merges them, and the warp
  // merges its lanes'
  cl.sync();
  TRACE(5);                                  // every block's state is in
  Stat c{NEG, 0.f, 0.f};
  float ct = NEG;
  if (rank == 0 && warp == 0) {
    TopK<LK> t;
    t.init();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = lane + 32 * h;           // warp q % WARPS of rank q / WARPS
      if (q < splits * WARPS) {
        const int r = q / WARPS, w = q % WARPS;
        merge(c, Stat{cl.map_shared_rank(w_m, r)[w],
                      cl.map_shared_rank(w_l, r)[w],
                      cl.map_shared_rank(w_s, r)[w]});
        const float* pt = cl.map_shared_rank(w_top, r) + w * LK;
        TopK<LK> u;
#pragma unroll
        for (int j = 0; j < LK; ++j) u.v[j] = pt[j];
        if (h == 0)
          t = u;
        else
          merge_lists<LK>(t, u);
      }
    }
    warp_merge(c);
    ct = warp_topk<LK>(t, kk, lane);
  }
  TRACE(6);                                  // the splits are merged
  if (parts != nullptr && rank == 0 && warp == 0) {
    // partials mode: the row's merged state, for a merge across ranks
    float* pr = parts + row * (kk + 4);
    if (lane == 0) {
      pr[0] = c.m;
      pr[1] = c.l;
      pr[2] = c.s;
      pr[3] = chosen;
    }
    if (lane < kk) pr[4 + lane] = ct;
  } else if (rank == 0 && warp == 0) {
    const float inv_k = 1.f / static_cast<float>(kk);
    const float mean = warp_sum(lane < kk ? ct : 0.f) * inv_k;
    const float d = lane < kk ? ct - mean : 0.f;
    const float var = warp_sum(d * d) * inv_k;
    if (lane == 0) {
      const float log_l = logf(fmaxf(c.l, 1e-30f));
      const float logp = chosen - c.m - log_l;
      const float p = expf(logp);
      h_tok[row] = -p * logp;                                  // Eq. 2
      h_dist[row] = (log_l + c.m - c.s / fmaxf(c.l, 1e-30f)) / log_v;
      v_topk[row] = var;                                       // Eq. 3
    }
  }
  TRACE(7);                                  // the outputs are written
  cl.sync();                                 // no block leaves while rank 0
  TRACE(8, true);                            // still reads its memory
}

template <typename T, int LK>
int launch(const void* logits, const int* tk, float* h, float* v, float* hd,
           float* parts, int R, int V, int k, int splits, int chunk, int col0,
           float log_v, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(splits) * R);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(&cfg, uncertainty_kernel<T, LK>,
                                     static_cast<const T*>(logits), tk, h, v,
                                     hd, parts, V, k, splits, chunk, col0,
                                     log_v);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_k(const void* logits, const int* tk, float* h, float* v,
               float* hd, float* parts, int R, int V, int k, int splits,
               int chunk, int col0, float log_v, cudaStream_t st) {
  if (k == 10)
    return launch<T, 10>(logits, tk, h, v, hd, parts, R, V, k, splits, chunk,
                         col0, log_v, st);
  return launch<T, KMAX>(logits, tk, h, v, hd, parts, R, V, k, splits, chunk,
                         col0, log_v, st);
}

}  // namespace

#ifdef UNCERTAINTY_TRACE
// Copy the first n stamps of the last traced launch to host memory dst.
extern "C" int uncertainty_trace_read(void* dst, int n) {
  if (n < 0 || n > TRACE_BLOCKS * TRACE_MARKS) return cudaErrorInvalidValue;
  return static_cast<int>(cudaMemcpyFromSymbol(
      dst, trace_buf, static_cast<size_t>(n) * 8));
}
#endif

// logits (R, V) f32 (dtype 0) or bf16 (dtype 1), element-aligned, tokens
// (R,) int32; outputs h_token, v_topk, h_dist (R,) f32.  splits and chunk
// are the wrapper's plan: splits blocks per row (one cluster), each over
// chunk logits (a multiple of 8), together covering V.  parts non-null is
// the partials mode, for a vocabulary cut over ranks: the rows hold
// columns [col0, col0 + V) of the whole vocabulary and tokens index the
// whole; each row's merged state goes to parts (R, k + 4) f32 as (m, l, s,
// the chosen logit or -1e30, its k largest logits, descending) in place of
// h_token, v_topk and h_dist (which may then be null).  Returns
// cudaGetLastError() after the launch.
extern "C" int swarm_uncertainty(const void* logits, const void* tokens,
                                 void* h_tok, void* v_topk, void* h_dist,
                                 void* parts, int R, int V, int k, int splits,
                                 int chunk, int dtype, int col0, float log_v,
                                 void* stream) {
  if (k < 1 || k > KMAX || V < k || R < 1 || splits < 1 ||
      splits > MAX_SPLITS || chunk < 1 || chunk % CHUNK_ALIGN != 0 ||
      static_cast<long long>(splits) * chunk < V ||
      static_cast<long long>(splits - 1) * chunk >= V ||
      static_cast<long long>(splits) * R > 0x7fffffffLL ||
      (parts == nullptr &&
       (h_tok == nullptr || v_topk == nullptr || h_dist == nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tk = static_cast<const int*>(tokens);
  float* h = static_cast<float*>(h_tok);
  float* v = static_cast<float*>(v_topk);
  float* hd = static_cast<float*>(h_dist);
  float* pt = static_cast<float*>(parts);
  if (dtype == 0)
    return dispatch_k<float>(logits, tk, h, v, hd, pt, R, V, k, splits, chunk,
                             col0, log_v, st);
  if (dtype == 1)
    return dispatch_k<__nv_bfloat16>(logits, tk, h, v, hd, pt, R, V, k,
                                     splits, chunk, col0, log_v, st);
  return cudaErrorInvalidValue;
}
