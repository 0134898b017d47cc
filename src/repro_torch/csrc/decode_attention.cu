// One-token GQA decode attention for Hopper (sm_90a), two entry points that
// share one tile body per operand type.
//
// Replaces, in src/repro/kernels/decode_attention/kernel.py:
//
// * decode_attention_pallas (body _decode_kernel, row 2 of the port's
//   kernel table), the decode over a monolithic (B, T) KV cache (entry
//   point decode_attention);
// * paged_decode_attention_pallas (body _paged_decode_kernel, row 5), the
//   decode through a (B, nb) block table over a block pool (N, L, K, D),
//   plus this dispatch's delta rows, with bf16/f32 or int8/fp8 pools (entry
//   point paged_decode_attention).
//
// What bounds them on the H100: device-memory bytes, and before that the
// latency of getting them.  Each cached K and V row is read once per step
// and used for 2*G FMAs per element: a few operations per byte, far below
// the ~295 where the card becomes compute-bound.  The first port (one block
// of 4 warps per (b, kv-head), 32-row tiles loaded 2 bytes at a time and
// staged as f32, the next tile's loads issued only after this tile's math,
// scalar products) ran at 30-224x its byte bound: 24 blocks on 132 SMs at
// B=8, one tile's bytes in flight per block, every tile paying the full
// memory latency, and 3 of every 4 tiles at the gateway's fill holding no
// valid key.  The bf16 body (namespace tc) answers each of those:
//
// * split over keys (flash-decoding): each (b, kv-head) gets n_split
//   blocks, each over a contiguous range of tiles (row 5: of table
//   entries; the delta rows go to the last split), chosen by the wrapper's
//   decode_plan (kernels/decode_attention/ops.py) so that B*K*n_split
//   fills the 132 SMs, with tiles of 32 rows where 64-row tiles' shared
//   memory would leave blocks for a second round (400 blocks of qwen's or
//   llama3's gateway decode).  The splits of one (b, kv-head) form a
//   thread-block cluster and combine their partial (m, l, acc) through
//   distributed shared memory (one launch, no scratch): each block reduces
//   its warps' states, then each block of the cluster rescales and sums a
//   share of the G*D outputs from every block's shared memory;
// * an asynchronous K/V ring: tiles of bk rows (16 per warp) arrive by
//   16-byte cp.async (LDGSTS) in their storage type into a ring of 2-4
//   stages (plan), so up to stages-1 tiles are in flight while the warps
//   compute on one; rows are padded by 16 bytes, so ldmatrix reads are free
//   of bank conflicts, and rows past a tile's end and columns past D
//   arrive as zeros (cp.async's zero fill);
// * tensor-core products: the G <= 16 query heads of a KV head are the
//   16-row A tile of mma.sync m16n8k16 (bf16 in, f32 accumulate).  Warp w
//   owns keys [16w, 16w + 16) of each tile: S = Q.K^T with K fragments by
//   ldmatrix, the online softmax on the S fragment in f32 registers (a row
//   lives in one quad: two shuffles per reduction), P rounded to bf16 in
//   registers (the JAX CPU path's rounding site, as the flash kernels'),
//   O += P.V with V fragments by ldmatrix.trans.  mma.sync, not wgmma:
//   wgmma needs 64 rows, which here could only be keys (S^T = K.Q^T), and
//   then P.V would need P transposed through shared memory each tile;
// * int8/fp8 pool tiles arrive as 1-byte elements (16 per copy, half the
//   bytes of bf16) and are widened to bf16 in registers (both exact); the
//   k-scale multiplies the f32 score before the mask, the softmax sum
//   takes the unscaled weight, the v-scale multiplies the weight before
//   P.V; delta rows (bf16) take neither scale;
// * empty tiles are skipped: before any K/V load a block reads the
//   positions of its range (4 bytes a slot; row 5 also the table entries
//   and the covered mask) into a bit per slot, and loads and computes only
//   tiles with a valid slot.  That is exact for every query row that sees a
//   key (a masked slot weighs exp(-1e30 - m) = 0 once m is finite).  A row
//   that sees no key keeps the documented result: the cluster ORs its
//   blocks' "any valid" bits through shared memory (a block that found a
//   key does not wait for that), and only such a row visits every tile,
//   so it comes out as the mean of V over every slot (row 2) or over every
//   non-sentinel table entry and the delta rows (row 5);
// * row 5 on a bf16 pool with a linear table attends each covered slot's
//   delta row in the slot's own place (the dispatch rewrote slots p0 ..
//   index with delta rows 0 .. index - p0), so its tiles hold the keys of
//   the monolithic cache in the same rows, and the paged and monolithic
//   decodes run the same arithmetic (bitwise at the gateway's decode).
//   Attended in a tile of their own, the delta rows put the two decodes'
//   roundings apart by more than chip_smoke.py's tie budget over
//   swarm-edge-1b's 22 layers (phase 7p read 1.06-1.44).  int8/fp8 pools
//   (bf16 delta rows beside 1-byte rows) and ring tables keep the delta
//   tile;
// * the block's epilogue reduces its warps' (m, l, O) through shared
//   memory in 8-column chunks (16-byte loads and stores), rows padded
//   against bank conflicts.
//
// Masks follow the plain versions: a slot is valid when 0 <= pos <= index (and
// index - pos < window); in row 5 a sentinel entry (id < 0 or >= N: an
// empty serve slot) is never loaded, and a pool slot the dispatch rewrote
// is "covered" (linear slots [p0, index]; ring layers (slot - p0) mod
// (nb*L) <= index - p0, a floor modulo); delta rows are valid when 0 <=
// dpos <= index, within the window and, for ring layers, dpos > index -
// nb*L.  Masked slots score the finite -1e30, slots past a tile's end -inf;
// the output is divided by max(l, 1e-30).  All offsets are 64-bit.
//
// f32 operands run a CUDA-core body (namespace simt):
// one block (4 warps) per (b, kv-head) walks every tile, staged in shared
// memory as f32, lane t scoring key t; the tensor cores' only f32 product
// is TF32 (about 3 digits), which cannot hold the f32 budget of 2e-5.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <initializer_list>

namespace cg = cooperative_groups;

namespace {

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

// ---------------------------------------------------------------------------
// f32 operands: the CUDA-core body
// ---------------------------------------------------------------------------
namespace simt {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TILE = 32;           // key rows per tile: one per lane
constexpr int GPW_MAX = 4;         // queries per warp: G <= WARPS * GPW_MAX

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

__device__ __forceinline__ void load_q(const float* __restrict__ q,
                                       long long q_off, int G, int D,
                                       float* qs) {
  for (int e = threadIdx.x; e < G * D; e += THREADS) qs[e] = q[q_off + e];
}

// The normalised rows; lse non-null also writes each row's log-sum-exp at
// lse[q_off / D + g], and a row that saw no valid slot (its max still
// -1e30) gets lse -inf and o 0.
template <int NDL>
__device__ __forceinline__ void emit(const SoftmaxState<NDL>& st,
                                     float* __restrict__ out, long long q_off,
                                     int G, int D, float* __restrict__ lse) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < GPW_MAX; ++i) {
    const int g = warp + WARPS * i;
    if (g >= G) break;
    const bool none = lse != nullptr && st.m[i] < 0.5f * NEG;
    const float inv = none ? 0.f : 1.f / fmaxf(st.l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NDL; ++j) {
      const int d = lane + 32 * j;
      if (d < D) out[q_off + g * D + d] = st.acc[i][j] * inv;
    }
    if (lse != nullptr && lane == 0)
      lse[q_off / D + g] = none ? -CUDART_INF_F
                                : st.m[i] + logf(fmaxf(st.l[i], 1e-30f));
  }
}

template <int NDL>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int* __restrict__ pos,
              const int* __restrict__ index, float* __restrict__ out,
              float* __restrict__ lse, int Tlen, int K, int G, int D,
              int window, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                          // (G, D)
  float* ks = qs + G * D;                    // (TILE, D + 1)
  float* vs = ks + TILE * (D + 1);           // (TILE, D)

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int idx = index[b];
  const long long q_off = (static_cast<long long>(b) * K + kh) * G * D;
  load_q(q, q_off, G, D, qs);
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
    tile_step<float, NDL>(k, v, kv_base + t0 * row_stride, row_stride,
                          min(TILE, Tlen - t0), valid, 1.f, 1.f, qs, ks, vs,
                          G, D, scale, st);
  }
  emit<NDL>(st, out, q_off, G, D, lse);
}

// TP: pool element type (f32, or int8 / fp8 with f32 scales); q, delta and
// out are f32.
template <typename TP, int NDL>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const float* __restrict__ q, const TP* __restrict__ kp,
                    const TP* __restrict__ vp,
                    const float* __restrict__ ksc,
                    const float* __restrict__ vsc,
                    const int* __restrict__ pos_pool,
                    const int* __restrict__ table,
                    const int* __restrict__ index,
                    const int* __restrict__ p0s, const float* __restrict__ dk,
                    const float* __restrict__ dv, const int* __restrict__ dpos,
                    float* __restrict__ out, int N, int L, int nb, int S,
                    int K, int G, int D, int window, int ring, float scale) {
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
  load_q(q, q_off, G, D, qs);
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
    tile_step<float, NDL>(dk, dv,
                          (static_cast<long long>(b) * S + s0) * row_stride +
                              kh * D,
                          row_stride, min(TILE, S - s0), valid, 1.f, 1.f, qs,
                          ks, vs, G, D, scale, st);
  }
  emit<NDL>(st, out, q_off, G, D, nullptr);
}

size_t smem_bytes(int G, int D) {
  return sizeof(float) *
         (static_cast<size_t>(G) * D + TILE * (D + 1) + TILE * D);
}

template <int NDL>
int launch(const void* q, const void* k, const void* v, const void* pos,
           const void* index, void* out, void* lse, int B, int Tlen, int K,
           int G, int D, int window, float scale, cudaStream_t st) {
  const size_t smem = smem_bytes(G, D);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<NDL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(K, B);
  decode_kernel<NDL><<<grid, THREADS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(pos),
      static_cast<const int*>(index), static_cast<float*>(out),
      static_cast<float*>(lse), Tlen, K, G, D, window, scale);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, const void* pos,
             const void* index, void* out, void* lse, int B, int Tlen, int K,
             int G, int D, int window, float scale, cudaStream_t st) {
  if (G > WARPS * GPW_MAX) return cudaErrorInvalidValue;
  if (D <= 32)
    return launch<1>(q, k, v, pos, index, out, lse, B, Tlen, K, G, D, window,
                     scale, st);
  if (D <= 64)
    return launch<2>(q, k, v, pos, index, out, lse, B, Tlen, K, G, D, window,
                     scale, st);
  if (D <= 128)
    return launch<4>(q, k, v, pos, index, out, lse, B, Tlen, K, G, D, window,
                     scale, st);
  return launch<8>(q, k, v, pos, index, out, lse, B, Tlen, K, G, D, window,
                   scale, st);
}

struct PagedArgs {
  const void *q, *kp, *vp, *ksc, *vsc, *pos, *table, *index, *p0, *dk, *dv,
      *dpos;
  void* out;
  int B, N, L, nb, S, K, G, D, window, ring;
  float scale;
};

template <typename TP, int NDL>
int launch_paged(const PagedArgs& a, cudaStream_t st) {
  const size_t smem = smem_bytes(a.G, a.D);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<TP, NDL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(a.K, a.B);
  paged_decode_kernel<TP, NDL><<<grid, THREADS, smem, st>>>(
      static_cast<const float*>(a.q), static_cast<const TP*>(a.kp),
      static_cast<const TP*>(a.vp), static_cast<const float*>(a.ksc),
      static_cast<const float*>(a.vsc), static_cast<const int*>(a.pos),
      static_cast<const int*>(a.table), static_cast<const int*>(a.index),
      static_cast<const int*>(a.p0), static_cast<const float*>(a.dk),
      static_cast<const float*>(a.dv), static_cast<const int*>(a.dpos),
      static_cast<float*>(a.out), a.N, a.L, a.nb, a.S, a.K, a.G, a.D,
      a.window, a.ring, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TP>
int paged_dispatch_d(const PagedArgs& a, cudaStream_t st) {
  if (a.D <= 32) return launch_paged<TP, 1>(a, st);
  if (a.D <= 64) return launch_paged<TP, 2>(a, st);
  if (a.D <= 128) return launch_paged<TP, 4>(a, st);
  return launch_paged<TP, 8>(a, st);
}

int paged_dispatch(const PagedArgs& a, int pool_dtype, cudaStream_t st) {
  if (a.G > WARPS * GPW_MAX) return cudaErrorInvalidValue;
  if (pool_dtype == 0) return paged_dispatch_d<float>(a, st);
  if (pool_dtype == 2) return paged_dispatch_d<int8_t>(a, st);
  if (pool_dtype == 3) return paged_dispatch_d<__nv_fp8_e4m3>(a, st);
  return cudaErrorInvalidValue;
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16 operands: the tensor-core body
// ---------------------------------------------------------------------------
namespace tc {

constexpr int QROWS = 16;          // mma's M: the G <= 16 heads of a KV head
constexpr int MAX_WARPS = 4;       // tile rows <= 64, 16 keys per warp
constexpr int MAX_SPLIT = 8;       // the portable cluster size
constexpr int MAX_STAGES = 4;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <typename T>
struct Scaled { static constexpr bool value = true; };
template <>
struct Scaled<__nv_bfloat16> { static constexpr bool value = false; };

struct Params {
  const __nv_bfloat16* q;    // (B, K, G, D)
  __nv_bfloat16* out;        // (B, K, G, D), or null where out32 is set
  float* out32;              // row 2 with lse: (B, K, G, D) f32, unrounded
  float* lse;                // row 2: (B, K, G) log-sum-exp, or null
  const void* k;             // row 2: cache (B, T, K, D); row 5: pool
  const void* v;             //   (N, L, K, D) in the pool's type
  const float* ksc;          // row 5 int8/fp8 pools: (N, L, K), else null
  const float* vsc;
  const int* pos;            // row 2: (B, T); row 5: pos_pool (N, L)
  const int* table;          // row 5: (B, nb)
  const int* index;          // (B,)
  const int* p0;             // row 5 with S > 0: (B,)
  const __nv_bfloat16* dk;   // row 5 delta rows (B, S, K, D)
  const __nv_bfloat16* dv;
  const int* dpos;           // (B, S)
  int T;                     // row 2: cache slots
  int N, L, nb, S, ring;     // row 5
  int K, G, D, window;
  float scale_log2;          // D**-0.5 * log2(e): scores in log2 units
  int n_split, bk, stages;   // the wrapper's plan
  int tpe;                   // row 5: tiles per table entry, ceil(L / bk)
  int range_max;             // most tiles one split walks
  int entries_max;           // row 5: most table entries one split walks
};

// Byte offsets into the block's dynamic shared memory.
struct Layout {
  int q, ring, stage, v, sc, bits, vis, blk, ml, mb, flag, total;
};

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

__host__ __device__ inline Layout make_layout(int DP, bool scaled, int bk,
                                              int stages, int range_max,
                                              int entries_max) {
  Layout l;
  const int rs = DP * 2 + 16;                // a bf16 row, padded
  l.q = 0;                                   // Q (QROWS, DP) bf16
  l.ring = QROWS * rs;
  l.v = bk * rs;                             // within a stage: K, V, scales
  l.sc = 2 * bk * rs;
  l.stage = l.sc + (scaled ? 2 * bk * 4 : 0);
  int ring_bytes = stages * l.stage;
  const int cbuf = (bk / 16) * QROWS * (DP + 8) * 4;  // the warps' O
  if (ring_bytes < cbuf) ring_bytes = cbuf;
  l.bits = l.ring + round16(ring_bytes);     // a valid bit per slot
  l.vis = l.bits + 8 * (range_max + 3);      // the tiles to visit
  l.blk = l.vis + round16(4 * range_max);    // row 5: the table slice
  l.ml = l.blk + round16(4 * entries_max);   // per warp and row: m, l
  l.mb = l.ml + MAX_WARPS * QROWS * 2 * 4;   // the block's M, L per row
  l.flag = l.mb + 2 * QROWS * 4;             // "any valid", tiles to visit
  l.total = l.flag + 16;
  return l;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; bytes < 16 zero-fills the rest
__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp4(uint32_t dst, const void* src,
                                    int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n (0..MAX_STAGES-2) groups are pending
__device__ __forceinline__ void cp_wait(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two 1-byte pool elements widened to a bf16 pair (exact for int8 and fp8)
template <typename TE>
__device__ __forceinline__ uint32_t widen2(TE lo, TE hi) {
  return pack_bf16(to_f32(lo), to_f32(hi));
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Built with -DDECODE_TRACE (kernels/decode_attention/trace.py), thread 0
// of each bf16 block stamps its phases into trace_buf: the global timer
// (ns) at entry, clock64 at entry and after each phase, and the global
// timer at exit; read back with decode_trace_read.  Otherwise nothing.
#ifdef DECODE_TRACE
constexpr int TRACE_MARKS = 9;
constexpr int TRACE_BLOCKS = 1 << 16;
__device__ unsigned long long trace_buf[TRACE_BLOCKS * TRACE_MARKS];

__device__ __forceinline__ void trace_mark(int i, bool global = false) {
  if (threadIdx.x != 0) return;
  const long long blk =
      (static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y) *
          gridDim.x + blockIdx.x;
  if (blk >= TRACE_BLOCKS) return;
  unsigned long long t;
  if (global)
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  else
    t = static_cast<unsigned long long>(clock64());
  trace_buf[blk * TRACE_MARKS + i] = t;
}
#define TRACE(...) trace_mark(__VA_ARGS__)
#else
#define TRACE(...)
#endif

// Copy nrows rows of one K and one V tile (row r at elem[(row0 + r) * K *
// D + kh * D]; rows [lo2, hi2) instead from k2/v2 at row row2 + r - lo2)
// into a ring stage: 16-byte copies in the storage type, rows padded by 16
// bytes; rows past nrows and columns past D are zero-filled.
template <int DP, typename TE>
__device__ __forceinline__ void load_kv(const TE* k, const TE* v,
                                        long long row0, int nrows, int K,
                                        int kh, int D, int bk,
                                        unsigned char* st, int v_off,
                                        const TE* k2 = nullptr,
                                        const TE* v2 = nullptr,
                                        long long row2 = 0, int lo2 = 0,
                                        int hi2 = 0) {
  constexpr int SZ = sizeof(TE);
  constexpr int CPR = DP * SZ / 16;          // 16-byte chunks per row
  constexpr int RS = DP * SZ + 16;
  const int dch = D * SZ / 16;
  const long long rstride = static_cast<long long>(K) * D;
  const TE* kb = k + (row0 * K + kh) * D;
  const TE* vb = v + (row0 * K + kh) * D;
  const TE* kb2 = k2 + ((row2 - lo2) * K + kh) * D;
  const TE* vb2 = v2 + ((row2 - lo2) * K + kh) * D;
  const uint32_t ks = smem_u32(st), vs = smem_u32(st + v_off);
  for (int c = threadIdx.x; c < bk * CPR; c += blockDim.x) {
    const int r = c / CPR;
    const int ch = c - r * CPR;
    const bool ok = r < nrows && ch < dch;
    const bool two = r >= lo2 && r < hi2;
    const long long off = ok ? r * rstride + ch * (16 / SZ) : 0;
    cp16(ks + r * RS + ch * 16, (two ? kb2 : kb) + off, ok ? 16 : 0);
    cp16(vs + r * RS + ch * 16, (two ? vb2 : vb) + off, ok ? 16 : 0);
  }
}

// Fold keys [16 * warp, 16 * warp + 16) of one tile in a ring stage into
// the warp's online softmax: rows lane/4 and lane/4 + 8 of the 16 query
// rows (m, l per row; l a partial over this thread's columns) and their
// O fragments.  SC: the tile is a quantized pool tile with its scales.
template <int DP, typename TE, bool SC>
__device__ __forceinline__ void tile_mma(
    const unsigned char* st, int v_off, int sc_off, int bk, int nrows,
    uint64_t vbits, uint32_t qaddr, int D, float scale_log2,
    float (&o)[DP / 8][4], float (&m_r)[2], float (&l_r)[2]) {
  constexpr int SZ = sizeof(TE);
  constexpr int RS = DP * SZ + 16;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int key0 = 16 * warp;
  const unsigned char* ks = st;
  const unsigned char* vs = st + v_off;
  const float* ksc = reinterpret_cast<const float*>(st + sc_off);
  const float* vsc = ksc + bk;

  float s[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    if (kk * 16 < D) {
      uint32_t a[4], b[4];
      ldsm_x4(a, qaddr + kk * 32);
      if (SZ == 2) {
        const int row = key0 + (lane & 7) + ((lane >> 4) << 3);
        ldsm_x4(b, smem_u32(ks) + row * RS + kk * 32 +
                       ((lane >> 3) & 1) * 16);
      } else {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const TE* kr = reinterpret_cast<const TE*>(
              ks + (key0 + 8 * j + (lane >> 2)) * RS);
          const int d0 = kk * 16 + 2 * (lane & 3);
          b[2 * j] = widen2(kr[d0], kr[d0 + 1]);
          b[2 * j + 1] = widen2(kr[d0 + 8], kr[d0 + 9]);
        }
      }
      mma16816(s[0], a, b[0], b[1]);
      mma16816(s[1], a, b[2], b[3]);
    }
  }

  // scale (and k-scale), then the mask: -1e30 for a masked slot, -inf past
  // the tile's rows; element (j, e) is key key0 + 8j + 2(lane%4) + (e&1),
  // row lane/4 + 8 * (e >> 1)
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + 8 * j + 2 * (lane & 3) + (e & 1);
      float x = s[j][e] * scale_log2;
      if (SC) x *= ksc[key];
      const bool valid = (vbits >> key) & 1ull;
      s[j][e] = key < nrows ? (valid ? x : NEG) : -CUDART_INF_F;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = fmaxf(fmaxf(s[0][2 * h], s[0][2 * h + 1]),
                     fmaxf(s[1][2 * h], s[1][2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m_r[h], mx);
    const float corr = exp2f(m_r[h] - mn);
    m_r[h] = mn;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 2 * h; e < 2 * h + 2; ++e) {
        s[j][e] = exp2f(s[j][e] - mn);
        sum += s[j][e];
      }
    l_r[h] = l_r[h] * corr + sum;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      o[n][2 * h] *= corr;
      o[n][2 * h + 1] *= corr;
    }
  }
  if (SC) {                                  // the v-scale weighs P
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] *= vsc[key0 + 8 * j + 2 * (lane & 3) + (e & 1)];
  }
  // P (16 x 16 keys) as the bf16 A fragment: S's accumulator layout is A's
  uint32_t pa[4];
  pa[0] = pack_bf16(s[0][0], s[0][1]);
  pa[1] = pack_bf16(s[0][2], s[0][3]);
  pa[2] = pack_bf16(s[1][0], s[1][1]);
  pa[3] = pack_bf16(s[1][2], s[1][3]);
#pragma unroll
  for (int n2 = 0; n2 < DP / 16; ++n2) {
    if (n2 * 16 < D) {
      uint32_t b[4];
      if (SZ == 2) {
        const int row = key0 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldsm_x4_t(b, smem_u32(vs) + row * RS + n2 * 32 + (lane >> 4) * 16);
      } else {
        const int k0 = key0 + 2 * (lane & 3);
        const TE* v0 = reinterpret_cast<const TE*>(vs + k0 * RS);
        const TE* v1 = reinterpret_cast<const TE*>(vs + (k0 + 1) * RS);
        const TE* v8 = reinterpret_cast<const TE*>(vs + (k0 + 8) * RS);
        const TE* v9 = reinterpret_cast<const TE*>(vs + (k0 + 9) * RS);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int d = n2 * 16 + 8 * t + (lane >> 2);
          b[2 * t] = widen2(v0[d], v1[d]);
          b[2 * t + 1] = widen2(v8[d], v9[d]);
        }
      }
      mma16816(o[2 * n2], pa, b[0], b[1]);
      mma16816(o[2 * n2 + 1], pa, b[2], b[3]);
    }
  }
}

// One block per (split, kv-head, b): blockIdx = (split, kh, b); the
// n_split blocks of a (b, kv-head) are one cluster.  TP: the pool's element
// type (row 2: bf16); PAGED: row 5.
template <int DP, typename TP, bool PAGED>
__global__ void __launch_bounds__(MAX_WARPS * 32) decode_tc(const Params p) {
  constexpr bool SCALED = PAGED && Scaled<TP>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthr >> 5;
  const int split = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int bk = p.bk;
  const int K = p.K, G = p.G, D = p.D;
  const Layout lay = make_layout(DP, SCALED, bk, p.stages, p.range_max,
                                 p.entries_max);
  TRACE(0, true);
  TRACE(1);
  const int idx = p.index[b];

  // Q (G rows of the kv-head's queries, zero-padded to 16 x DP): its own
  // cp.async group, complete by the first tile's wait
  constexpr int QRS = DP * 2 + 16;
  {
    const __nv_bfloat16* qg =
        p.q + (static_cast<long long>(b) * K + kh) * G * D;
    constexpr int QC = DP / 8;
    for (int c = tid; c < QROWS * QC; c += nthr) {
      const int r = c / QC;
      const int ch = c - r * QC;
      const bool ok = r < G && ch * 8 < D;
      cp16(smem_u32(smem + lay.q + r * QRS + ch * 16),
           ok ? qg + r * D + ch * 8 : qg, ok ? 16 : 0);
    }
    cp_commit();
  }

  // this split's tiles: row 2, tiles [first, first + nr) of the cache; row
  // 5, the tiles of table entries [e_lo, e_hi) (tpe each), then (last
  // split) the delta rows' tiles
  int first = 0, e_lo = 0, n_et = 0, nr;
  int* blks = reinterpret_cast<int*>(smem + lay.blk);
  if (!PAGED) {
    const int n_tiles = (p.T + bk - 1) / bk;
    first = static_cast<int>(static_cast<long long>(split) * n_tiles /
                             p.n_split);
    nr = static_cast<int>(static_cast<long long>(split + 1) * n_tiles /
                          p.n_split) - first;
  } else {
    e_lo = split * p.nb / p.n_split;
    const int e_hi = (split + 1) * p.nb / p.n_split;
    n_et = (e_hi - e_lo) * p.tpe;
    nr = n_et + (split == p.n_split - 1 ? (p.S + bk - 1) / bk : 0);
    for (int e = tid; e < e_hi - e_lo; e += nthr)
      blks[e] = p.table[static_cast<long long>(b) * p.nb + e_lo + e];
    __syncthreads();
  }
  const int p0 = PAGED && p.S > 0 ? p.p0[b] : 0;
  const int ring_len = p.nb * p.L;
  const int window = p.window;
  // overlay (bf16 pools, linear tables): a covered slot attends the delta
  // row that rewrote it, in the slot's own place, as the monolithic cache
  // holds it: the delta rows [0, n_ov) sit in slots [p0, p0 + n_ov)
  const bool ovl =
      PAGED && !Scaled<TP>::value && p.S > 0 && !p.ring && p0 >= 0;
  const int n_ov = ovl ? max(0, min(min(idx - p0 + 1, p.S), ring_len - p0))
                       : 0;
  auto delta_valid = [&](int s) -> bool {
    const int ps = p.dpos[static_cast<long long>(b) * p.S + s];
    return ps >= 0 && ps <= idx && (window <= 0 || idx - ps < window) &&
           (!p.ring || ps > idx - ring_len);
  };

  // tile li: rows, source row (row 2: of (B*T); row 5: pool row or delta
  // row of (B*S)), whether it is a delta tile
  auto tile_rows = [&](int li, long long& row0, bool& delta) -> int {
    delta = false;
    if (!PAGED) {
      const int t0 = (first + li) * bk;
      row0 = static_cast<long long>(b) * p.T + t0;
      return min(bk, p.T - t0);
    }
    if (li < n_et) {
      const int e = li / p.tpe;
      const int r0 = (li - e * p.tpe) * bk;
      row0 = static_cast<long long>(blks[e]) * p.L + r0;
      return min(bk, p.L - r0);
    }
    delta = true;
    const int d0 = (li - n_et) * bk;
    row0 = static_cast<long long>(b) * p.S + d0;
    return min(bk, p.S - d0);
  };
  auto sentinel = [&](int li) -> bool {
    if (!PAGED || li >= n_et) return false;
    const int blk = blks[li / p.tpe];
    return blk < 0 || blk >= p.N;
  };

  // a valid bit per slot of the range, from the positions alone: bit
  // li * bk + r of ``bits`` is row r of tile li
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + lay.bits);
  {
    const int nx = nr * bk;
    for (int x0 = 0; x0 < nx; x0 += nthr) {
      const int x = x0 + tid;
      bool valid = false;
      if (x < nx) {
        const int li = x / bk;
        const int r = x - li * bk;
        long long row0;
        bool delta;
        const int nrows = tile_rows(li, row0, delta);
        if (r < nrows && !sentinel(li)) {
          if (!PAGED) {
            const int ps = p.pos[row0 + r];
            valid = ps >= 0 && ps <= idx && (window <= 0 || idx - ps < window);
          } else if (!delta) {
            const int ps = p.pos[row0 + r];
            const int e = e_lo + li / p.tpe;
            const int sl = e * p.L + (li % p.tpe) * bk + r;
            bool covered = false;            // nothing without delta rows
            if (p.S > 0 && p.ring) {
              const int xm = (sl - p0) % ring_len;
              covered = ((xm + ring_len) % ring_len) <= idx - p0;
            } else if (p.S > 0) {
              covered = sl >= p0 && sl <= idx;
            }
            if (covered && sl >= p0 && sl - p0 < n_ov)   // overlaid
              valid = delta_valid(sl - p0);
            else
              valid = ps >= 0 && ps <= idx &&
                      (window <= 0 || idx - ps < window) && !covered;
          } else {
            const int s = static_cast<int>(row0 - static_cast<long long>(b) *
                                                      p.S) + r;
            bool placed = false;             // overlaid in a pool slot?
            if (s < n_ov) {
              const int blk = p.table[static_cast<long long>(b) * p.nb +
                                      (p0 + s) / p.L];
              placed = blk >= 0 && blk < p.N;
            }
            valid = !placed && delta_valid(s);
          }
        }
      }
      const unsigned w = __ballot_sync(0xffffffffu, valid);
      if (lane == 0) bits[(x0 >> 5) + warp] = w;
    }
  }
  __syncthreads();
  TRACE(2);                                  // the positions are read
  auto tile_bits = [&](int li) -> uint64_t {
    const int bit0 = li * bk;                // bk in {16, 32, 64}
    const uint64_t w = bits[bit0 >> 5] |
                       (static_cast<uint64_t>(bits[(bit0 >> 5) + 1]) << 32);
    const uint64_t mask = bk == 64 ? ~0ull : ((1ull << bk) - 1);
    return (w >> (bit0 & 31)) & mask;
  };
  bool mine = false;
  for (int li = tid; li < nr; li += nthr) mine |= tile_bits(li) != 0;
  const bool own_any = __syncthreads_or(mine) != 0;

  // does the row see a key anywhere?  Ask the other splits only if this
  // one saw none
  int* flag = reinterpret_cast<int*>(smem + lay.flag);
  bool row_any = own_any, waited = true;
  if (p.n_split > 1) {
    if (tid == 0) flag[0] = own_any ? 1 : 0;
    cluster_arrive();
    waited = false;
    if (!own_any) {
      cluster_wait();
      waited = true;
      cg::cluster_group cl = cg::this_cluster();
      int any = 0;
      for (int r = 0; r < p.n_split; ++r) any |= *cl.map_shared_rank(flag, r);
      row_any = any != 0;
    }
  }

  // the tiles to visit: those with a valid slot; every non-sentinel tile
  // for a row that sees no key
  int* vis = reinterpret_cast<int*>(smem + lay.vis);
  if (warp == 0) {
    int cnt = 0;
    for (int base = 0; base < nr; base += 32) {
      const int li = base + lane;
      bool go = false;
      if (li < nr) go = row_any ? tile_bits(li) != 0 : !sentinel(li);
      const unsigned m = __ballot_sync(0xffffffffu, go);
      if (go) vis[cnt + __popc(m & ((1u << lane) - 1u))] = li;
      cnt += __popc(m);
    }
    if (lane == 0) flag[1] = cnt;
  }
  __syncthreads();
  const int n_vis = flag[1];
  TRACE(3);                                  // the tiles to visit are known

  const int ns = p.stages;
  unsigned char* ring = smem + lay.ring;
  auto issue = [&](int li, int stage) {
    unsigned char* st = ring + stage * lay.stage;
    long long row0;
    bool delta;
    const int nrows = tile_rows(li, row0, delta);
    if (PAGED && delta) {
      load_kv<DP, __nv_bfloat16>(p.dk, p.dv, row0, nrows, K, kh, D, bk, st,
                                 lay.v);
    } else if (ovl && row_any) {             // bf16 pool: TP is bf16
      const int slot0 = (e_lo + li / p.tpe) * p.L + (li % p.tpe) * bk;
      const int lo = min(max(p0 - slot0, 0), nrows);
      const int hi = min(max(p0 + n_ov - slot0, lo), nrows);
      load_kv<DP, TP>(static_cast<const TP*>(p.k),
                      static_cast<const TP*>(p.v), row0, nrows, K, kh, D, bk,
                      st, lay.v, reinterpret_cast<const TP*>(p.dk),
                      reinterpret_cast<const TP*>(p.dv),
                      static_cast<long long>(b) * p.S + slot0 + lo - p0, lo,
                      hi);
    } else {
      load_kv<DP, TP>(static_cast<const TP*>(p.k),
                      static_cast<const TP*>(p.v), row0, nrows, K, kh, D, bk,
                      st, lay.v);
      if (SCALED) {
        for (int r = tid; r < bk; r += nthr) {
          const bool ok = r < nrows;
          const long long so = ok ? (row0 + r) * K + kh : 0;
          cp4(smem_u32(st + lay.sc + 4 * r), p.ksc + so, ok ? 4 : 0);
          cp4(smem_u32(st + lay.sc + 4 * (bk + r)), p.vsc + so, ok ? 4 : 0);
        }
      }
    }
  };

  float o[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_r[2] = {NEG, NEG}, l_r[2] = {0.f, 0.f};
  const uint32_t qaddr = smem_u32(smem + lay.q) +
                         ((lane & 7) + ((lane >> 3) & 1) * 8) * QRS +
                         (lane >> 4) * 16;

  for (int i = 0; i < ns - 1; ++i) {
    if (i < n_vis) issue(vis[i], i);
    cp_commit();
  }
  for (int i = 0; i < n_vis; ++i) {
    cp_wait(ns - 2);                         // tile i (and Q) has landed
    __syncthreads();                         // for every thread, and tile
    if (i == 0) {                            // i-1's stage is free
      TRACE(4);                              // the first tile is in
    }
    {
      const int j = i + ns - 1;
      if (j < n_vis) issue(vis[j], j % ns);
      cp_commit();
    }
    const int li = vis[i];
    long long row0;
    bool delta;
    const int nrows = tile_rows(li, row0, delta);
    if (16 * warp < nrows) {
      const unsigned char* st = ring + (i % ns) * lay.stage;
      const uint64_t vb = tile_bits(li);
      if (SCALED && !delta)
        tile_mma<DP, TP, SCALED>(st, lay.v, lay.sc, bk, nrows, vb, qaddr, D,
                                 p.scale_log2, o, m_r, l_r);
      else
        tile_mma<DP, __nv_bfloat16, false>(st, lay.v, lay.sc, bk, nrows, vb,
                                           qaddr, D, p.scale_log2, o, m_r,
                                           l_r);
    }
  }

  if (n_vis == 0) {
    TRACE(4);
  }
  TRACE(5);                                  // every tile is folded in
  // the block's state: reduce l over each quad; the block's max M and sum
  // L per row from the warps' (m, l); the warps' O rescaled to M
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 1);
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 2);
  }
  cp_wait(0);
  __syncthreads();                           // the ring is free
  float* ml = reinterpret_cast<float*>(smem + lay.ml);  // [warp][row][m, l]
  if ((lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = (lane >> 2) + 8 * h;
      ml[(warp * QROWS + row) * 2] = m_r[h];
      ml[(warp * QROWS + row) * 2 + 1] = l_r[h];
    }
  }
  __syncthreads();
  float* mb = reinterpret_cast<float*>(smem + lay.mb);  // M[16], L[16]
  for (int g = tid; g < G; g += nthr) {
    float M = NEG, Lsum = 0.f;
    for (int w = 0; w < nwarps; ++w) M = fmaxf(M, ml[(w * QROWS + g) * 2]);
    for (int w = 0; w < nwarps; ++w)
      Lsum += ml[(w * QROWS + g) * 2 + 1] *
              exp2f(ml[(w * QROWS + g) * 2] - M);
    mb[g] = M;
    mb[QROWS + g] = Lsum;
  }
  // [warp][row][CS] partial O; rows padded by 8 floats, so a warp's
  // stores (8 rows x 4 column pairs) meet at most two to a bank
  constexpr int CS = DP + 8;
  float* cb = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = (lane >> 2) + 8 * h;
    float M = NEG;
    for (int w = 0; w < nwarps; ++w) M = fmaxf(M, ml[(w * QROWS + row) * 2]);
    const float f = exp2f(m_r[h] - M);
    float2* dst = reinterpret_cast<float2*>(
        cb + (warp * QROWS + row) * CS + 2 * (lane & 3));
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
      dst[4 * n] = make_float2(o[n][2 * h] * f, o[n][2 * h + 1] * f);
  }
  __syncthreads();

  // the outputs in chunks of 8 columns: chunk t is row t / NC, columns
  // 8 * (t % NC) ..; a chunk's O summed over the warps
  constexpr int NC = DP / 8;
  const int dc = D / 8;
  auto warp_sum8 = [&](int t, float (&acc)[8]) {
    const int g = t / NC;
    const int c = t - g * NC;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
    for (int w = 0; w < nwarps; ++w) {
      const float4* src = reinterpret_cast<const float4*>(
          cb + (w * QROWS + g) * CS + 8 * c);
      const float4 x = src[0], y = src[1];
      acc[0] += x.x; acc[1] += x.y; acc[2] += x.z; acc[3] += x.w;
      acc[4] += y.x; acc[5] += y.y; acc[6] += y.z; acc[7] += y.w;
    }
  };
  const long long out0 = (static_cast<long long>(b) * K + kh) * G * D;
  // with lse: a row that saw no valid slot (M still -1e30) is written 0,
  // and its log-sum-exp -inf, by the thread of its first chunk; out32
  // takes the rows in f32, so a merge over ranks rounds once
  auto store8 = [&](int t, const float (&acc)[8], float M, float Lsum) {
    const int g = t / NC;
    const int c = t - g * NC;
    const bool none = p.lse != nullptr && M < 0.5f * NEG;
    const float inv = none ? 0.f : 1.f / fmaxf(Lsum, 1e-30f);
    if (p.lse != nullptr && c == 0)
      p.lse[(static_cast<long long>(b) * K + kh) * G + g] =
          none ? -CUDART_INF_F : M * LN2 + logf(fmaxf(Lsum, 1e-30f));
    if (p.out32 != nullptr) {
      float4* dst = reinterpret_cast<float4*>(p.out32 + out0 + g * D + 8 * c);
      dst[0] = make_float4(acc[0] * inv, acc[1] * inv, acc[2] * inv,
                           acc[3] * inv);
      dst[1] = make_float4(acc[4] * inv, acc[5] * inv, acc[6] * inv,
                           acc[7] * inv);
      return;
    }
    uint4 v;
    v.x = pack_bf16(acc[0] * inv, acc[1] * inv);
    v.y = pack_bf16(acc[2] * inv, acc[3] * inv);
    v.z = pack_bf16(acc[4] * inv, acc[5] * inv);
    v.w = pack_bf16(acc[6] * inv, acc[7] * inv);
    *reinterpret_cast<uint4*>(p.out + out0 + g * D + 8 * c) = v;
  };
  if (p.n_split == 1) {
    for (int t = tid; t < G * NC; t += nthr) {
      if (t % NC >= dc) continue;
      float acc[8];
      warp_sum8(t, acc);
      store8(t, acc, mb[t / NC], mb[QROWS + t / NC]);
    }
    TRACE(6);
    TRACE(7);
    TRACE(8, true);
    return;
  }

  // the cluster's combine: each block's (M, L, O) in its shared memory,
  // then each block rescales and sums a share of the outputs from all
  for (int t = tid; t < G * NC; t += nthr) {
    if (t % NC >= dc) continue;
    float acc[8];
    warp_sum8(t, acc);                       // into warp 0's slot: only
    float4* dst = reinterpret_cast<float4*>(  // this thread touches it
        cb + (t / NC) * CS + 8 * (t % NC));
    dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
  TRACE(6);                                  // the block's state is ready
  if (!waited) cluster_wait();
  cluster_arrive();
  cluster_wait();
  {
    cg::cluster_group cl = cg::this_cluster();
    const int rank = static_cast<int>(cl.block_rank());
    const int share = (G * NC + p.n_split - 1) / p.n_split;
    const int t_end = min(G * NC, (rank + 1) * share);
    for (int t = rank * share + tid; t < t_end; t += nthr) {
      if (t % NC >= dc) continue;
      const int g = t / NC;
      float M = NEG;
      for (int r = 0; r < p.n_split; ++r)
        M = fmaxf(M, cl.map_shared_rank(mb, r)[g]);
      float Lsum = 0.f, acc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = 0.f;
      for (int r = 0; r < p.n_split; ++r) {
        const float* rmb = cl.map_shared_rank(mb, r);
        const float f = exp2f(rmb[g] - M);
        Lsum += f * rmb[QROWS + g];
        const float4* src = reinterpret_cast<const float4*>(
            cl.map_shared_rank(cb, r) + g * CS + 8 * (t % NC));
        const float4 x = src[0], y = src[1];
        acc[0] += f * x.x; acc[1] += f * x.y; acc[2] += f * x.z;
        acc[3] += f * x.w; acc[4] += f * y.x; acc[5] += f * y.y;
        acc[6] += f * y.z; acc[7] += f * y.w;
      }
      store8(t, acc, M, Lsum);
    }
  }
  TRACE(7);                                  // its share is written
  cluster_arrive();                          // no block leaves while another
  cluster_wait();                            // still reads its memory
  TRACE(8, true);
}

template <int DP, typename TP, bool PAGED>
int launch(const Params& p, int B, cudaStream_t st) {
  const Layout lay = make_layout(DP, PAGED && Scaled<TP>::value, p.bk,
                                 p.stages, p.range_max, p.entries_max);
  static int smem_set = 0;                   // the attribute set so far
  if (lay.total > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_tc<DP, TP, PAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        lay.total);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = lay.total;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.n_split, p.K, B);
  cfg.blockDim = dim3(2 * p.bk);             // 16 keys a warp
  cfg.dynamicSmemBytes = lay.total;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.n_split > 1 ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(&cfg, decode_tc<DP, TP, PAGED>, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename TP, bool PAGED>
int dispatch_d(const Params& p, int B, cudaStream_t st) {
  if (p.D <= 32) return launch<32, TP, PAGED>(p, B, st);
  if (p.D <= 64) return launch<64, TP, PAGED>(p, B, st);
  if (p.D <= 128) return launch<128, TP, PAGED>(p, B, st);
  return launch<256, TP, PAGED>(p, B, st);
}

// What every bf16 launch needs: the plan's ranges, D a multiple of 16
// (mma's k-step; 16-byte copies of int8 rows), G <= 16, 16-byte aligned
// operands.
bool plan_ok(int B, int K, int G, int D, int n_split, int bk, int stages,
             std::initializer_list<const void*> ptrs) {
  if (B < 1 || B > 65535 || K < 1 || K > 65535 || G < 1 || G > QROWS ||
      D < 16 || D > 256 || D % 16 != 0 || n_split < 1 ||
      n_split > MAX_SPLIT || stages < 2 || stages > MAX_STAGES ||
      (bk != 16 && bk != 32 && bk != 64))
    return false;
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) & 15) return false;
  return true;
}

}  // namespace tc

}  // namespace

#ifdef DECODE_TRACE
// Copy the first n stamps of the last traced launch to host memory dst.
extern "C" int decode_trace_read(void* dst, int n) {
  if (n < 0 || n > tc::TRACE_BLOCKS * tc::TRACE_MARKS)
    return cudaErrorInvalidValue;
  return static_cast<int>(cudaMemcpyFromSymbol(
      dst, tc::trace_buf, static_cast<size_t>(n) * 8));
}
#endif

// q (B, K, G, D); k, v (B, T, K, D); pos (B, T) int32; index (B,) int32;
// out (B, K, G, D) in q's type: f32 (dtype 0) or bf16 (dtype 1); lse
// (B, K, G) f32 or null: each row's log-sum-exp over its valid slots (-inf,
// and the row's out 0, where it has none), for a merge over the slots
// other ranks hold.  With lse, out is f32 in either type: the rows are not
// rounded before the merge.  window <= 0 means no window.  n_split, bk, stages
// are the wrapper's plan for the bf16 body (blocks per (b, kv-head), key
// rows per tile, ring stages); the f32 body ignores them.  Returns
// cudaGetLastError().
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* pos, const void* index, void* out,
                                void* lse, int B, int Tlen, int K, int G,
                                int D, int window, float scale, int dtype,
                                int n_split, int bk, int stages,
                                void* stream) {
  if (B < 1 || Tlen < 1 || K < 1 || G < 1 || D < 1 || D > 256)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return simt::dispatch(q, k, v, pos, index, out, lse, B, Tlen, K, G, D,
                          window, scale, st);
  if (dtype != 1 ||
      !tc::plan_ok(B, K, G, D, n_split, bk, stages, {q, k, v, out}))
    return cudaErrorInvalidValue;
  tc::Params p = {};
  p.q = static_cast<const __nv_bfloat16*>(q);
  if (lse != nullptr)
    p.out32 = static_cast<float*>(out);
  else
    p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.k = k;
  p.v = v;
  p.pos = static_cast<const int*>(pos);
  p.index = static_cast<const int*>(index);
  p.T = Tlen;
  p.K = K; p.G = G; p.D = D; p.window = window;
  p.scale_log2 = scale * tc::LOG2E;
  p.n_split = n_split; p.bk = bk; p.stages = stages;
  const int n_tiles = (Tlen + bk - 1) / bk;
  if (n_split > n_tiles) return cudaErrorInvalidValue;
  p.range_max = (n_tiles + n_split - 1) / n_split;
  return tc::dispatch_d<__nv_bfloat16, false>(p, B, st);
}

// q (B, K, G, D); k_pool, v_pool (N, L, K, D) of pool_dtype (0 f32, 1 bf16,
// 2 int8, 3 fp8 e4m3; 2 and 3 need k_scale, v_scale (N, L, K) f32, else
// null); pos_pool (N, L) int32; table (B, nb) int32; index, p0 (B,) int32;
// delta_k, delta_v (B, S, K, D) and out (B, K, G, D) of dtype (0 f32,
// 1 bf16); delta_pos (B, S) int32.  S = 0 attends the pool alone and masks
// no slot as covered (the delta pointers may then be null, p0 is unread).
// window <= 0 means no window; ring != 0 takes the table as a ring of nb*L
// slots.  n_split, bk, stages: the plan, as above (the splits divide the
// table entries; the last also walks the delta rows).  Returns
// cudaGetLastError().
extern "C" int paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* pos_pool,
    const void* table, const void* index, const void* p0,
    const void* delta_k, const void* delta_v, const void* delta_pos,
    void* out, int B, int N, int L, int nb, int S, int K, int G, int D,
    int window, int ring, float scale, int dtype, int pool_dtype,
    int n_split, int bk, int stages, void* stream) {
  if (B < 1 || N < 1 || L < 1 || nb < 1 || S < 0 || K < 1 || G < 1 ||
      D < 1 || D > 256)
    return cudaErrorInvalidValue;
  const bool quantized = pool_dtype == 2 || pool_dtype == 3;
  if (quantized != (k_scale != nullptr && v_scale != nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (pool_dtype == 1) return cudaErrorInvalidValue;
    simt::PagedArgs a{q,     k_pool, v_pool,  k_scale, v_scale,  pos_pool,
                      table, index,  p0,      delta_k, delta_v,  delta_pos,
                      out,   B,      N,       L,       nb,       S,
                      K,     G,      D,       window,  ring,     scale};
    return simt::paged_dispatch(a, pool_dtype, st);
  }
  if (dtype != 1 || pool_dtype == 0 ||
      !tc::plan_ok(B, K, G, D, n_split, bk, stages,
                   {q, k_pool, v_pool, delta_k, delta_v, out}) ||
      n_split > nb)
    return cudaErrorInvalidValue;
  tc::Params p = {};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.k = k_pool;
  p.v = v_pool;
  p.ksc = static_cast<const float*>(k_scale);
  p.vsc = static_cast<const float*>(v_scale);
  p.pos = static_cast<const int*>(pos_pool);
  p.table = static_cast<const int*>(table);
  p.index = static_cast<const int*>(index);
  p.p0 = static_cast<const int*>(p0);
  p.dk = static_cast<const __nv_bfloat16*>(delta_k);
  p.dv = static_cast<const __nv_bfloat16*>(delta_v);
  p.dpos = static_cast<const int*>(delta_pos);
  p.N = N; p.L = L; p.nb = nb; p.S = S; p.ring = ring;
  p.K = K; p.G = G; p.D = D; p.window = window;
  p.scale_log2 = scale * tc::LOG2E;
  p.n_split = n_split; p.bk = bk; p.stages = stages;
  p.tpe = (L + bk - 1) / bk;
  p.entries_max = (nb + n_split - 1) / n_split;
  p.range_max = p.entries_max * p.tpe + (S + bk - 1) / bk;
  if (pool_dtype == 1)
    return tc::dispatch_d<__nv_bfloat16, true>(p, B, st);
  if (pool_dtype == 2) return tc::dispatch_d<int8_t, true>(p, B, st);
  return tc::dispatch_d<__nv_fp8_e4m3, true>(p, B, st);
}
