// GQA flash attention for Hopper (sm_90a): two mask modes, two bodies.
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
// scores with the finite -1e30 and divide the output by max(l, 1e-30), so a
// row with nothing valid (a padding row in positions mode) comes out as the
// mean of V over the visited slots, never NaN.
//
// What bounds it on the H100: at S >= 256 the work is 4*S*T*D operations
// per head (about half when causal) against 2*(S*H + 2*T*K)*D bytes, so the
// bound is the tensor cores' operations; at the gateway's prefill (S = 8)
// it is the bytes of q, k and v, and each block's fixed latency (its Q load
// and first K/V tile) more than either.
//
// bf16 operands run the tensor-core body (namespace tc), which answers the
// operations bound:
// * products on wgmma: a consumer warpgroup owns 64 query rows (two
//   warpgroups per block where the rows fill them); S = Q.K^T is
//   m64nBKk16 with Q and K both read from shared memory in the 128-byte
//   swizzle, the online softmax runs on the f32 accumulator fragment in
//   registers (a row lives in one quad of threads: two shuffles per
//   reduction; no branch per element), P is rounded to bf16 in registers
//   and O += P.V is wgmma with A = P from registers and B = V read
//   MN-major from shared memory; O stays in f32 registers until the
//   epilogue;
// * K/V tiles of BK slots arrive by TMA (cp.async.bulk.tensor over a
//   (B, T, K, D) tensor map built on the host with cuTensorMapEncodeTiled,
//   found through cudaGetDriverEntryPoint, so no -lcuda) into a ring of two
//   stages with full/empty mbarriers, so the next tile loads while the
//   warpgroups compute on this one.  A producer warpgroup issues the
//   copies, each as soon as the consumers release its stage; setmaxnreg
//   gives its registers to the consumers (24 against 240 a thread), which
//   hold S, P and O of a 64 x 128 tile in registers without spilling;
// * GQA packing for short spans: when S * G fits one block's rows, a row
//   tile holds the (s, g) pairs of the G query heads that read one KV head
//   (row r -> s = r / G, head = kv_head * G + r % G), so K/V of a
//   (batch, KV head) is loaded once, not G times; longer spans take
//   per-head tiles.  The mapping is a runtime argument (gp = G or 1) chosen
//   by the wrapper's launch_plan (kernels/flash_attention/ops.py), which
//   mirrors the block -> rows decode below;
// * masks use each row's own position; grid mode skips the KV tiles no row
//   of the block can see, schedules causal row tiles heaviest first, and
//   applies the per-element mask only on tiles that straddle the diagonal,
//   the window edge or T's ragged end; positions mode masks every tile,
//   its kv positions staged through shared memory while S computes;
// * D is padded to DP in {64, 128, 256} (one 128-byte swizzle row per 64
//   columns): Q's staging writes zeros past D and the tensor map reads K/V
//   columns past D, and slots past T, as zeros; slots past T score -inf.
// The bf16 body rounds P to bf16 before P.V (as the JAX CPU path does); the
// plain version keeps P in f32, within the bf16 budget of 2e-2.
//
// f32 operands run the CUDA-core body (namespace simt), kept from the first
// port: wgmma's only f32 product is TF32 (about 3 digits), which cannot hold
// the f32 budget of 2e-5.  One block (4 warps) per (b, head, 64-row q
// tile), each warp owning 16 rows; K/V in tiles of 32 slots staged as f32 in
// shared memory; lane t scores slot t, the row's accumulator lives in
// shared memory.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// f32 operands: the CUDA-core body
// ---------------------------------------------------------------------------
namespace simt {

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
             const int* __restrict__ kvpos, T* __restrict__ out,
             float* __restrict__ lse, int S, int Tlen, int H, int K, int D,
             int causal, int window, float scale) {
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
  // with lse: a row that saw no valid key (its max still -1e30) is written
  // 0 and its log-sum-exp -inf
  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D;
    const int d = e - r * D;
    const int s = q0 + r;
    const bool none = lse != nullptr && ms[r] < 0.5f * NEG;
    if (s < S)
      store(out + q_base + s * q_row + d,
            none ? 0.f : acc[e] / fmaxf(ls[r], 1e-30f));
  }
  if (lse != nullptr)
    for (int r = tid; r < BQ; r += THREADS)
      if (q0 + r < S)
        lse[(static_cast<long long>(b) * S + q0 + r) * H + h] =
            ms[r] < 0.5f * NEG ? -CUDART_INF_F
                               : ms[r] + logf(fmaxf(ls[r], 1e-30f));
}

template <typename T, int NDL, bool GRID>
int launch(const void* q, const void* k, const void* v, const void* qpos,
           const void* kvpos, void* out, void* lse, int B, int S, int Tlen,
           int H, int K, int D, int causal, int window, float scale,
           cudaStream_t st) {
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
      static_cast<const int*>(kvpos), static_cast<T*>(out),
      static_cast<float*>(lse), S, Tlen, H, K, D, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool GRID>
int dispatch_d(const void* q, const void* k, const void* v, const void* qpos,
               const void* kvpos, void* out, void* lse, int B, int S,
               int Tlen, int H, int K, int D, int causal, int window,
               float scale, cudaStream_t st) {
  if (D <= 32)
    return launch<T, 1, GRID>(q, k, v, qpos, kvpos, out, lse, B, S, Tlen, H,
                              K, D, causal, window, scale, st);
  if (D <= 64)
    return launch<T, 2, GRID>(q, k, v, qpos, kvpos, out, lse, B, S, Tlen, H,
                              K, D, causal, window, scale, st);
  if (D <= 128)
    return launch<T, 4, GRID>(q, k, v, qpos, kvpos, out, lse, B, S, Tlen, H,
                              K, D, causal, window, scale, st);
  return launch<T, 8, GRID>(q, k, v, qpos, kvpos, out, lse, B, S, Tlen, H, K,
                            D, causal, window, scale, st);
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16 operands: the tensor-core body
// ---------------------------------------------------------------------------
namespace tc {

constexpr int WG = 128;             // threads of a consumer warpgroup
constexpr int WG_ROWS = 64;         // query rows of a warpgroup (wgmma M)
constexpr int MAX_WG = 2;           // consumer warpgroups per block
constexpr int ROW_BYTES = 128;      // one 64-column bf16 row: the swizzle span
constexpr int ATOM_BYTES = 8 * ROW_BYTES;   // the 8-row swizzle atom
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int DP>
struct Tile {
  static constexpr int BK = DP >= 256 ? 64 : 128;    // K/V slots per tile
  static constexpr int NCB = DP / 64;                // 64-column blocks
  static constexpr int Q_BYTES = WG_ROWS * DP * 2;   // one warpgroup's Q
  static constexpr int CB_BYTES = BK * ROW_BYTES;    // a column block of K
  static constexpr int KV_BYTES = NCB * CB_BYTES;    // one K (or V) tile
};

struct Params {
  const __nv_bfloat16* q;
  const int* qpos;
  const int* kvpos;
  __nv_bfloat16* out;   // or null where out32 is set
  float* out32;     // positions mode with lse: (B, S, H, D) f32, unrounded
  float* lse;       // positions mode: (B, S, H) log-sum-exp, or null
  int B, S, T, H, D, G;
  int gp;           // query heads per row group: G (packed) or 1 (per head)
  int rows;         // rows of one (batch, head group): S * gp
  int n_rt;         // row tiles per (batch, head group)
  int n_hb;         // head groups: H / gp
  int causal, window;
  float scale_log2;   // D**-0.5 * log2(e): scores in log2 units for exp2
  int nwg, nst;       // consumer warpgroups, ring stages
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor with the 128-byte swizzle: start address,
// leading and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.  A wait that
// outlasts any tile's load or compute by orders of magnitude traps, so a
// broken ring fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0, spins = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (++spins > (1u << 26)) __trap();
  } while (!done);
}

// One box of the (D, K, T, B) tensor map into shared memory, completing on
// the mbarrier `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads of an accumulator across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// 2**x on the SFU (about 2 ulp; 2**-inf = 0): the softmax's exponent.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S(64 x 64) (+)= A(64 x 16, smem) * B(64 x 16, smem)^T, both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// S(64 x 128) (+)= A(64 x 16, smem) * B(128 x 16, smem)^T, both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// O(64 x 64) += P(64 x 16, registers) * V(16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, "
      "1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O(64 x 128) += P(64 x 16, registers) * V(16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, "
      "1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O(64 x 256) += P(64 x 16, registers) * V(16 x 256, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, "
      "1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// One block: nwg consumer warpgroups of 64 rows each, then a producer
// warpgroup whose first thread issues the K/V loads.  setmaxnreg moves the
// producer's registers to the consumers within the block's launch
// allocation of 168 a thread: 24 for it, 240 for them.
// Block x -> (row tile rt, head group hb, batch b), rt slowest; head group
// hb covers query heads hb*gp .. hb*gp+gp-1, which read KV head hb*gp / G;
// row R of a (b, hb) is query s = R / gp of head hb*gp + R % gp.
template <int DP, bool GRID>
__global__ void __launch_bounds__((MAX_WG + 1) * WG, 1)
flash_tc(const __grid_constant__ CUtensorMap kmap,
         const __grid_constant__ CUtensorMap vmap, const Params p) {
  using TL = Tile<DP>;
  constexpr int BK = TL::BK;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle repeats every 1024 bytes: align the base to it
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sbase = smem_raw + (base - raw);
  const uint32_t q_s = base;                             // nwg x Q_BYTES
  const uint32_t kv_s = q_s + p.nwg * TL::Q_BYTES;       // nst x (K, V)
  const uint32_t full_s = kv_s + p.nst * 2 * TL::KV_BYTES;
  const uint32_t empty_s = full_s + 8 * p.nst;
  const uint32_t pos_s = empty_s + 8 * p.nst;   // positions: nwg x 2 x BK

  const int per = p.n_hb * p.B;
  int rt = blockIdx.x / per;
  if (GRID && p.causal) rt = p.n_rt - 1 - rt;     // heaviest row tiles first
  const int hb = (blockIdx.x % per) % p.n_hb;
  const int b = (blockIdx.x % per) / p.n_hb;
  const int head0 = hb * p.gp;
  const int kh = head0 / p.G;
  const int R0 = rt * p.nwg * WG_ROWS;
  const int R_end = min(R0 + p.nwg * WG_ROWS, p.rows);

  // the KV tiles this block visits: all in positions mode; in grid mode
  // from the window's reach of the first row to the diagonal of the last
  int t_begin = 0, t_end = p.T;
  if (GRID) {
    if (p.causal) t_end = min(p.T, (R_end - 1) / p.gp + 1);
    if (p.window > 0) t_begin = max(0, R0 / p.gp - p.window + 1) / BK * BK;
  }
  const int ntiles = (t_end - t_begin + BK - 1) / BK;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid == 0) {
    for (int st = 0; st < p.nst; ++st) {
      mbar_init(full_s + 8 * st, 1);
      mbar_init(empty_s + 8 * st, p.nwg * 4);    // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= p.nwg * WG) {
    // ---- the producer: K/V tiles by TMA into the ring, each as soon as
    // the consumers have released its stage -------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == p.nwg * WG) {
      int st = 0, use = 0;
      for (int i = 0; i < ntiles; ++i) {
        if (use > 0) mbar_wait(empty_s + 8 * st, (use - 1) & 1);
        const uint32_t full = full_s + 8 * st;
        mbar_expect_tx(full, 2 * TL::KV_BYTES);
        const uint32_t ks = kv_s + st * 2 * TL::KV_BYTES;
        const int t0 = t_begin + i * BK;
#pragma unroll
        for (int cb = 0; cb < TL::NCB; ++cb) {
          tma_load(ks + cb * TL::CB_BYTES, &kmap, full, cb * 64, kh, t0, b);
          tma_load(ks + TL::KV_BYTES + cb * TL::CB_BYTES, &vmap, full,
                   cb * 64, kh, t0, b);
        }
        if (++st == p.nst) {
          st = 0;
          ++use;
        }
      }
    }
    return;
  }
  // ---- the consumer warpgroups ------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");

  const int wg = tid / WG;
  const int tw = tid % WG;
  const int Rw = R0 + wg * WG_ROWS;        // the warpgroup's first row
  const bool active = Rw < p.rows;         // warpgroup-uniform
  const uint32_t qw = q_s + wg * TL::Q_BYTES;

  // stage the warpgroup's Q rows in the swizzled layout wgmma reads:
  // column block cb, row r, 16-byte chunk c at chunk c ^ (r % 8); all of a
  // thread's loads are issued before its stores
  if (active) {
    constexpr int CPR = DP / 8;            // 16-byte chunks per row
    constexpr int PER = WG_ROWS * CPR / WG;
    uint4 val[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int e = tw + k * WG, r = e / CPR, c = e % CPR;
      const int R = Rw + r;
      val[k] = make_uint4(0u, 0u, 0u, 0u);
      if (R < p.rows && c * 8 < p.D) {
        const long long s = R / p.gp, h = head0 + R % p.gp;
        val[k] = __ldg(reinterpret_cast<const uint4*>(
            p.q + ((b * static_cast<long long>(p.S) + s) * p.H + h) * p.D +
            c * 8));
      }
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int e = tw + k * WG, r = e / CPR, c = e % CPR;
      const uint32_t off = (c >> 3) * (WG_ROWS * ROW_BYTES) + r * ROW_BYTES +
                           (((c & 7) ^ (r & 7)) << 4);
      *reinterpret_cast<uint4*>(sbase + (qw - base) + off) = val[k];
    }
    // generic-proxy writes, read next by wgmma (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "r"(WG) : "memory");

  // this thread's rows of the accumulator fragments: ra and ra + 8 of the
  // warpgroup's 64; its columns in each 8-column chunk: q2 and q2 + 1
  const int Ra = Rw + 16 * (tw >> 5) + (lane >> 2);
  const int Rb = Ra + 8;
  const int q2 = 2 * (lane & 3);
  int qpa = Ra / p.gp, qpb = Rb / p.gp;          // grid mode: the row index
  if (!GRID) {
    qpa = Ra < p.rows ? p.qpos[qpa] : 0;
    qpb = Rb < p.rows ? p.qpos[qpb] : 0;
  }
  // computed once: keep the compiler from re-deriving them per element
  asm volatile("" : "+r"(qpa), "+r"(qpb));
  // the warpgroup's first and last query index (grid mode's mask test)
  const int ws_lo = Rw / p.gp;
  const int ws_hi = (min(Rw + WG_ROWS, p.rows) - 1) / p.gp;
  const bool causal = p.causal != 0;
  const int window = p.window > 0 ? p.window : 0x7fffffff;

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float ma = NEG, mb = NEG, la = 0.f, lb = 0.f;

  int st = 0, phase = 0;                   // this tile's stage and parity
  for (int i = 0; i < ntiles; ++i) {
    mbar_wait(full_s + 8 * st, phase);
    if (active) {
      const uint32_t ks = kv_s + st * 2 * TL::KV_BYTES;
      const uint32_t vs = ks + TL::KV_BYTES;
      const int t0 = t_begin + i * BK;

      // positions mode: load this tile's kv positions while S computes
      int kp_next = -1;
      if (!GRID && tw < BK && t0 + tw < p.T)
        kp_next = __ldg(p.kvpos + t0 + tw);

      // S = Q K^T: D/16 k-steps, 32 bytes along the swizzled rows each
      float sc[BK / 2];
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) sc[j] = 0.f;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t koff = (kk & 3) * 32;
        wgmma_ss(sc,
                 sw128_desc(qw + (kk >> 2) * (WG_ROWS * ROW_BYTES) + koff, 16,
                            ATOM_BYTES),
                 sw128_desc(ks + (kk >> 2) * TL::CB_BYTES + koff, 16,
                            ATOM_BYTES),
                 kk > 0);
      }
      wg_commit();
      wg_wait0();
      fence_regs(sc);
      // positions mode: the tile's kv positions, one slot a thread, through
      // shared memory (double-buffered by tile parity)
      int* kps = reinterpret_cast<int*>(sbase + (pos_s - base) +
                                        (wg * 2 + (i & 1)) * BK * 4);
      if (!GRID) {
        if (tw < BK) kps[tw] = kp_next;
        asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "r"(WG) : "memory");
      }

#pragma unroll
      for (int j = 0; j < BK / 2; ++j) sc[j] *= p.scale_log2;
      // masks, only where the tile can hold a masked slot for these rows:
      // predicates and selects, no branch per element
      bool masked = true;
      if (GRID)
        masked = t0 + BK > p.T || (causal && t0 + BK - 1 > ws_lo) ||
                 (p.window > 0 && ws_hi - t0 >= p.window);
      if (masked) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int t = t0 + 8 * j + q2 + c;
            const int kp = GRID ? t : kps[8 * j + q2 + c];
            const bool in = t < p.T;
            const bool ok = GRID || kp >= 0;
            const bool oka = ok & (!causal | (qpa >= kp)) &
                             (qpa - kp < window);
            const bool okb = ok & (!causal | (qpb >= kp)) &
                             (qpb - kp < window);
            float& xa = sc[4 * j + c];
            float& xb = sc[4 * j + 2 + c];
            xa = in ? (oka ? xa : NEG) : -CUDART_INF_F;
            xb = in ? (okb ? xb : NEG) : -CUDART_INF_F;
          }
        }
      }
      // online softmax: a row's values live in one quad of threads
      float mxa = sc[0], mxb = sc[2];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mxa = fmaxf(mxa, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mxb = fmaxf(mxb, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, 1));
      mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, 2));
      mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, 1));
      mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, 2));
      const float mna = fmaxf(ma, mxa), mnb = fmaxf(mb, mxb);
      const float ca = ex2(ma - mna), cb = ex2(mb - mnb);
      ma = mna;
      mb = mnb;
      float sa = 0.f, sb = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        sc[4 * j + 0] = ex2(sc[4 * j + 0] - mna);
        sc[4 * j + 1] = ex2(sc[4 * j + 1] - mna);
        sc[4 * j + 2] = ex2(sc[4 * j + 2] - mnb);
        sc[4 * j + 3] = ex2(sc[4 * j + 3] - mnb);
        sa += sc[4 * j + 0] + sc[4 * j + 1];
        sb += sc[4 * j + 2] + sc[4 * j + 3];
      }
      la = la * ca + sa;                     // the quad's partial row sums
      lb = lb * cb + sb;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        o[4 * j + 0] *= ca;
        o[4 * j + 1] *= ca;
        o[4 * j + 2] *= cb;
        o[4 * j + 3] *= cb;
      }
      // P in bf16: the S fragment of keys 16kk..16kk+15 is the A fragment
      // of k-step kk
      uint32_t pa[BK / 4];
#pragma unroll
      for (int j = 0; j < BK / 4; ++j)
        pa[j] = pack_bf16(sc[2 * j], sc[2 * j + 1]);

      // O += P V: BK/16 k-steps of 16 slots (two 8-row swizzle atoms each)
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                               pa[4 * kk + 3]};
        wgmma_rs(o, a,
                 sw128_desc(vs + kk * 2 * ATOM_BYTES, TL::CB_BYTES,
                            ATOM_BYTES));
      }
      wg_commit();
      wg_wait0();
      fence_regs(o);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_s + 8 * st);    // the stage is free
    if (++st == p.nst) {
      st = 0;
      phase ^= 1;
    }
  }

  if (!active) return;
  la += __shfl_xor_sync(0xffffffffu, la, 1);
  la += __shfl_xor_sync(0xffffffffu, la, 2);
  lb += __shfl_xor_sync(0xffffffffu, lb, 1);
  lb += __shfl_xor_sync(0xffffffffu, lb, 2);
  // with lse: a row that saw no valid key (its max still -1e30) is written
  // 0, and its log-sum-exp -inf, by its quad's first thread
  const bool none_a = p.lse != nullptr && ma < 0.5f * NEG;
  const bool none_b = p.lse != nullptr && mb < 0.5f * NEG;
  const float ia = none_a ? 0.f : 1.f / fmaxf(la, 1e-30f);
  const float ib = none_b ? 0.f : 1.f / fmaxf(lb, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int R = half ? Rb : Ra;
    if (R >= p.rows) continue;
    const float inv = half ? ib : ia;
    const long long s = R / p.gp, h = head0 + R % p.gp;
    if (p.lse != nullptr && q2 == 0) {
      const float m = half ? mb : ma, l = half ? lb : la;
      p.lse[(b * static_cast<long long>(p.S) + s) * p.H + h] =
          (half ? none_b : none_a) ? -CUDART_INF_F
                                   : m * LN2 + logf(fmaxf(l, 1e-30f));
    }
    const long long row = ((b * static_cast<long long>(p.S) + s) * p.H + h) *
                          p.D;
    if (p.out32 != nullptr) {              // f32: a merge rounds once
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + q2;
        if (col < p.D)
          *reinterpret_cast<float2*>(p.out32 + row + col) = make_float2(
              o[4 * j + 2 * half] * inv, o[4 * j + 2 * half + 1] * inv);
      }
      continue;
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + q2;
      if (col < p.D)
        *reinterpret_cast<uint32_t*>(p.out + row + col) = pack_bf16(
            o[4 * j + 2 * half] * inv, o[4 * j + 2 * half + 1] * inv);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// Error codes beyond cudaError_t's: no cuTensorMapEncodeTiled in the
// driver, or ENCODE_FAILED + its CUresult.
constexpr int NO_ENCODE = 1999;
constexpr int ENCODE_FAILED = 2000;

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &status) == cudaSuccess &&
        status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// k or v (B, T, K, D) bf16, as boxes of 64 columns x BK slots of one KV head
// in the 128-byte swizzle; columns past D and slots past T read as zeros.
int kv_map(CUtensorMap* map, const void* ptr, int B, int T, int K, int D,
           int BK) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return NO_ENCODE;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = 2ull * D;                 // bytes between KV heads
  const cuuint64_t strides[3] = {row, row * K, row * K * T};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(BK), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(ptr), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED + static_cast<int>(r);
}

template <int DP, bool GRID>
int launch(const void* q, const void* k, const void* v, const void* qpos,
           const void* kvpos, void* out, void* lse, int B, int S, int Tlen,
           int H, int K, int D, int causal, int window, float scale, int gp,
           int nwg, int nst, cudaStream_t st) {
  using TL = Tile<DP>;
  const int G = H / K;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(out);
  if ((gp != 1 && gp != G) || nwg < 1 || nwg > MAX_WG || nst < 1 ||
      nst > 2 || D % 16 != 0 || (addr & 15) != 0)
    return cudaErrorInvalidValue;
  CUtensorMap kmap, vmap;
  int err = kv_map(&kmap, k, B, Tlen, K, D, TL::BK);
  if (err == 0) err = kv_map(&vmap, v, B, Tlen, K, D, TL::BK);
  if (err != 0) return err;

  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.qpos = static_cast<const int*>(qpos);
  p.kvpos = static_cast<const int*>(kvpos);
  p.out = lse == nullptr ? static_cast<__nv_bfloat16*>(out) : nullptr;
  p.out32 = lse == nullptr ? nullptr : static_cast<float*>(out);
  p.lse = static_cast<float*>(lse);
  p.B = B; p.S = S; p.T = Tlen; p.H = H; p.D = D; p.G = G;
  p.gp = gp;
  p.rows = S * gp;
  p.n_rt = (p.rows + nwg * WG_ROWS - 1) / (nwg * WG_ROWS);
  p.n_hb = H / gp;
  p.causal = causal;
  p.window = window;
  p.scale_log2 = scale * LOG2E;
  p.nwg = nwg;
  p.nst = nst;
  const long long blocks = static_cast<long long>(p.n_rt) * p.n_hb * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;

  // alignment, Q, the ring, its barriers, positions mode's kv positions
  const int smem = 1024 + nwg * TL::Q_BYTES + nst * 2 * TL::KV_BYTES +
                   16 * nst + (GRID ? 0 : nwg * 2 * TL::BK * 4);
  static int smem_set = 0;                 // the attribute set so far
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_tc<DP, GRID>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  const int threads = (nwg + 1) * WG;          // + the producer warpgroup
  flash_tc<DP, GRID><<<static_cast<unsigned>(blocks), threads, smem, st>>>(
      kmap, vmap, p);
  return static_cast<int>(cudaGetLastError());
}

template <bool GRID>
int dispatch_d(const void* q, const void* k, const void* v, const void* qpos,
               const void* kvpos, void* out, void* lse, int B, int S,
               int Tlen, int H, int K, int D, int causal, int window,
               float scale, int gp, int nwg, int nst, cudaStream_t st) {
  if (D <= 64)
    return launch<64, GRID>(q, k, v, qpos, kvpos, out, lse, B, S, Tlen, H, K,
                            D, causal, window, scale, gp, nwg, nst, st);
  if (D <= 128)
    return launch<128, GRID>(q, k, v, qpos, kvpos, out, lse, B, S, Tlen, H,
                             K, D, causal, window, scale, gp, nwg, nst, st);
  return launch<256, GRID>(q, k, v, qpos, kvpos, out, lse, B, S, Tlen, H, K,
                           D, causal, window, scale, gp, nwg, nst, st);
}

}  // namespace tc

template <bool GRID>
int dispatch(const void* q, const void* k, const void* v, const void* qpos,
             const void* kvpos, void* out, void* lse, int B, int S, int Tlen,
             int H, int K, int D, int causal, int window, float scale,
             int dtype, int gp, int nwg, int nst, void* stream) {
  if (B < 1 || S < 1 || Tlen < 1 || K < 1 || H % K != 0 || D < 1 || D > 256)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (H > 65535 || B > 65535) return cudaErrorInvalidValue;
    return simt::dispatch_d<float, GRID>(q, k, v, qpos, kvpos, out, lse, B,
                                         S, Tlen, H, K, D, causal, window,
                                         scale, st);
  }
  if (dtype == 1)
    return tc::dispatch_d<GRID>(q, k, v, qpos, kvpos, out, lse, B, S, Tlen, H,
                                K, D, causal, window, scale, gp, nwg, nst,
                                st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, S, H, D); k, v (B, T, K, D) with H % K == 0; q_positions (S,) and
// kv_positions (T,) int32; out (B, S, H, D) in q's type: f32 (dtype 0) or
// bf16 (dtype 1); lse (B, S, H) f32 or null: each row's log-sum-exp over
// its valid keys (-inf, and the row's out 0, where it has none), for a
// merge over the slots other ranks hold; with lse, out is f32 in either
// type (not rounded before the merge).  window <= 0 means no window.
// gp, nwg, nst are the wrapper's launch plan for the bf16 body (query heads
// per row group, G or 1; consumer warpgroups per block; ring stages); the
// f32 body ignores them.  Returns cudaGetLastError(), or 1999 / 2000 +
// CUresult when the K/V tensor map cannot be made.
extern "C" int flash_attention_positions(const void* q, const void* k,
                                         const void* v, const void* qpos,
                                         const void* kvpos, void* out,
                                         void* lse, int B, int S, int Tlen,
                                         int H, int K, int D, int causal,
                                         int window, float scale, int dtype,
                                         int gp, int nwg, int nst,
                                         void* stream) {
  return dispatch<false>(q, k, v, qpos, kvpos, out, lse, B, S, Tlen, H, K, D,
                         causal, window, scale, dtype, gp, nwg, nst, stream);
}

// The same operands without positions: query row i and key column j count
// from 0 (causal: i >= j; window: i - j < window).  Returns as above.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int S, int Tlen, int H, int K,
                               int D, int causal, int window, float scale,
                               int dtype, int gp, int nwg, int nst,
                               void* stream) {
  return dispatch<true>(q, k, v, nullptr, nullptr, out, nullptr, B, S, Tlen,
                        H, K, D, causal, window, scale, dtype, gp, nwg, nst,
                        stream);
}
