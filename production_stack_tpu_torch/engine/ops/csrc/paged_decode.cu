// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_decode_attention_pallas` (body
// `_decode_kernel`) in production_stack_tpu/engine/ops/pallas/paged_attention.py:
// for each row s, softmax(q . K^T * scale) . V over the first ctx_lens[s]
// tokens of the paged cache [N, bs, K, D], blocks taken from
// block_tables[s], query head h reading KV head h / G, with an optional
// sliding window (keep pos > ctx - 1 - window).  Rows with ctx == 0 give
// exact zeros.  Scores, the running max and sum and the accumulator are
// fp32; the output is written in q's type.
//
// What bounds it on an H100: bytes.  Each row must read every live KV
// block once (2 * ctx * K * D elements); the arithmetic is ~2 * G
// operations per byte, far under the ~295 the card needs to be bound by
// its tensor cores, so the products stay on the CUDA cores.
//
// What the design does about it (split-KV):
//  * Grid (row, KV head, split).  Each block serves all G query heads of
//    its KV head, so each KV block is read once per KV head.  The grid's
//    n_split comes from the host (`split_count` in
//    kernels/paged_attention.py: enough blocks for ~8 per SM, at most 64)
//    and the launch never waits on a device value.  Each row then sizes
//    its own splits on the device from ctx: n_row = ceil((ctx - lo) /
//    split_tokens) splits, at most n_split, so a short row takes one
//    block and a 32000-token row all of them; its live range [lo, ctx) is
//    cut into n_row chunks of ceil((ctx - lo) / n_row) tokens, rounded up
//    to whole warp tiles (decode_split in common.cuh, shared with the
//    int8 kernel).  Blocks past n_row leave at once.  On one H100
//    (700 W) split_tokens = 128 was as fast as or faster than 64, 256 and
//    512 at 8 rows of up to 4000 tokens, one of 3001 and one of 32000.
//  * Inside a block each of the 4 warps owns its own tiles of TT tokens
//    (~2 KB of K and 2 KB of V; TT = 8 at D = 128 bf16) and its own
//    online-softmax state: tiles w, w + 4, ... of the split.  A warp
//    loads its tiles by cp.async into its own 2-stage ring, the next tile
//    in flight while the current one is scored, and synchronises only
//    itself (__syncwarp); the block's barriers come once, at the end,
//    where the 4 warps' (max, sum, accumulator) merge in shared memory.
//  * Reduce (decode_merge in common.cuh, shared with the int8 kernel):
//    the last split of a (row, KV head) to finish merges the splits.
//    Each split writes its fp32 partial (m, l, acc[G * D]) to scratch
//    from the wrapper, then bumps a per-(row, KV head) counter; the block
//    that takes the counter to n_row merges all partials by log-sum-exp
//    and sets the counter back to 0 for the next call (the wrapper keeps
//    the zeroed counters across calls).  This rather than a second
//    kernel: a decode step launches this kernel once per layer, and a
//    reduce kernel would add as many launches again, each costing host
//    time on a step that is partly host-bound.  A row with n_row == 1
//    writes its output directly.
//  * Scores are kept in log2 units (q is pre-scaled by scale * log2(e)),
//    so the softmax uses exp2f.  A split or warp that saw no token carries
//    m = -inf and l = 0 and weighs 0 in the merge.
#include "common.cuh"

namespace {

constexpr int kWarps = kDecodeWarps;
constexpr int kThreads = kDecodeThreads;
constexpr int kMaxG = kDecodeMaxG;  // query heads per KV head
constexpr int kStages = 2;          // tiles in each warp's ring
constexpr unsigned kFull = 0xffffffffu;

template <typename T, int D>
struct DecodeShape {
  static constexpr int ESZ = sizeof(T);
  // Tokens per warp tile: ~2 KB of K (and of V) per tile.
  static constexpr int TT = 2048 / (D * ESZ) < 16 ? 2048 / (D * ESZ) : 16;
  static constexpr int PARTS = 32 / TT;        // lanes per token in the score pass
  static constexpr int PER_PART = D / PARTS;   // elements of a row per lane
  // q is stored [G][PARTS][QP]: padding each part by 16 bytes puts the
  // parts' reads of one instruction in different bank groups.
  static constexpr int QP = PER_PART + 4;
  static constexpr int V = Vec<T>::N;          // elements per 16-byte chunk
  static constexpr int CH = D / V;             // 16-byte chunks per row
  static constexpr int ROW = D + V;            // row padded by 16 bytes
  static constexpr int VC = D / 32;            // output columns per lane
  static constexpr int TILE = TT * ROW;        // elements of one K (or V) tile
  static constexpr int LOADS = TT * CH / 32;   // 16-byte copies per lane per side
  static constexpr size_t STAGING = sizeof(T) * kWarps * kStages * 2 * TILE;
  // The merge (decode_merge, common.cuh) reuses the tiles' shared memory.
  static constexpr size_t MERGE = DecodeMergeSmem<D>::BYTES;
  static constexpr size_t SMEM_TILES = STAGING > MERGE ? STAGING : MERGE;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q,        // [S, H, D]
                    const T* __restrict__ k_cache,  // [N, bs, K, D]
                    const T* __restrict__ v_cache,
                    const int* __restrict__ block_tables,  // [S, bmax]
                    const int* __restrict__ ctx_lens,      // [S]
                    T* __restrict__ out,                   // [S, H, D]
                    float* __restrict__ part_ml,   // [S, K, n_split, G, 2]
                    float* __restrict__ part_acc,  // [S, K, n_split, G, D]
                    int* __restrict__ counters,    // [S * K], 0 between calls
                    int H, int K, int G, int bs, int bmax, int n_split,
                    int split_tokens, float scale_log2, int window) {
  using Sh = DecodeShape<T, D>;
  constexpr int TT = Sh::TT;
  constexpr int ROW = Sh::ROW;
  constexpr int VC = Sh::VC;

  __shared__ __align__(16) float sQ[kMaxG * Sh::PARTS * Sh::QP];  // q * scale * log2(e)
  __shared__ __align__(16) unsigned char sTiles[Sh::SMEM_TILES];

  const int s = blockIdx.x, kh = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ctx = ctx_lens[s];
  const int* table = block_tables + static_cast<size_t>(s) * bmax;

  // This row's splits, and this split's tokens [beg, end).
  const DecodeSplit sp = decode_split(ctx, window, n_split, split_tokens, split, TT);
  if (split >= sp.n_row) return;
  const int beg = sp.beg, end = sp.end;
  const int ntile = (end - beg + TT - 1) / TT;
  const int nmine = ntile > warp ? (ntile - warp - 1) / kWarps + 1 : 0;

  T* ring = reinterpret_cast<T*>(sTiles) + warp * kStages * 2 * Sh::TILE;
  auto load = [&](int i, int stage) {  // this warp's i-th tile
    const int p0 = beg + (warp + i * kWarps) * TT;
    long long base = 0;  // element offset of token p0 + lane's K/V row
    int ok = 0;
    if (lane < TT && p0 + lane < end) {
      const int p = p0 + lane;
      ok = 1;
      base = ((static_cast<long long>(table[p / bs]) * bs + p % bs) * K + kh) * D;
    }
    T* dk = ring + stage * 2 * Sh::TILE;
    T* dv = dk + Sh::TILE;
#pragma unroll
    for (int c = 0; c < Sh::LOADS; ++c) {
      const int chunk_id = lane + 32 * c;
      const int t = chunk_id / Sh::CH, ch = chunk_id % Sh::CH;
      const long long b = __shfl_sync(kFull, base, t);
      const bool v = __shfl_sync(kFull, ok, t);
      const long long off = v ? b + ch * Sh::V : 0;
      cp_async16(dk + t * ROW + ch * Sh::V, k_cache + off, v);
      cp_async16(dv + t * ROW + ch * Sh::V, v_cache + off, v);
    }
  };
  if (nmine > 0) load(0, 0);
  cp_async_commit();

  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    sQ[(g * Sh::PARTS + d / Sh::PER_PART) * Sh::QP + d % Sh::PER_PART] =
        to_float(q[(static_cast<size_t>(s) * H + kh * G + g) * D + d]) * scale_log2;
  }
  __syncthreads();

  // Per-warp online softmax; every lane holds the same m and l, and
  // output columns lane * VC .. lane * VC + VC - 1 of each head.
  float m[kMaxG], l[kMaxG], acc[kMaxG][VC];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VC; ++e) acc[g][e] = 0.f;
  }

  const int tok = lane % TT, part = lane / TT;
  for (int i = 0; i < nmine; ++i) {
    const int stage = i % kStages;
    if (i + 1 < nmine) load(i + 1, (i + 1) % kStages);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    const T* tk = ring + stage * 2 * Sh::TILE;
    const T* tv = tk + Sh::TILE;
    const int p0 = beg + (warp + i * kWarps) * TT;

    // Scores: lane (tok, part) dots its part of token tok's row with every
    // head; the parts are summed across lanes.
    float sc[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) sc[g] = 0.f;
    const T* krow = tk + tok * ROW + part * Sh::PER_PART;
#pragma unroll
    for (int c = 0; c < Sh::PER_PART / Sh::V; ++c) {
      float kf[Sh::V];
      load_vec(krow + c * Sh::V, kf);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float4* qg = reinterpret_cast<const float4*>(
              sQ + (g * Sh::PARTS + part) * Sh::QP + c * Sh::V);
#pragma unroll
          for (int e4 = 0; e4 < Sh::V / 4; ++e4) {
            const float4 qv = qg[e4];
            sc[g] = fmaf(qv.x, kf[4 * e4], sc[g]);
            sc[g] = fmaf(qv.y, kf[4 * e4 + 1], sc[g]);
            sc[g] = fmaf(qv.z, kf[4 * e4 + 2], sc[g]);
            sc[g] = fmaf(qv.w, kf[4 * e4 + 3], sc[g]);
          }
        }
      }
    }
    const bool live = p0 + tok < end;
    float p[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) continue;
#pragma unroll
      for (int o = TT; o < 32; o <<= 1) sc[g] += __shfl_xor_sync(kFull, sc[g], o);
      const float x = live ? sc[g] : -INFINITY;
      float mt = x;
#pragma unroll
      for (int o = 1; o < TT; o <<= 1) mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, o));
      const float m_new = fmaxf(m[g], mt);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[g] - m_use);
      p[g] = exp2f(x - m_use);
      float sum = p[g];
#pragma unroll
      for (int o = 1; o < TT; o <<= 1) sum += __shfl_xor_sync(kFull, sum, o);
      l[g] = l[g] * alpha + sum;
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < VC; ++e) acc[g][e] *= alpha;
    }

    // acc[g, :] += sum_t p[g, t] * V[t, :]; p[g, t] comes from lane t.
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      float vf[VC];
      load_cols<T, VC>(tv + t * ROW + lane * VC, vf);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float pg = __shfl_sync(kFull, p[g], t);
#pragma unroll
          for (int e = 0; e < VC; ++e) acc[g][e] = fmaf(pg, vf[e], acc[g][e]);
        }
      }
    }
    __syncwarp();  // the stage is consumed before this warp reloads it
  }
  cp_async_wait<0>();
  decode_merge<T, D>(m, l, acc, reinterpret_cast<float*>(sTiles), out, part_ml,
                     part_acc, counters, s, kh, split, sp.n_row, n_split, H, K, G);
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const int* tables, const int* ctx, void* out,
                         float* part_ml, float* part_acc, int* counters, int S,
                         int H, int K, int D, int bs, int bmax, int n_split,
                         int split_tokens, float scale, int window,
                         cudaStream_t stream) {
  const dim3 grid(S, K, n_split);
  const int G = H / K;
#define PSTT_DECODE_CASE(DIM)                                                  \
  case DIM:                                                                    \
    paged_decode_kernel<T, DIM><<<grid, kThreads, 0, stream>>>(                \
        static_cast<const T*>(q), static_cast<const T*>(k),                    \
        static_cast<const T*>(v), tables, ctx, static_cast<T*>(out), part_ml,  \
        part_acc, counters, H, K, G, bs, bmax, n_split, split_tokens,          \
        scale * kLog2e, window);                                               \
    break;
  switch (D) {
    PSTT_DECODE_CASE(64)
    PSTT_DECODE_CASE(128)
    PSTT_DECODE_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef PSTT_DECODE_CASE
  return cudaGetLastError();
}

}  // namespace

// C entry point bound with ctypes.  Every tensor is contiguous; dtype is a
// DType code; window < 0 means no sliding window.  n_split is the most
// splits a row may take, split_tokens the fewest tokens a split is given.
// With n_split > 1, part_ml / part_acc are fp32 scratch of
// S * K * n_split * G * 2 and * G * D floats and counters S * K int32
// zeros, left zero again by the kernel; with n_split == 1 all three may be
// null.  Returns the launch's cudaError_t (0 on success).
extern "C" int paged_decode_launch(const void* q, const void* k_cache,
                                   const void* v_cache, const void* block_tables,
                                   const void* ctx_lens, void* out, void* part_ml,
                                   void* part_acc, void* counters, int S, int H,
                                   int K, int D, int bs, int bmax, int dtype,
                                   int n_split, int split_tokens, float scale,
                                   int window, void* stream) {
  if (S == 0) return 0;
  if (K <= 0 || H % K != 0 || H / K > kMaxG) return cudaErrorInvalidValue;
  if (n_split < 1 || n_split > kMaxSplit || split_tokens < 1 ||
      (n_split > 1 && (!part_ml || !part_acc || !counters)))
    return cudaErrorInvalidValue;
  const int* tables = static_cast<const int*>(block_tables);
  const int* ctx = static_cast<const int*>(ctx_lens);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return launch_typed<bf16_raw>(q, k_cache, v_cache, tables, ctx, out, ml, acc,
                                  cnt, S, H, K, D, bs, bmax, n_split,
                                  split_tokens, scale, window, st);
  if (dtype == kFloat32)
    return launch_typed<float>(q, k_cache, v_cache, tables, ctx, out, ml, acc, cnt,
                               S, H, K, D, bs, bmax, n_split, split_tokens, scale,
                               window, st);
  return cudaErrorInvalidValue;
}
